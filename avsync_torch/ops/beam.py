"""CTC prefix beam-search decoding (port of `avsync/ops/beam.py`).

The reference decodes greedily only (`utils.py:8-36`); beam search is an
opt-in decode (`text.decode_batch(..., beam_width=N)` and `--beam` on the
`test` and `infer` commands). Standard prefix beam search (Hannun et al.):
per-prefix blank / non-blank log-probabilities, every symbol tried at each
frame, duplicate prefixes merged, the best `beam_width` kept. Host-side
numpy, as in the JAX package: the T=75 x V=39 search runs once per decode,
outside the device path.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

NEG_INF = -np.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def ctc_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank_id: int = 0,
    valid_ids: Sequence[int] | None = None,
) -> Tuple[Tuple[int, ...], float]:
    """Decode one (T, V) log-probability matrix.

    Returns (best prefix as symbol ids, its log-probability). `valid_ids`
    restricts the expansion alphabet (e.g. exclude the <pad> symbol the
    GRID vocab reserves but never emits in labels).
    """
    T, V = log_probs.shape
    symbols = list(valid_ids) if valid_ids is not None else [
        v for v in range(V) if v != blank_id
    ]

    # beams: prefix -> (log P ending in blank, log P ending in non-blank)
    beams = {(): (0.0, NEG_INF)}
    for t in range(T):
        lp = log_probs[t]
        new: dict = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (NEG_INF, NEG_INF))
            new[prefix] = (_logsumexp2(opb, pb), _logsumexp2(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = _logsumexp2(pb, pnb)
            # blank keeps the prefix
            add(prefix, total + lp[blank_id], NEG_INF)
            last = prefix[-1] if prefix else None
            for s in symbols:
                p_s = lp[s]
                if s == last:
                    # repeat symbol: only extends from the blank path;
                    # the non-blank path collapses into the same prefix
                    add(prefix, NEG_INF, pnb + p_s)
                    add(prefix + (s,), NEG_INF, pb + p_s)
                else:
                    add(prefix + (s,), NEG_INF, total + p_s)

        beams = dict(
            sorted(
                new.items(),
                key=lambda kv: _logsumexp2(*kv[1]),
                reverse=True,
            )[:beam_width]
        )

    best, (pb, pnb) = max(
        beams.items(), key=lambda kv: _logsumexp2(*kv[1])
    )
    return best, _logsumexp2(pb, pnb)


def ctc_beam_search_batch(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank_id: int = 0,
    valid_ids: Sequence[int] | None = None,
) -> List[Tuple[int, ...]]:
    """(B, T, V) -> list of best prefixes."""
    return [
        ctc_beam_search(np.asarray(log_probs[b]), beam_width, blank_id, valid_ids)[0]
        for b in range(log_probs.shape[0])
    ]
