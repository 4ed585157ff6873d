"""CTC loss with the reference's reduction semantics, lengths on the device
(port of `avsync/ops/ctc.py`).

The reference trains with `nn.CTCLoss(blank=0, reduction='mean',
zero_infinity=True)` on (T, B, V) log-softmax outputs (`trainer.py:24,53-61`):
each sequence's negative log-likelihood is divided by its target length,
then averaged over the batch; sequences with no valid alignment give 0.

The JAX package builds that on optax's CTC: a forward recursion over T in
log space, with log(0) approximated by `LOG_EPSILON`, and its gradient is
`jax.grad` through the recursion. Here the same lattice (blank, label 1,
blank, label 2, ..., blank; a skip over a blank unless the label repeats)
runs in plain torch ops: the forward (alpha) recursion in `forward` and the
backward (beta) recursion in `backward` of one autograd Function, whose
gradient is the posterior occupancy of each class at each frame, the exact
derivative of the same function. That is 4 small ops per frame each way,
against the ~40 of autograd through the recursion; the recursion itself
runs with autograd off.

Every length stays a device tensor and nothing reads a value back to the
host, so a step that calls this can be captured in a CUDA graph and
replayed on other batches (the tensor-length form of `F.ctc_loss` copies
the lengths to the host, which capture refuses, and its list form would
bake one batch's lengths into the graph). Every product is a one-hot
matmul: no sum with atomics, so repeated runs give the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

LOG_EPSILON = -1e5  # optax's stand-in for log(0)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot rows by comparison (`F.one_hot` may read its input back to
    check the class range)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x moved k states along dim 1 (right for k > 0, left for k < 0), the
    vacated states LOG_EPSILON."""
    pad = x.new_full((x.shape[0], abs(k)), LOG_EPSILON)
    return torch.cat([pad, x[:, :-k]], dim=1) if k > 0 else torch.cat([x[:, -k:], pad], dim=1)


class _CTCLattice(torch.autograd.Function):
    """-log p(labels | lp) per sequence over the extended lattice of S = 2L+1
    states; lp (B, T, V) log-probabilities. The backward returns the
    gradient with respect to lp only.

    Each recursion writes frame t into a (T, B, S + 2) buffer whose two
    spare columns hold LOG_EPSILON, so the states one and two back (or
    ahead) are views, and every op writes into preallocated memory: four
    small kernels per frame each way."""

    @staticmethod
    def forward(ctx, lp, one_hot, skip, first, last, has_labels, live):
        # one_hot (B, S, V) of each state's class; skip (B, S) 0 where a state
        # may be entered from two states back, else LOG_EPSILON; first / last
        # (B, S) 0 on the states a path may start / end in, else LOG_EPSILON;
        # live (T, B, 1) bool of the valid frames (None: all)
        B, T, _ = lp.shape
        S = one_hot.shape[1]
        lpe = torch.bmm(lp, one_hot.transpose(1, 2)).transpose(0, 1).contiguous()  # (T, B, S)
        buf = lpe.new_full((T, B, S + 2), LOG_EPSILON)  # columns 2.. hold alpha
        torch.add(lpe[0], first, out=buf[0, :, 2:])
        stay, hop = lpe.new_empty(B, S), lpe.new_empty(B, S)
        for t in range(1, T):
            prev, cur = buf[t - 1], buf[t, :, 2:]
            torch.logaddexp(prev[:, 2:], prev[:, 1:-1], out=stay)
            torch.add(prev[:, :-2], skip, out=hop)
            torch.logaddexp(stay, hop, out=stay)
            torch.add(stay, lpe[t], out=cur)
            if live is not None:
                torch.where(live[t], cur, prev[:, 2:], out=cur)
        alpha = buf[T - 1, :, 2:]
        ends = alpha + last
        top = ends.amax(dim=1, keepdim=True)
        logp = (top + (ends - top).exp().sum(dim=1, keepdim=True).log()).squeeze(1)
        logp = torch.where(has_labels, logp, alpha[:, 0])
        ctx.save_for_backward(lpe, buf, logp, one_hot, skip, last,
                              live if live is not None else lpe.new_empty(0))
        ctx.has_live = live is not None
        return -logp

    @staticmethod
    def backward(ctx, g):
        lpe, alpha_buf, logp, one_hot, skip, last, live = ctx.saved_tensors
        T, B, S = lpe.shape
        skip_in = _shift(skip, -2)  # entering state s + 2 from s
        buf = lpe.new_full((T, B, S + 2), LOG_EPSILON)  # columns ..S-1 hold beta
        torch.add(lpe[T - 1], last, out=buf[T - 1, :, :S])
        if ctx.has_live:
            dead = ~live
            buf[T - 1, :, :S].masked_fill_(dead[T - 1], LOG_EPSILON)
        stay, hop = lpe.new_empty(B, S), lpe.new_empty(B, S)
        for t in range(T - 2, -1, -1):
            nxt, cur = buf[t + 1], buf[t, :, :S]
            torch.logaddexp(nxt[:, :S], nxt[:, 1:S + 1], out=stay)
            torch.add(nxt[:, 2:], skip_in, out=hop)
            torch.logaddexp(stay, hop, out=stay)
            torch.add(stay, lpe[t], out=cur)
            if ctx.has_live:
                # a sequence's last valid frame starts its recursion; later
                # frames take no part
                torch.where(live[t + 1], cur, lpe[t] + last, out=cur)
                cur.masked_fill_(dead[t], LOG_EPSILON)
        # occupancy of each state, at most 1 (a clamp that only matters for a
        # sequence with no alignment, whose loss is masked out)
        occ = (buf[:, :, :S] + alpha_buf[:, :, 2:] - lpe - logp[None, :, None])
        occ = occ.clamp(max=0.0).exp()
        grad = torch.bmm(occ.transpose(0, 1), one_hot)  # (B, T, V)
        return -g[:, None, None] * grad, None, None, None, None, None, None


def ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor, label_lengths: torch.Tensor,
            input_lengths: Optional[torch.Tensor] = None, blank_id: int = 0) -> torch.Tensor:
    """Per-sequence negative log-likelihood (B,), optax's `ctc_loss`:
    log_probs (B, T, V) (log-softmaxed again, as optax does: idempotent up to
    rounding), labels (B, L) right-padded, label_lengths (B,), input_lengths
    (B,) valid frames (None: all T)."""
    B, T, V = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    lp = torch.log_softmax(log_probs, dim=-1)
    labels = labels.to(device=dev, dtype=torch.int64)
    lens = label_lengths.to(device=dev, dtype=torch.int64).clamp(0, L)
    S = 2 * L + 1
    state = torch.arange(S, device=dev)
    ext = torch.full((B, S), blank_id, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    dtype = lp.dtype
    # a label state may be entered from two states back unless it repeats
    # the label before it
    can_skip = (state >= 3) & (state % 2 == 1)
    can_skip = can_skip[None, :] & torch.cat(
        [torch.zeros(B, 3, dtype=torch.bool, device=dev), ext[:, 3:] != ext[:, 1:-2]], dim=1)
    skip = torch.where(can_skip, 0.0, LOG_EPSILON).to(dtype)
    first = torch.where(state < 2, 0.0, LOG_EPSILON).to(dtype)[None, :].expand(B, S)
    final = (state[None, :] == 2 * lens[:, None]) | (state[None, :] == 2 * lens[:, None] - 1)
    last = torch.where(final, 0.0, LOG_EPSILON).to(dtype)
    live = None
    if input_lengths is not None:
        frames = input_lengths.to(device=dev, dtype=torch.int64)
        live = (torch.arange(T, device=dev)[:, None] < frames[None, :])[..., None]
    return _CTCLattice.apply(lp, _one_hot(ext, V, dtype), skip, first.contiguous(), last,
                             lens > 0, live)


def ctc_loss_mean(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor,
                  input_lengths: Optional[torch.Tensor] = None,
                  blank_id: int = 0) -> torch.Tensor:
    """Mean CTC loss: log_probs (B, T, V), labels (B, L) 0-padded, label
    lengths (B,), input lengths (B,) defaulting to T, all on log_probs'
    device. torch's 'mean' (each sequence over its target length, floored
    at 1, then the batch mean) and `zero_infinity` (a sequence with no
    valid alignment, i.e. fewer frames than labels plus repeated pairs,
    gives 0, as does a non-finite one). Returns a scalar."""
    B, T, _ = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    labels = labels.to(device=dev, dtype=torch.int64)
    lens = label_lengths.to(device=dev, dtype=torch.int64)
    per_seq = ctc_nll(log_probs, labels, lens, input_lengths, blank_id)
    per_seq = per_seq / lens.clamp(min=1).to(per_seq.dtype)
    frames = (torch.full((B,), T, device=dev, dtype=torch.int64) if input_lengths is None
              else input_lengths.to(device=dev, dtype=torch.int64))
    in_label = torch.arange(1, L, device=dev)[None, :] < lens[:, None]
    dups = ((labels[:, 1:] == labels[:, :-1]) & in_label).sum(dim=1)
    feasible = frames >= lens + dups
    return torch.where(feasible & torch.isfinite(per_seq), per_seq, 0.0).mean()


def optax_ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Per-sequence negative log-likelihood (B,) through optax's own
    recursion (`optax.ctc_loss`: blank states phi (B, L+1) and label states
    emit (B, L), an in-frame emit -> phi transition, LOG_EPSILON stand-ins),
    differentiated by autograd. Where a sequence has an alignment this is
    `ctc_nll`'s value; where it has none, the two differ by O(1) in a loss
    of ~1e5 and in their gradients (their stand-in paths differ), so a loss
    that keeps such sequences, the TF family's, runs this one to stay the
    JAX package's function. Every input frame is valid; nothing is read
    back to the host."""
    B, T, V = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    lp = torch.log_softmax(log_probs, dim=-1)
    labels = labels.to(device=dev, dtype=torch.int64)
    lens = label_lengths.to(device=dev, dtype=torch.int64)
    repeat = torch.cat([(labels[:, :-1] == labels[:, 1:]).to(lp.dtype),
                        lp.new_zeros(B, 1)], dim=1)
    eps_repeat, eps_distinct = LOG_EPSILON * repeat, LOG_EPSILON * (1.0 - repeat)
    lp_blank = lp[:, :, blank_id:blank_id + 1].transpose(0, 1)  # (T, B, 1)
    lp_emit = torch.bmm(lp, _one_hot(labels, V, lp.dtype).transpose(1, 2)).transpose(0, 1)

    def to_blank(phi, score):  # phi[:, 1:] (+)= score in log space
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=1)

    phi = torch.cat([lp.new_zeros(B, 1), lp.new_full((B, L), LOG_EPSILON)], dim=1)
    emit = lp.new_full((B, L), LOG_EPSILON)
    for t in range(T):
        prev_phi = to_blank(phi, emit + eps_repeat)  # emit -> phi, not into a repeat
        nxt = torch.logaddexp(prev_phi[:, :-1] + lp_emit[t], emit + lp_emit[t])
        phi = to_blank(prev_phi + lp_blank[t], emit + lp_blank[t] + eps_distinct)
        emit = nxt
    last = to_blank(phi, emit)
    return -(last * _one_hot(lens, L + 1, lp.dtype)).sum(dim=1)
