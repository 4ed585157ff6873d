"""Context (sequence) parallelism: the time axis split over ranks (port of
`avsync/parallel/context.py`).

`cp_gru_recurrence`: rank k of the group holds the k-th of n equal T/n
chunks of the precomputed input projections gi. It receives the carried
hidden state from rank k-1 (rank 0 starts from zeros), runs its chunk
through the GRU recurrence from that state (K2 with `h0` on the card, the
plain step loop on the CPU), and sends its last state to rank k+1. The
chain is sequential across chunks, so this scales memory (each rank holds
1/n of the activations), not latency, as the JAX function's `ppermute`
rounds. A step's arithmetic does not depend on where the chain starts, so
the chunks' outputs are the whole recurrence's.

Forward only, as the JAX package's tests use it. Not ported: its backward
(K3 from a carried dh) and the T-sharded conv3d, whose one-frame halo XLA
exchanges by itself (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from avsync_torch.ops.cuda.gru import gru_recurrence
from avsync_torch.parallel import multihost


def cp_gru_recurrence(group, gi_local: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of the recurrence: gi_local (B, T/n, 3H), w_hh
    (H, 3H) and b_hh (3H,) in the JAX layout -> (B, T/n, H). `group`: the
    ranks of the chain in time order (None: the world)."""
    n = dist.get_world_size(group)
    k = dist.get_rank(group)
    B, _, threeH = gi_local.shape
    h0 = None
    if k > 0:
        h0 = gi_local.new_empty(B, threeH // 3)
        multihost.recv(h0, dist.get_global_rank(group, k - 1) if group is not None else k - 1)
    out = gru_recurrence(gi_local, w_hh, b_hh, h0=h0)
    if k + 1 < n:
        multihost.send(out[:, -1], dist.get_global_rank(group, k + 1)
                       if group is not None else k + 1)
    return out
