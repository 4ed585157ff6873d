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

The backward (`jax.grad` of the JAX function's scan under `shard_map`) runs
the chain in reverse rank order: rank k receives the gradient of its last
state from rank k+1 (the last rank has none) and adds it to the cotangent
of its last step, runs K3 over its chunk from its own initial state, and
sends the gradient of that state (K3's `dh0`) to rank k-1. w_hh and b_hh
are the same on every rank, so their gradients are the sum of the ranks'
partial ones: an all-reduce over the group, after which every rank holds
the whole gradient, as `jax.grad` of the replicated weights gives it. Each
rank posts its receive before it computes, in the order of the chain, so
ranks may reach `backward()` at different times.

Not ported: the T-sharded conv3d, whose one-frame halo XLA exchanges by
itself (the JAX package has no module for it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from avsync_torch.ops.cuda.gru import gru_recurrence, gru_recurrence_bwd
from avsync_torch.parallel import multihost


def _peer(group, k: int) -> int:
    """The global rank of rank k of `group` (the world when None)."""
    return dist.get_global_rank(group, k) if group is not None else k


class _Chain(torch.autograd.Function):
    """This rank's chunk of the chain: forward K2 from the received state,
    backward K3 from it with the received state gradient."""

    @staticmethod
    def forward(ctx, gi_local, w_hh, b_hh, group):
        n, k = dist.get_world_size(group), dist.get_rank(group)
        B, _, threeH = gi_local.shape
        h0 = None
        if k > 0:
            h0 = gi_local.new_empty(B, threeH // 3)
            multihost.recv(h0, _peer(group, k - 1))
        out = gru_recurrence(gi_local, w_hh, b_hh, h0=h0)
        if k + 1 < n:
            multihost.send(out[:, -1], _peer(group, k + 1))
        ctx.group = group
        ctx.save_for_backward(gi_local, out, w_hh, b_hh, *(() if h0 is None else (h0,)))
        return out

    @staticmethod
    def backward(ctx, g):
        gi, out, w_hh, b_hh, *h0 = ctx.saved_tensors
        group = ctx.group
        n, k = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous()
        if k + 1 < n:
            dh = g.new_empty(g.shape[0], g.shape[2])
            multihost.recv(dh, _peer(group, k + 1))
            g = g.clone()
            g[:, -1] += dh
        res = gru_recurrence_bwd(gi, out, g, w_hh, b_hh, h0=h0[0] if h0 else None)
        if k > 0:
            multihost.send(res[3], _peer(group, k - 1))
        dgi, dw, db = res[:3]
        dw = dw.contiguous()
        multihost.all_reduce(dw, group=group)
        multihost.all_reduce(db, group=group)
        return dgi, dw, db, None


def cp_gru_recurrence(group, gi_local: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of the recurrence: gi_local (B, T/n, 3H), w_hh
    (H, 3H) and b_hh (3H,) in the JAX layout -> (B, T/n, H), differentiable
    in all three (the backward above). `group`: the ranks of the chain in
    time order (None: the world)."""
    return _Chain.apply(gi_local, w_hh, b_hh, group)
