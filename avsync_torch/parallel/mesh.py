"""The rank mesh and the tensor-parallel sharding rules (port of
`avsync/parallel/mesh.py`).

A mesh lays the ranks of the current process group out as ('data',
'model') or, hierarchically, ('slice', 'data', 'model'), rank-major in that
order as the JAX package reshapes its device list. The batch's rows split
over 'data' ('slice' and 'data' jointly: the data index); tensor-parallel
leaves split their rows over 'model'. A rank holds two process groups of
its own: its data group (the ranks of its model index, over which the
gradient is all-reduced) and its model group (the ranks of its data index,
over which shards are gathered).

`lipnet_param_spec` is the JAX rule in torch layout: the JAX (D, 3H) /
(H, 3H) kernels' gate COLUMNS are torch's `weight_ih` / `weight_hh` ROWS, so
GRU and LSTM weights and biases shard on dim 0 (a contiguous block of gate
rows per model rank); the head ('fc' of the PyTorch family, 'head' of the TF
family, (V, 2H) / (V, 512)) shards its rows only when V divides by the model
size (39 stays replicated; the TF family's 32 shards at m = 2 and 4); the
convolutions and the TF family's dense layers replicate. The JAX rule names
only 'fc', so its TF head stays replicated there.

Tensor parallelism in the forward (`ShardGather`, `ModelInput`): a layer
with row shards computes its slice of the gates (the input projection,
`F.linear` on its rows of `weight_ih`), then gathers the slices, `w_hh` and
`b_hh` over the model group into the whole tensors that the recurrence (K2,
or the plain loop) takes. Everything after the gather is the same
computation on every model rank, so each already holds the whole gradient
of a gathered tensor and the gather's backward is a slice of it. The
layer's input, replicated, gets only its slice's share of the gradient
through the slice of `weight_ih`, so the input's backward all-reduces over
the model group (the input of a column-parallel layer).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from avsync_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"


class Mesh:
    """A mesh of the process group's ranks (or of this one process)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.size = math.prod(shape)
        world = multihost.world_size()
        if self.size != world:
            raise ValueError(f"mesh {'x'.join(map(str, shape))} != {world} ranks of the "
                             "process group")
        m = self.shape[MODEL_AXIS]
        self.rank = multihost.rank()
        self.model_size = m
        self.data_size = self.size // m
        self.data_index, self.model_index = divmod(self.rank, m)
        # the trainers fill this in: name -> sharded dim (None: replicated)
        self.param_spec: Dict[str, Optional[int]] = {}
        self.data_group = self.model_group = None
        if world > 1:
            # every rank creates every group, in the same order
            for k in range(m):
                g = dist.new_group(list(range(k, self.size, m)))
                if k == self.model_index:
                    self.data_group = g
            for j in range(self.data_size):
                g = dist.new_group(list(range(j * m, (j + 1) * m)))
                if j == self.data_index:
                    self.model_group = g

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(shape: Tuple[int, int] = (-1, 1)) -> Mesh:
    """A ('data', 'model') mesh over the process group; shape (-1, m) gives
    every remaining rank to 'data'."""
    n = multihost.world_size()
    d, m = shape
    if d == -1:
        if n % m:
            raise ValueError(f"{n} ranks not divisible by model={m}")
        d = n // m
    return Mesh((d, m), (DATA_AXIS, MODEL_AXIS))


def make_hierarchical_mesh(shape: Tuple[int, int, int]) -> Mesh:
    """A ('slice', 'data', 'model') mesh: 'slice' the outer axis (hosts or
    slices), the batch split over ('slice', 'data') jointly."""
    return Mesh(tuple(shape), (SLICE_AXIS, DATA_AXIS, MODEL_AXIS))


def mesh_from_shape(shape) -> Mesh:
    """`make_mesh` for a 2-tuple, `make_hierarchical_mesh` for a 3-tuple."""
    shape = tuple(shape)
    return make_hierarchical_mesh(shape) if len(shape) == 3 else make_mesh(shape)


def fit_mesh_shape(batch_size: int, mesh_shape, n_devices: int) -> Tuple[int, int]:
    """The (data, model) shape a run takes (`avsync/cli.py:93-109`): the
    data axis is the gcd of the batch and the devices a model group leaves
    (excess devices stay idle), unless the config fixes it."""
    d_req, m = tuple(mesh_shape)[-2:]
    m = max(m, 1)
    avail = max(n_devices // m, 1)
    return (math.gcd(batch_size, avail) if d_req == -1 else d_req), m


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def lipnet_param_spec(named_params, model_axis_size: int = 0) -> Dict[str, Optional[int]]:
    """name -> the dim its rows shard on over 'model' (0), or None for
    replicated, for a LipNet's / TFLipNet's (name, tensor) pairs.
    `model_axis_size` <= 1 replicates everything; 0 skips the divisibility
    check (the idealised spec, as the JAX function's)."""

    def ok(t) -> bool:
        if model_axis_size <= 1:
            return model_axis_size == 0
        return t.shape[0] % model_axis_size == 0

    spec = {}
    for name, t in named_params:
        top = name.split(".")[0]
        if top.startswith(("gru", "lstm")) or top in ("fc", "head"):
            spec[name] = 0 if ok(t) else None
        else:
            spec[name] = None
    return spec


def shard_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's contiguous block of t's rows."""
    n = t.shape[0] // mesh.model_size
    return t[mesh.model_index * n:(mesh.model_index + 1) * n]


class ShardGather(torch.autograd.Function):
    """Forward: the model group's shards concatenated along `dim`. Backward:
    this rank's slice of the (whole, identical on every model rank)
    gradient."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, t.shape[dim]
        return multihost.all_gather(t, dim, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        k = ctx.mesh.model_index
        return g.narrow(ctx.dim, k * ctx.n, ctx.n), None, None


class ModelInput(torch.autograd.Function):
    """Forward: the identity. Backward: the all-reduce over the model group
    of the partial input gradients that the row shards produce."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        multihost.all_reduce(g, group=ctx.mesh.model_group)
        return g, None


class TensorParallel:
    """What a sharded layer calls: `enter(x)` on its replicated input,
    `gather(t, dim)` on what its shards computed."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return ModelInput.apply(x, self.mesh)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return ShardGather.apply(t, dim % t.dim(), self.mesh)


def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Replace each parameter the spec shards by this rank's rows of it and
    give its layer the mesh's `TensorParallel` (`layer.tp`); returns the spec
    (also kept as `mesh.param_spec`). With model size 1 nothing changes."""
    spec = lipnet_param_spec(list(model.named_parameters()), mesh.model_size)
    mesh.param_spec = spec
    if mesh.model_size == 1:
        return spec
    tp = TensorParallel(mesh)
    for name, dim in spec.items():
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        old = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(shard_rows(old.detach(), mesh).clone()))
        mod.tp = tp
    return spec


# ---------------------------------------------------------------------------
# data parallelism: one reduction of one flat buffer, and the global norm
# ---------------------------------------------------------------------------

class GradientReducer:
    """A rank's gradients and its loss in one flat buffer, all-reduced (SUM)
    over the data group in one call: `pack` after the backward, `reduce`,
    then `unpack` (divided by the data size when `mean`) back into the
    gradients; `unpack` returns the reduced loss as a view of the buffer.
    One reduction of one buffer is deterministic, and the three parts split
    the step where a CUDA graph cannot hold the collective."""

    def __init__(self, params, mesh: Mesh, mean: bool = True):
        self.params = list(params)
        self.mesh = mesh
        self.mean = mean
        self.n = sum(p.numel() for p in self.params)
        self.flat = torch.zeros(self.n + 1, dtype=torch.float32, device=self.params[0].device)

    def pack(self, loss: torch.Tensor) -> None:
        torch.cat([p.grad.reshape(-1) for p in self.params] + [loss.reshape(1).float()],
                  out=self.flat)

    def reduce(self) -> None:
        multihost.all_reduce(self.flat, group=self.mesh.data_group)

    def unpack(self) -> torch.Tensor:
        if self.mean:
            self.flat.div_(self.mesh.data_size)
        o = 0
        for p in self.params:
            p.grad.copy_(self.flat[o:o + p.numel()].view_as(p))
            o += p.numel()
        return self.flat[self.n]


def clip_grad_norm(named_params, max_norm: float, mesh: Optional[Mesh]) -> torch.Tensor:
    """`clip_grad_norm_` over the whole model when its leaves are row shards:
    the global norm^2 is the sum over replicated gradients (each counted
    once) plus the model group's all-reduce of the sum over sharded ones.
    Without a model axis it is `torch.nn.utils.clip_grad_norm_` itself."""
    named_params = list(named_params)
    params = [p for _, p in named_params]
    if mesh is None or mesh.model_size == 1:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    spec = mesh.param_spec
    norms = [torch.linalg.vector_norm(p.grad, 2) for p in params]
    rep = torch.stack([n for (k, _), n in zip(named_params, norms)
                       if spec.get(k) is None]).square().sum()
    sharded = torch.stack([n for (k, _), n in zip(named_params, norms)
                           if spec.get(k) is not None]).square().sum()
    multihost.all_reduce(sharded, group=mesh.model_group)
    total = (rep + sharded).sqrt()
    coef = (max_norm / (total + 1e-6)).clamp(max=1.0)
    torch._foreach_mul_([p.grad for p in params], coef)
    return total
