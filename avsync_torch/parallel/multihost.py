"""Process groups, the rank's device, and the few collectives the port runs
(port of `avsync/parallel/multihost.py`).

PyTorch's idiom for what a JAX single controller does over its mesh is one
process per device: every rank runs the same program on its own rows and
the ranks meet in collectives. This module is the seam:

  * `initialize()` joins (or starts) the group: from torchrun's variables
    (`MASTER_ADDR`/`MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`) or from
    explicit arguments, with a finite timeout, so a rank that dies fails its
    peers' next collective instead of hanging them. Rank r runs on
    `cuda:(LOCAL_RANK mod device_count)`; the backend is NCCL where every
    rank of the host has a card of its own and gloo where ranks share one
    (NCCL refuses two ranks on one card), and gloo on the CPU;
  * `spawn()` starts n ranks of a function on this host (the CLI's `train`
    and `misalign-train` on an n-card host, the CPU tests' gloo ranks);
  * `local_rows(B, mesh)` is the port's `put_with_sharding`: the contiguous
    block of a global batch's rows that this rank's data index owns, as
    `P('data')` cuts them, so each rank decodes and uploads only those;
  * `get_global` gathers tensor-parallel shards into whole tensors;
  * `any_process_flagged` is a lockstep vote (an all-reduce MAX of a flag);
  * `all_reduce`, `all_gather`, `send`, `recv`: the collectives of the
    trainers and of context parallelism. Under gloo a CUDA tensor is staged
    through host memory here, in this one helper (`_staged`): gloo's CUDA
    support covers all_reduce and broadcast only, and a blocking copy to
    the host also orders the collective after the card's work. NCCL takes
    the card's tensors directly.

Single-process (no group initialised) every helper is the identity.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multiprocess", "rank", "world_size", "is_main", "rank_device",
           "backend", "spawn", "free_port", "local_rows", "get_global", "any_process_flagged",
           "all_reduce", "all_gather", "send", "recv", "barrier", "broadcast_object"]

# a rank that dies fails its peers' next collective after this long
TIMEOUT = datetime.timedelta(seconds=120)

_device: Optional[torch.device] = None


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize(rank: Optional[int] = None, world: Optional[int] = None,
               address: Optional[str] = None, device: Optional[str] = None) -> int:
    """Join the process group; returns this process's rank.

    With no arguments, torchrun's environment says rank, world size, local
    rank and the rendezvous (`MASTER_ADDR:MASTER_PORT`); explicit arguments
    (all of rank, world and address, e.g. "tcp://localhost:29500") take its
    place. `device` is "cuda" (the default: the card, raising without one)
    or "cpu" (gloo ranks on the CPU, as the tests run). The ranks on this
    host (torchrun's LOCAL_WORLD_SIZE, else the world; with explicit
    arguments, all of them) decide the backend: NCCL when they are at most
    the card count, else gloo; the rank's card is its local rank
    (LOCAL_RANK, else its rank) modulo the card count."""
    global _device
    explicit = (rank, world, address)
    if any(a is not None for a in explicit) and any(a is None for a in explicit):
        raise ValueError("pass rank, world and address together (got a partial set)")
    if rank is None:
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if rank is None or world is None or not addr or not port:
            raise ValueError("no process group to join: run under torchrun (RANK, WORLD_SIZE, "
                             "MASTER_ADDR, MASTER_PORT) or pass rank, world and address")
        address = f"tcp://{addr}:{port}"
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
    else:  # explicit: every rank on this host
        local_rank, local_world = rank, world
    kind = device or "cuda"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' for gloo ranks "
                               "on the CPU")
        n = torch.cuda.device_count()
        _device = torch.device("cuda", local_rank % n)
        torch.cuda.set_device(_device)
        name = "nccl" if local_world <= n else "gloo"
    elif kind == "cpu":
        _device = torch.device("cpu")
        name = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    dist.init_process_group(name, init_method=address, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return rank


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, or a single process: the one that writes consoles, logs and
    checkpoints."""
    return rank() == 0


def rank_device() -> Optional[torch.device]:
    """The device `initialize` gave this rank (None before it)."""
    return _device


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def _spawned(local: int, fn: Callable, world: int, address: str, device: str,
             args: Sequence) -> None:
    if device == "cpu":  # the host's cores shared out, not each rank taking all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize(local, world, address, device=device)
    try:
        fn(local, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), device: str = "cuda") -> None:
    """Run `fn(rank, *args)` in `world` new processes of this host joined into
    one group on a free localhost port (`device` as in `initialize`). Returns
    when every rank has returned; a rank that raises makes this raise (and
    the others are stopped). `fn` must be importable (a module-level
    function)."""
    import torch.multiprocessing as mp

    address = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_spawned, args=(fn, world, address, device, tuple(args)),
                       nprocs=world, join=True, start_method="spawn")


def local_rows(B: int, mesh) -> slice:
    """The rows [r B/d, (r+1) B/d) of a global batch of B that data index r of
    `mesh` owns ('slice' and 'data' taken jointly, as `P(('slice','data'))`
    cuts them); every row without a mesh."""
    if mesh is None or mesh.data_size == 1:
        return slice(0, B)
    d = mesh.data_size
    if B % d:
        raise ValueError(f"a global batch of {B} rows does not split over {d} data ranks")
    n = B // d
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def _staged(t: torch.Tensor, run: Callable[[torch.Tensor], None]) -> None:
    """`run` on `t` in place; under gloo a CUDA tensor goes through a host
    copy (the blocking copy also orders it after the card's work)."""
    if t.device.type == "cuda" and backend() == "gloo":
        host = t.cpu()
        run(host)
        t.copy_(host)
    else:
        run(t)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (the world when None)."""
    if world_size() > 1:
        _staged(t, lambda x: dist.all_reduce(x, op=op, group=group))
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order."""
    n = dist.get_world_size(group)
    if t.device.type == "cuda" and backend() == "gloo":
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def send(t: torch.Tensor, dst: int) -> None:
    if t.device.type == "cuda" and backend() == "gloo":
        t = t.cpu()
    dist.send(t.contiguous(), dst)


def recv(t: torch.Tensor, src: int) -> torch.Tensor:
    _staged(t, lambda x: dist.recv(x, src))
    return t


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def any_process_flagged(flag: bool) -> bool:
    """True iff ANY rank passes flag=True: a lockstep vote for control flow
    every rank must take alike (stop training on SIGTERM). Every rank calls
    it at the same boundary; single-process it is `flag`."""
    if world_size() == 1:
        return bool(flag)
    dev = _device if backend() == "nccl" else torch.device("cpu")
    vote = torch.tensor([1.0 if flag else 0.0], device=dev)
    dist.all_reduce(vote, op=dist.ReduceOp.MAX)
    return bool(vote.item() >= 0.5)


def get_global(state: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """A state dict with every tensor-parallel shard gathered whole (every
    rank of the model group gets the whole tensors; every rank must call
    it). Without a model axis it is `state` itself."""
    if mesh is None or mesh.model_size == 1:
        return dict(state)
    spec = mesh.param_spec
    return {k: all_gather(v.detach(), 0, mesh.model_group) if spec.get(k) is not None else v
            for k, v in state.items()}
