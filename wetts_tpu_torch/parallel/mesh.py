"""Data parallelism over `torch.distributed` (port of
wetts_tpu/parallel/mesh.py).

The JAX package puts one mesh with a 'data' axis over every chip, shards
the batch over it and lets XLA insert the gradient psum into the jitted
step. Here it is one process per GPU (NCCL; gloo on the CPU, and for
several processes on one GPU, which NCCL refuses), with the nets
replicated and each rank holding its rows of the global batch:

- `init_distributed` joins the process group (torchrun's environment or
  explicit flags) and returns the rank's device;
- `host_shard_info` gives (rank, world) for the batcher's rank striding;
- `replicate` broadcasts rank 0's parameters, buffers and optimiser moments
  (at start and after a resume);
- `all_reduce_grads` sums one net's gradients over the ranks in one
  collective, on one flat buffer;
- `global_max` agrees on host integers (the trainer pads every rank's text
  to the widest rank's) and `check_same_shapes` raises unless the ranks'
  batches have the same shapes, over a gloo group that does not wait for
  the GPU;
- while a training step runs inside `sharded(rank, world)`,
  `ops/random.py` draws the global batch's values and keeps this rank's
  rows (a draw over a sharded global array in JAX has the unsharded draw's
  values), and `global_sum` / `global_std` give the statistics of the
  global batch that a loss normalises by.

So a step on N ranks of B rows equals one step on N * B rows: each rank
computes its share of the global loss (`train/step.py`) and the gradients
are summed, not averaged.

`make_mesh(n_devices)`, one mesh over several devices inside one process,
has no torch idiom: a process drives one GPU here, so there is no mesh to
make and no `shard_batch` (each rank already holds only its rows).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# (rank, world) of the step running now; (0, 1) outside a sharded step
_SHARD: Tuple[int, int] = (0, 1)
# (the default group it belongs to, a gloo group over the same ranks)
_HOST_GROUP: Tuple[object, object] = (None, None)


def is_distributed() -> bool:
    """Whether this process is in a default process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def host_shard_info() -> Tuple[int, int]:
    """(rank, world) of this process in the default process group, or
    (0, 1) without one."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> torch.device:
    """Join the default process group and return this rank's device.

    coordinator ("host:port"), num_processes and process_id: given all
    three, the group meets at tcp://coordinator; given none, torchrun's
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT are read (env://).
    device: "cpu", or "cuda" (None) for cuda:LOCAL_RANK (torchrun's
    LOCAL_RANK, else the process id modulo the visible GPUs), which is made
    the current device. The backend is NCCL where every process of this
    host has a GPU of its own, and gloo on the CPU or where this host runs
    more processes than it has GPUs (NCCL refuses two ranks on one GPU).
    The processes of this host are torchrun's LOCAL_WORLD_SIZE, else all
    of them.
    """
    flags = (coordinator, num_processes, process_id)
    if any(f is not None for f in flags) and None in flags:
        raise ValueError("--coordinator, --num_processes and --process_id "
                         "go together")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to train "
                "on the CPU over gloo")
        if dev.index is None:
            rank = (process_id if process_id is not None
                    else int(os.environ.get("RANK", "0")))
            local = int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes
                               or os.environ.get("WORLD_SIZE", "1")))
    backend = ("nccl" if dev.type == "cuda"
               and local <= torch.cuda.device_count() else "gloo")
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dev


def _coalesced(tensors: Sequence[torch.Tensor], op) -> None:
    """Run the collective `op` on one flat buffer per dtype and copy the
    result back into `tensors`."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        op(flat)
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


def _device_of(tensors: Sequence[torch.Tensor]) -> torch.device:
    """Where the backend's collectives run: the GPU under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return tensors[0].device


@torch.no_grad()
def replicate(modules: Iterable[torch.nn.Module],
              optimizers: Iterable[torch.optim.Optimizer] = ()) -> None:
    """Broadcast rank 0's parameters, buffers and optimiser state tensors
    to every rank, in place (wetts_tpu/parallel/mesh.py:57-60). Without a
    process group, or at world 1, nothing happens."""
    if host_shard_info()[1] == 1:
        return
    tensors = []
    for m in modules:
        tensors += list(m.parameters()) + list(m.buffers())
    for opt in optimizers:
        for state in opt.state.values():
            tensors += [v for v in state.values()
                        if isinstance(v, torch.Tensor)]
    if not tensors:
        return
    dev = _device_of(tensors)
    on_dev = [t for t in tensors if t.device == dev]
    off_dev = [t for t in tensors if t.device != dev]
    _coalesced(on_dev, lambda flat: dist.broadcast(flat, 0))
    if off_dev:  # e.g. AdamW's `step` counters on the CPU under NCCL
        moved = [t.to(dev) for t in off_dev]
        _coalesced(moved, lambda flat: dist.broadcast(flat, 0))
        for t, v in zip(off_dev, moved):
            t.copy_(v)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the gradients of `params` over the ranks, in place: one
    all-reduce of one flat buffer per dtype. Parameters without a gradient
    are left out; every rank must have gradients for the same ones."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _coalesced(grads, dist.all_reduce)


def _host_group():
    """A gloo group over the default group's ranks (the default group
    itself under gloo): host integers are agreed on through it without
    waiting for the work queued on a GPU, as an NCCL collective would."""
    global _HOST_GROUP
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if _HOST_GROUP[0] is not world:
        _HOST_GROUP = (world, dist.new_group(backend="gloo"))
    return _HOST_GROUP[1]


def global_max(values: Sequence[int]) -> List[int]:
    """The elementwise maximum of the host integers `values` over the
    ranks (each passes as many)."""
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return t.tolist()


def check_same_shapes(tensors: Dict[str, torch.Tensor]) -> None:
    """Raise ValueError on every rank unless every rank passes tensors of
    the same shapes under the same keys. A sharded step needs them: each
    draw takes the global batch's shape from the shared generator, so
    ranks of unequal shapes would draw unequal amounts from it and drift
    apart, and the global normalisers would not be the global batch's."""
    dims = [d for k in sorted(tensors) for d in tensors[k].shape]
    mine = dims + [-d for d in dims]
    if global_max(mine) != mine:  # the maxima and the minima are this rank's
        shapes = {k: tuple(tensors[k].shape) for k in sorted(tensors)}
        raise ValueError(f"rank {dist.get_rank()}'s batch {shapes} differs "
                         f"in shape from another rank's: every rank of a "
                         f"data-parallel step needs the same shapes")


@contextlib.contextmanager
def sharded(rank: int, world: int) -> Iterator[None]:
    """The draws and global statistics inside take this rank's rows of a
    global batch of `world` equal shards."""
    global _SHARD
    saved, _SHARD = _SHARD, (rank, world)
    try:
        yield
    finally:
        _SHARD = saved


def current_shard() -> Tuple[int, int]:
    """(rank, world) of the sharded step running now, (0, 1) outside."""
    return _SHARD


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks of the sharded step (no gradient flows
    through the other ranks' terms); x itself outside one."""
    if _SHARD[1] == 1:
        return x
    total = x.detach().clone()
    dist.all_reduce(total)
    return total


def global_std(x: torch.Tensor) -> torch.Tensor:
    """The population std over every element of the global batch (two
    passes: the mean, then the squared deviations); `torch.std(x,
    correction=0)` at world 1."""
    if _SHARD[1] == 1:
        return torch.std(x, correction=0)
    n = global_sum(torch.tensor(float(x.numel()), device=x.device))
    mean = global_sum(torch.sum(x)) / n
    return torch.sqrt(global_sum(torch.sum((x - mean) ** 2)) / n)
