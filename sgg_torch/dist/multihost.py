"""The multi-process runtime and the data-parallel collectives, from
``sgg/dist/multihost.py``.

``torchrun`` (``python -m torch.distributed.run``) starts one process per
rank and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`initialize_multihost` joins that
process group and is a no-op in a process that torchrun did not start. The
backend is a rule, printed when the group forms:
  - ``nccl`` when each rank has a CUDA device of its own (rank r on
    ``cuda:LOCAL_RANK``);
  - ``gloo`` on the CPU, and when the ranks of a host outnumber its CUDA
    devices, so that ranks share one (NCCL refuses two ranks on one device;
    gloo all-reduces and broadcasts CUDA tensors, staging them through the
    host itself).
Each process draws from its own slice of the data (:func:`process_shard_info`).

The collectives of tensor parallelism and FSDP (``sgg_torch.dist.sharding``)
act over a subgroup, a mesh axis's (:func:`all_gather`, :func:`split`,
:func:`all_reduce`, :func:`copy_to`, :func:`reduce_scatter`). Each is a
``torch.autograd.Function`` whose backward applies its dual Function, so a
gradient through it can be differentiated again (the gradient penalty's
double backward runs through the critic's vocab-parallel embedding). They
follow the tensor-parallel convention: a tensor is either replicated over the
group or this rank's part of it, and a gradient follows its tensor, so
``all_gather``'s backward takes this rank's slice (``split``) and
``copy_to``'s (an identity) all-reduces. Sums run in float32, as
:func:`pmean`'s. By rule, on gloo: an all-gather of CUDA tensors stages
through the host (gloo all-reduces and broadcasts CUDA tensors, and nothing
else), and a reduce-scatter is an all-reduce followed by taking this rank's
slice (gloo's reduce-scatter is missing in some torch releases); the backend
line says so. NCCL runs ``all_gather`` and ``reduce_scatter_tensor``
themselves.
A replicated state is made equal on every rank by a broadcast from rank 0
(:func:`host_local_to_global`), and gradients and metrics are averaged by
:func:`pmean`: one flattened float32 bucket, summed, then multiplied by
1/world in float32 (``ReduceOp.AVG`` is NCCL's alone). A group that fails to
form and a collective that raises or passes ``GROUP_TIMEOUT`` raise; nothing
here carries on with fewer ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

# How long a collective (or the group's forming) may wait for the other
# ranks before it raises: past a checkpoint written by rank 0 and a first
# step's kernel builds.
GROUP_TIMEOUT = timedelta(seconds=300)


@dataclass(frozen=True)
class ProcessShard:
    index: int
    count: int


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def launched_world() -> int:
    """``WORLD_SIZE`` as torchrun set it (1 in a process it did not start)."""
    return _env_int("WORLD_SIZE", 1)


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device(device) -> torch.device:
    """This rank's device for ``device`` ('cuda' or 'cpu'): the CPU; in one
    process ``device`` itself; under torchrun ``cuda:LOCAL_RANK`` when the
    host has a card per local rank, else ``cuda:(LOCAL_RANK % cards)``."""
    device = torch.device(device)
    if device.type != "cuda" or "WORLD_SIZE" not in os.environ:
        return device
    cards = torch.cuda.device_count()
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % max(cards, 1))


def backend_for(device) -> tuple[str, str]:
    """(backend, why) for ranks on ``device`` (as :func:`rank_device` gives it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    local, cards = _env_int("LOCAL_WORLD_SIZE", 1), torch.cuda.device_count()
    if local > cards:
        return "gloo", (f"{local} ranks share {cards} CUDA device{'s' if cards > 1 else ''}; "
                        "NCCL refuses two ranks on one device; all-gathers stage through "
                        "the host, reduce-scatters are all-reduces")
    return "nccl", "a CUDA device for each rank"


def initialize_multihost(device="cuda", log=print) -> torch.device:
    """Join torchrun's process group (backend by :func:`backend_for`) and
    return this rank's device; in a process that torchrun did not start, a
    no-op that returns ``device``. Raises if the group does not form."""
    device = rank_device(device)
    if "WORLD_SIZE" not in os.environ or is_multiprocess():
        return device
    backend, why = backend_for(device)
    rank, world = _env_int("RANK", 0), launched_world()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, **kw)
    log(f"[sgg.dist] rank {rank} of {world} on {device}: backend {backend} ({why})")
    return device


def process_shard_info() -> ProcessShard:
    """This process's index and the number of processes. Raises when torchrun
    launched several but no group formed: no rank trains alone."""
    if is_multiprocess():
        return ProcessShard(index=dist.get_rank(), count=dist.get_world_size())
    if launched_world() > 1:
        raise RuntimeError(f"WORLD_SIZE={launched_world()} but this process joined no process "
                           "group (call initialize_multihost first)")
    return ProcessShard(index=0, count=1)


def pmean(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The mean over the group's ranks of each tensor, as new tensors of its
    shape and dtype: one flattened float32 bucket, one all-reduce (sum), then
    × 1/world in float32. A world of one returns each tensor's values
    unchanged."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.mul_(1.0 / dist.get_world_size(group))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def broadcast_tensors(tensors: list[torch.Tensor], group=None, src: int = 0) -> None:
    """Copy rank ``src``'s values into every rank's ``tensors``, in place:
    one flattened bucket per dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src, group=group)
        at = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if tree is None:
        return []
    raise TypeError(f"no tensors to place in {type(tree).__name__}")


def host_local_to_global(tree, sharding):
    """The reference's assembly of global arrays from each process's data.
    Replicated (``sharding.dim`` None): rank 0's values broadcast into
    every rank's, in place, for a train state (its tensors and step), a
    module, or a dict or list of tensors. Split over 'data': each rank's
    data are its own shard already, returned as they are."""
    # Replicated over a mesh with a model axis: over every rank.
    group = sharding.mesh.group if sharding.mesh.model == 1 else dist.group.WORLD
    if sharding.dim is not None or not is_multiprocess():
        return tree
    if hasattr(tree, "tensors"):  # a GANTrainState: its tensors, then its step
        step = torch.tensor([int(tree.step)], device=sharding.mesh.device)
        broadcast_tensors(tree.tensors() + [step], group)
        tree.step = int(step)
    else:
        broadcast_tensors(_leaves(tree), group)
    return tree


# ----------------------------------------------------- subgroup collectives

def group_size(group) -> int:
    """The ranks of ``group``; 1 for None (an axis of one rank)."""
    return 1 if group is None else dist.get_world_size(group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as it travels: float32 (float64 stays), contiguous. An upcast from
    bfloat16 or float16 is exact, and gloo sums neither."""
    return (x if x.dtype == torch.float64 else x.float()).contiguous()


def _gloo_on_cuda(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def gather_tensor(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order, in x's dtype and on its device. No gradient."""
    n = group_size(group)
    if n == 1:
        return x
    w = _wire(x.detach())
    staged = _gloo_on_cuda(w, group)
    if staged:
        w = w.cpu()
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim).to(device=x.device, dtype=x.dtype)


def scatter_mean_tensor(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the mean over ``group`` of every
    rank's ``x``: a float32 sum, then × 1/n in float32 (:func:`pmean`'s
    arithmetic), in x's dtype. No gradient. ``x.shape[dim]`` must divide."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    w = _wire(x.detach().movedim(dim, 0))
    per = w.shape[0] // n
    if dist.get_backend(group) == "nccl":
        out = torch.empty((per, *w.shape[1:]), dtype=w.dtype, device=w.device)
        dist.reduce_scatter_tensor(out, w, group=group)
    else:  # gloo: an all-reduce, then this rank's slice
        w = w.clone()
        dist.all_reduce(w, group=group)
        out = w[dist.get_rank(group) * per:(dist.get_rank(group) + 1) * per]
    out = out * (1.0 / n)
    return out.movedim(0, dim).contiguous().to(x.dtype)


def sum_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, in float32, cast back
    to x's dtype. No gradient."""
    if group_size(group) == 1:
        return x
    w = _wire(x.detach()).clone()
    dist.all_reduce(w, group=group)
    return w.to(x.dtype)


def slice_of(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's one of ``group``'s equal slices of ``x`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    per = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * per, per).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_tensor(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return slice_of(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return scatter_mean_tensor(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group, ctx.dim) * (1.0 / group_size(ctx.group)), None, None


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's part, concatenated along ``dim`` (replicated out); its
    gradient is this rank's slice of the replicated gradient."""
    return _AllGather.apply(x, group, dim % x.dim())


def split(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim``; its gradient
    is the all-gather of the ranks' slices' gradients."""
    return _Split.apply(x, group, dim % x.dim())


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' partial ``x`` (replicated out);
    its gradient passes as it is (:func:`copy_to`'s forward)."""
    return _AllReduce.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated ``x`` entering rank-local computation: the identity,
    whose gradient (a partial sum on each rank) is all-reduced."""
    return _Copy.apply(x, group)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the mean over ``group`` (float32
    sum × 1/n); its gradient is the all-gather of the slices' gradients
    × 1/n."""
    return _ReduceScatter.apply(x, group, dim % x.dim())


def gather_tensors(xs: list[torch.Tensor], dims: list[int], group) -> list[torch.Tensor]:
    """:func:`gather_tensor` of each of ``xs`` along its dim in ``dims``, in
    one collective: each tensor is moved to put its dim first and the parts
    travel as one flat float32 bucket."""
    if group_size(group) == 1 or not xs:
        return list(xs)
    n = group_size(group)
    moved = [x.detach().movedim(d, 0) for x, d in zip(xs, dims)]
    flat = torch.cat([_wire(m).reshape(-1) for m in moved])
    parts = gather_tensor(flat, group, 0).view(n, -1)
    out, at = [], 0
    for x, m, d in zip(xs, moved, dims):
        k = m.numel()
        full = parts[:, at:at + k].reshape(n * m.shape[0], *m.shape[1:])
        out.append(full.movedim(0, d).contiguous().to(x.dtype))
        at += k
    return out


def scatter_mean_tensors(xs: list[torch.Tensor], dims: list[int], group) -> list[torch.Tensor]:
    """:func:`scatter_mean_tensor` of each of ``xs`` along its dim in
    ``dims``, in one collective over a flat float32 bucket."""
    if group_size(group) == 1 or not xs:
        return list(xs)
    n = group_size(group)
    moved = [x.detach().movedim(d, 0) for x, d in zip(xs, dims)]
    for x, m in zip(xs, moved):
        if m.shape[0] % n:
            raise ValueError(f"{tuple(x.shape)} does not split over {n} ranks")
    rows = torch.cat([_wire(m).reshape(n, -1) for m in moved], dim=1)
    mine = scatter_mean_tensor(rows, group, 0).reshape(-1)
    out, at = [], 0
    for x, m, d in zip(xs, moved, dims):
        shape = (m.shape[0] // n, *m.shape[1:])
        k = m.numel() // n
        out.append(mine[at:at + k].reshape(shape).movedim(0, d).contiguous().to(x.dtype))
        at += k
    return out
