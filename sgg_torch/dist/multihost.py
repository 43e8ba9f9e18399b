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

Sequence parallelism (``sgg_torch.dist.sequence_parallel``) adds two
collectives over a group, each a Function whose backward applies its dual:
:func:`ring_shift`, the reference's ``ppermute`` of rank i's tensor to rank
i + shift (``dist.batch_isend_irecv``), whose dual is the opposite shift; and
:func:`all_to_all`, the reference's tiled ``all_to_all`` (rank j's slice j of
the split dimension, concatenated in rank order along another), whose dual
is the inverse all-to-all; and :func:`split_many`, :func:`split` of several
tensors whose gradients are gathered in one bucket. Pipeline parallelism
(``sgg_torch.dist.pipeline_parallel``) hops its stages' activations with
:func:`shift_tensors` and hands the last stage's output to every stage with
:func:`broadcast_tensor`, both without gradient. Collectives that move
data and sum nothing (the all-gathers, the shifts, the all-to-alls) carry a
16-bit float as its float16 bit pattern (exact; every gloo release knows
float16) and anything else as float32, and on gloo a CUDA tensor stages
through pinned host memory.
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
    if sharding.dim is not None or not is_multiprocess():
        return tree
    group = dist.group.WORLD  # replicated over the mesh: over every rank
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


_HALF = (torch.bfloat16, torch.float16)


def _gloo_on_cuda(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _carried(x: torch.Tensor, group) -> torch.Tensor:
    """x as a collective that moves data and sums nothing sends it over
    ``group``, contiguous: a 16-bit float as its float16 bit pattern, anything
    else as :func:`_wire` gives it; on gloo, a CUDA tensor staged in pinned
    host memory."""
    x = x.detach()
    w = x.contiguous().view(torch.float16) if x.dtype in _HALF else _wire(x)
    if _gloo_on_cuda(w, group):
        host = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
        return host.copy_(w)
    return w


def _receiver(w: torch.Tensor, shape=None) -> torch.Tensor:
    """An empty tensor like the carried ``w`` (of ``shape``), pinned as it is."""
    return torch.empty(w.shape if shape is None else shape, dtype=w.dtype, device=w.device,
                       pin_memory=w.is_pinned())


def _landed(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A carried tensor back in ``like``'s dtype, on its device."""
    w = w.to(like.device)
    return w.view(like.dtype) if like.dtype in _HALF else w.to(like.dtype)


def gather_tensor(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order, in x's dtype and on its device. No gradient."""
    n = group_size(group)
    if n == 1:
        return x
    w = _carried(x, group)
    out = _receiver(w, (n, *w.shape))
    dist.all_gather(list(out.unbind(0)), w, group=group)
    return torch.cat(_landed(out, x).unbind(0), dim)


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


# The most bytes (as sent) that one bucket of gather_tensors carries: a larger
# list goes in several, so that the bucket's gathered copies (n times it, on
# the host and the device) stay small beside a training step's memory.
BUCKET_BYTES = 1 << 28


def gather_tensors(xs: list[torch.Tensor], dims: list[int], group) -> list[torch.Tensor]:
    """:func:`gather_tensor` of each of ``xs`` along its dim in ``dims``, in
    one collective for each run of consecutive tensors that fills at most
    ``BUCKET_BYTES`` (a larger tensor alone): each tensor is moved to put its
    dim first and the parts travel as one flat bucket, float32 (in their
    dtype when all share one 16-bit dtype)."""
    if group_size(group) == 1 or not xs:
        return list(xs)
    out, run, size = [], [], 0
    for i, x in enumerate(xs):
        b = x.numel() * max(x.element_size(), 4)
        if run and size + b > BUCKET_BYTES:
            out += _gather_bucket([xs[j] for j in run], [dims[j] for j in run], group)
            run, size = [], 0
        run.append(i)
        size += b
    return out + _gather_bucket([xs[j] for j in run], [dims[j] for j in run], group)


def _gather_bucket(xs: list[torch.Tensor], dims: list[int], group) -> list[torch.Tensor]:
    n = group_size(group)
    moved = [x.detach().movedim(d, 0) for x, d in zip(xs, dims)]
    half = len({x.dtype for x in xs}) == 1 and xs[0].dtype in _HALF
    flat = torch.cat([(m if half else _wire(m)).reshape(-1) for m in moved])
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


# ------------------------------------------- sequence-parallel collectives

def shift_tensors(xs: list[torch.Tensor], group, shift: int = 1) -> list[torch.Tensor]:
    """Each of ``xs`` from the rank ``shift`` places behind in ``group``'s
    ring: rank i's tensors go to rank (i + shift) mod n, in one
    ``batch_isend_irecv``. Shapes and dtypes are the same on every rank; the
    results are new contiguous tensors in each input's dtype, on its device.
    No gradient. A group of one returns ``xs``."""
    n = group_size(group)
    if n == 1 or shift % n == 0:
        return list(xs)
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    sends = [_carried(x, group) for x in xs]
    recvs = [_receiver(w) for w in sends]
    ops = [dist.P2POp(dist.isend, w, to, group) for w in sends]
    ops += [dist.P2POp(dist.irecv, r, frm, group) for r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_landed(r, x) for r, x in zip(recvs, xs)]


def all_to_all_tensor(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over ``group``: x's ``split_dim`` cut into n equal
    slices, slice j sent to rank j, and the slices that arrive concatenated
    along ``concat_dim`` in rank order (``jax.lax.all_to_all(..., tiled=
    True)``). No gradient. A group of one returns x."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {n} ranks")
    w = _carried(torch.stack(x.detach().chunk(n, split_dim)), group)  # slice j for rank j
    out = _receiver(w)
    dist.all_to_all_single(out, w, group=group)
    return torch.cat(_landed(out, x).unbind(0), concat_dim)


def broadcast_tensor(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Rank ``src`` (of ``group``)'s ``x`` on every rank of ``group``, a new
    tensor in x's dtype on its device; the other ranks' ``x`` gives only the
    shape and dtype. No gradient. A group of one returns x."""
    if group_size(group) == 1:
        return x
    w = _carried(x, group)
    if not w.is_pinned():  # NCCL broadcasts in place: never into the caller's x
        w = w.clone()
    dist.broadcast(w, dist.get_global_rank(group, src), group=group)
    return _landed(w, x)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return shift_tensors([x], group, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return _RingShift.apply(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return all_to_all_tensor(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _AllToAll.apply(g, ctx.group, concat_dim, split_dim), None, None, None


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` on rank (i + shift) mod n of ``group`` (the reference's
    ``ppermute`` over ``[(i, (i + shift) % n)]``); its gradient travels back,
    the opposite shift."""
    return _RingShift.apply(x, group, shift)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all (:func:`all_to_all_tensor`); its gradient is the
    inverse all-to-all, ``split_dim`` and ``concat_dim`` swapped."""
    return _AllToAll.apply(x, group, split_dim % x.dim(), concat_dim % x.dim())


class _SplitMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, *xs):
        ctx.group, ctx.dim = group, dim
        return tuple(slice_of(x, group, dim) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_AllGatherMany.apply(ctx.group, ctx.dim, *gs))


class _AllGatherMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, *xs):
        ctx.group, ctx.dim = group, dim
        return tuple(gather_tensors(list(xs), [dim] * len(xs), group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_SplitMany.apply(ctx.group, ctx.dim, *gs))


def split_many(xs: list[torch.Tensor], group, dim: int) -> list[torch.Tensor]:
    """:func:`split` of each of ``xs`` (all of one rank, ``dim`` >= 0); their
    gradients are all-gathered in one bucket (:func:`gather_tensors`)."""
    return list(_SplitMany.apply(group, dim, *xs))
