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
                        "NCCL refuses two ranks on one device")
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
    group = sharding.mesh.group
    if sharding.dim is not None or not is_multiprocess():
        return tree
    if hasattr(tree, "tensors"):  # a GANTrainState: its tensors, then its step
        step = torch.tensor([int(tree.step)], device=sharding.mesh.device)
        broadcast_tensors(tree.tensors() + [step], group)
        tree.step = int(step)
    else:
        broadcast_tensors(_leaves(tree), group)
    return tree
