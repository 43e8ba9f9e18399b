"""Meshes and the batch's sharding, from ``sgg/dist/mesh.py``.

The reference's ``('data', 'model')`` mesh spans every device of every
process. The port runs one process per rank with one device each
(``torchrun``), so a training mesh is laid over the world of ranks
(:func:`mesh_from_config`): ``data × model`` must be the world, and rank
``d · model + m`` sits at data coordinate d and model coordinate m, so that a
model group is made of adjacent ranks, as ``jax.make_mesh`` keeps the
trailing axis on adjacent devices. Each rank holds the process group of its
data axis (the ranks that share its model coordinate) and of its model axis
(those that share its data coordinate); :func:`axis_groups` forms every group
on every rank in one order, as ``torch.distributed.new_group`` requires. A
single-process mesh spans a list of this process's devices
(:func:`make_mesh`), as ``make_dp_sampler`` and ``serve --dp`` take it: its
data axis is the first device of each model group. Batches split over
``'data'`` on their batch dimension (dim 1 of a super-batch,
:func:`batch_sharding`); ranks of one model group take the same rows. The
state's placement over the mesh (TP over ``'model'``, FSDP over ``'data'``)
is :mod:`sgg_torch.dist.sharding`'s. ``seq`` and ``expert`` > 1 are refused,
each naming the later slice that brings it (:func:`refuse_unported_mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
_LATER = "is not ported yet; a later slice of the port brings it"


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1  # -1 = every device (rank) not used by the other axes
    model: int = 1
    seq: int = 1
    expert: int = 1


@dataclass(frozen=True)
class Mesh:
    """A ``('data', 'model')`` mesh. ``devices``: the devices this process
    drives on the data axis (all of them in one process; this rank's one
    device across ranks); ``rank``: this process's first index on the data
    axis; ``group``: the data axis's process group across ranks (None in one
    process, and on a data axis of 1); ``model_rank`` and ``model_group``:
    the same of the model axis (None on a model axis of 1)."""

    data: int
    devices: tuple
    rank: int = 0
    group: object = None
    model: int = 1
    model_rank: int = 0
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def refuse_unported_mesh(mesh) -> None:
    """Raise for the mesh options (of a config's ``mesh`` or a
    :class:`MeshSpec`) whose tier is still to port."""
    later = (("sequence parallelism (mesh.seq > 1)", mesh.seq > 1, "A8c"),
             ("expert parallelism (mesh.expert > 1)", mesh.expert > 1, "A8e"))
    for what, on, slice_ in later:
        if on:
            raise NotImplementedError(f"{what} {_LATER} (ROADMAP {slice_}); the port's "
                                      "meshes have a data and a model axis only")


def _data_size(spec: MeshSpec, n: int) -> int:
    """The data axis of ``spec`` over ``n`` devices, with ``make_mesh``'s
    checks: too few devices, and fixed axes that do not divide ``n``."""
    model, seq, expert = max(1, spec.model), max(1, spec.seq), max(1, spec.expert)
    fixed = seq * expert * model
    if spec.data > 0:
        if spec.data * fixed > n:
            raise ValueError(f"mesh {spec.data}x{seq}x{expert}x{model} needs more than {n} "
                             "devices")
        data = spec.data
    else:
        if n % fixed:
            raise ValueError(f"seq*expert*model axes {seq}*{expert}*{model} do not divide "
                             f"device count {n}")
        data = n // fixed
    refuse_unported_mesh(spec)
    return data


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device, or the CPU when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def make_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """A single-process mesh over ``devices`` (default :func:`visible_devices`);
    an explicit ``spec.data`` takes the first ``data × model`` of them. Its
    data axis drives the first device of each model group."""
    spec = spec or MeshSpec()
    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    data, model = _data_size(spec, len(devices)), max(1, spec.model)
    return Mesh(data=data, devices=tuple(devices[:data * model:model]), model=model)


def axis_groups(world: int, model: int) -> tuple[list, list]:
    """(the data axis's groups, one per model coordinate; the model axis's
    groups, one per data coordinate) over ``world`` ranks laid out as
    ``d · model + m``. Every rank calls this with the same arguments: each
    group is formed on every rank, in one order (the model groups, then the
    data groups), as ``torch.distributed.new_group`` requires. An axis of
    size 1 forms no group (None), but a data axis that is the whole world
    (model 1) is the world's own group."""
    import torch.distributed as dist

    data = world // model
    model_groups = ([dist.new_group([d * model + m for m in range(model)])
                     for d in range(data)] if model > 1 else [None] * data)
    if model == 1:
        data_groups = [dist.group.WORLD]
    elif data == 1:
        data_groups = [None] * model
    else:
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
    return data_groups, model_groups


def mesh_from_config(mesh_cfg, device) -> Mesh:
    """The training mesh over the world of ranks, this rank on ``device``:
    ``mesh.model`` ranks to a model group, ``mesh.data`` = -1 (every group)
    or the world over ``mesh.model``; a smaller data axis would leave ranks
    idle and is refused."""
    import torch.distributed as dist

    refuse_unported_mesh(mesh_cfg)
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    model = max(1, mesh_cfg.model)
    data = _data_size(MeshSpec(data=mesh_cfg.data, model=model, seq=mesh_cfg.seq,
                               expert=getattr(mesh_cfg, "expert", 1)), world)
    if data * model != world:
        raise ValueError(f"mesh.data={data} x mesh.model={model} is a sub-mesh of the {world} "
                         f"ranks; launch {data * model} ranks (torchrun --nproc_per_node "
                         f"{data * model}) or set mesh.data=-1")
    if not on:
        return Mesh(data=1, devices=(torch.device(device),))
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    data_groups, model_groups = axis_groups(world, model)
    return Mesh(data=data, devices=(torch.device(device),), rank=d, group=data_groups[m],
                model=model, model_rank=m, model_group=model_groups[d])


@dataclass(frozen=True)
class Sharding:
    """Where an array lives on a mesh: split over ``'data'`` on ``dim``, or
    replicated (``dim`` None)."""

    mesh: Mesh
    dim: int | None

    def local(self, x):
        """This rank's rows of a global array (numpy or torch): the whole
        array when replicated, else the ``rank``-th of ``data`` equal
        slices along ``dim``."""
        if self.dim is None:
            return x
        per = local_batch_size(x.shape[self.dim], self.mesh)
        index = [slice(None)] * x.ndim
        index[self.dim] = slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)
        return x[tuple(index)]


def batch_sharding(mesh: Mesh, leading_stacked: bool = True) -> Sharding:
    """Train batches split over 'data' on B: dim 1 of a [n_sub, B, ...]
    super-batch with ``leading_stacked``, else dim 0."""
    return Sharding(mesh, 1 if leading_stacked else 0)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Per-device batch for a global batch sharded over the 'data' axis."""
    n_data = mesh.shape[DATA_AXIS]
    if global_batch % n_data:
        raise ValueError(f"global batch {global_batch} not divisible by {n_data}")
    return global_batch // n_data
