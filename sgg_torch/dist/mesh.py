"""Meshes and the batch's sharding, from ``sgg/dist/mesh.py``.

The reference's ``('data'[, 'seq'], 'model')`` mesh spans every device of
every process. The port runs one process per rank with one device each
(``torchrun``), so a training mesh is laid over the world of ranks
(:func:`mesh_from_config`): ``data × seq × model`` must be the world, and
rank ``(d · seq + s) · model + m`` sits at data coordinate d, seq coordinate
s and model coordinate m, so that a model group is made of adjacent ranks, as
``jax.make_mesh`` keeps the trailing axis on adjacent devices. The 'seq' axis
exists only when ``seq`` > 1, as in the reference: it sits between 'data'
and 'model' and carries the ViT's patch axis under sequence parallelism
(:mod:`sgg_torch.dist.sequence_parallel`). Each rank holds the process group
of each of its axes: the data axis's (the ranks that share its seq and model
coordinates), the seq axis's and the model axis's; :func:`axis_groups` forms
every group on every rank in one order, as ``torch.distributed.new_group``
requires. A single-process mesh spans a list of this process's devices
(:func:`make_mesh`), as ``make_dp_sampler`` and ``serve --dp`` take it: its
data axis is the first device of each data coordinate's block. Batches split
over ``'data'`` on their batch dimension (dim 1 of a super-batch,
:func:`batch_sharding`); the ranks of one data coordinate take the same rows.
The state's placement over the mesh (TP over ``'model'``, FSDP over
``'data'``) is :mod:`sgg_torch.dist.sharding`'s. ``expert`` > 1 is refused,
naming the later slice that brings it (:func:`refuse_unported_mesh`).
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
    """A ``('data'[, 'seq'], 'model')`` mesh. ``devices``: the devices this
    process drives on the data axis (all of them in one process; this rank's
    one device across ranks); ``rank``: this process's first index on the
    data axis; ``group``: the data axis's process group across ranks (None in
    one process, and on a data axis of 1); ``model_rank`` and
    ``model_group``, ``seq_rank`` and ``seq_group``: the same of the model
    and the seq axes (None on an axis of 1)."""

    data: int
    devices: tuple
    rank: int = 0
    group: object = None
    model: int = 1
    model_rank: int = 0
    model_group: object = None
    seq: int = 1
    seq_rank: int = 0
    seq_group: object = None

    @property
    def axis_names(self) -> tuple:
        """The reference's axis names: 'seq' only when ``seq`` > 1."""
        return (DATA_AXIS, SEQ_AXIS, MODEL_AXIS) if self.seq > 1 else (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        sizes = {DATA_AXIS: self.data, SEQ_AXIS: self.seq, MODEL_AXIS: self.model}
        return {a: sizes[a] for a in self.axis_names}

    def axis_group(self, axis: str):
        """The process group of mesh axis ``axis`` on this rank."""
        return {DATA_AXIS: self.group, SEQ_AXIS: self.seq_group,
                MODEL_AXIS: self.model_group}[axis]

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def refuse_unported_mesh(mesh) -> None:
    """Raise for the mesh options (of a config's ``mesh`` or a
    :class:`MeshSpec`) whose tier is still to port."""
    if mesh.expert > 1:
        raise NotImplementedError(f"expert parallelism (mesh.expert > 1) {_LATER} (ROADMAP "
                                  "A8e); the port's meshes have a data, a seq and a model "
                                  "axis only")


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
    an explicit ``spec.data`` takes the first ``data × seq × model`` of them.
    Its data axis drives the first device of each data coordinate's block of
    ``seq × model``."""
    spec = spec or MeshSpec()
    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    data, model, seq = _data_size(spec, len(devices)), max(1, spec.model), max(1, spec.seq)
    block = seq * model
    return Mesh(data=data, devices=tuple(devices[:data * block:block]), model=model, seq=seq)


def axis_groups(world: int, model: int, seq: int = 1) -> tuple[list, list, list]:
    """(the data axis's groups, one per (s, m), index ``s · model + m``; the
    model axis's, one per (d, s), index ``d · seq + s``; the seq axis's, one
    per (d, m), index ``d · model + m``) over ``world`` ranks laid out as
    ``(d · seq + s) · model + m``. Every rank calls this with the same
    arguments: each group is formed on every rank, in one order (the model
    groups, then the seq groups, then the data groups), as
    ``torch.distributed.new_group`` requires. An axis that is the whole
    world is the world's own group (the data axis of a world of one too);
    any other axis of size 1 forms no group (None)."""
    import torch.distributed as dist

    data = world // (model * seq)

    def rank(d, s, m):
        return (d * seq + s) * model + m

    def groups(size, members, whole):
        if whole:
            return [dist.group.WORLD] * len(members)
        if size == 1:
            return [None] * len(members)
        return [dist.new_group(r) for r in members]

    model_groups = groups(model, [[rank(d, s, m) for m in range(model)]
                                  for d in range(data) for s in range(seq)],
                          1 < model == world)
    seq_groups = groups(seq, [[rank(d, s, m) for s in range(seq)]
                              for d in range(data) for m in range(model)], 1 < seq == world)
    data_groups = groups(data, [[rank(d, s, m) for d in range(data)]
                                for s in range(seq) for m in range(model)], data == world)
    return data_groups, model_groups, seq_groups


def mesh_from_config(mesh_cfg, device) -> Mesh:
    """The training mesh over the world of ranks, this rank on ``device``:
    ``mesh.model`` ranks to a model group, ``mesh.seq`` model groups to a
    data coordinate, ``mesh.data`` = -1 (every data coordinate) or the world
    over ``mesh.seq × mesh.model``; a smaller data axis would leave ranks
    idle and is refused."""
    import torch.distributed as dist

    refuse_unported_mesh(mesh_cfg)
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    model, seq = max(1, mesh_cfg.model), max(1, mesh_cfg.seq)
    data = _data_size(MeshSpec(data=mesh_cfg.data, model=model, seq=seq,
                               expert=getattr(mesh_cfg, "expert", 1)), world)
    if data * seq * model != world:
        n = data * seq * model
        raise ValueError(f"mesh.data={data} x mesh.seq={seq} x mesh.model={model} is a "
                         f"sub-mesh of the {world} ranks; launch {n} ranks (torchrun "
                         f"--nproc_per_node {n}) or set mesh.data=-1")
    if not on:
        return Mesh(data=1, devices=(torch.device(device),))
    ds, m = divmod(dist.get_rank(), model)
    d, s = divmod(ds, seq)
    data_groups, model_groups, seq_groups = axis_groups(world, model, seq)
    return Mesh(data=data, devices=(torch.device(device),), rank=d,
                group=data_groups[s * model + m], model=model, model_rank=m,
                model_group=model_groups[ds], seq=seq, seq_rank=s,
                seq_group=seq_groups[d * model + m])


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
