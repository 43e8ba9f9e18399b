"""Meshes and the batch's sharding, from ``sgg/dist/mesh.py``.

The reference's ``('data'[, 'seq'], 'model')`` mesh spans every device of
every process. The port runs one process per rank with one device each
(``torchrun``), so a training mesh is laid over the world of ranks
(:func:`mesh_from_config`): ``data × seq × expert × model`` must be the
world, and rank ``((d · seq + s) · expert + e) · model + m`` sits at data
coordinate d, seq coordinate s, expert coordinate e and model coordinate m,
so that a model group is made of adjacent ranks, as ``jax.make_mesh`` keeps
the trailing axis on adjacent devices. The 'seq' and 'expert' axes exist only
when their size is > 1, as in the reference, between 'data' and 'model' in
that order: 'seq' carries the ViT's patch axis under sequence parallelism
(:mod:`sgg_torch.dist.sequence_parallel`), 'expert' the MoE layers' experts
under expert parallelism (:mod:`sgg_torch.dist.expert_parallel`). Each rank
holds the process group of each of its axes: the data axis's (the ranks that
share its seq, expert and model coordinates), the seq axis's, the expert
axis's and the model axis's; :func:`axis_groups` forms every group on every
rank in one order, as ``torch.distributed.new_group`` requires. A
single-process mesh spans a list of this process's devices
(:func:`make_mesh`), as ``make_dp_sampler`` and ``serve --dp`` take it: its
data axis is the first device of each data coordinate's block. Batches split
over ``'data'`` on their batch dimension (dim 1 of a super-batch,
:func:`batch_sharding`); the ranks of one data coordinate take the same rows,
whatever their seq, expert and model coordinates (the reference's
``batch_sharding``: over 'data' only).
The state's placement over the mesh (TP over ``'model'``, FSDP over
``'data'``, the experts over ``'expert'``) is :mod:`sgg_torch.dist.sharding`'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1  # -1 = every device (rank) not used by the other axes
    model: int = 1
    seq: int = 1
    expert: int = 1


@dataclass(frozen=True)
class Mesh:
    """A ``('data'[, 'seq'][, 'expert'], 'model')`` mesh. ``devices``: the
    devices this process drives on the data axis (all of them in one process;
    this rank's one device across ranks); ``rank``: this process's first
    index on the data axis; ``group``: the data axis's process group across
    ranks (None in one process, and on a data axis of 1); ``model_rank`` and
    ``model_group``, ``seq_rank`` and ``seq_group``, ``expert_rank`` and
    ``expert_group``: the same of the model, seq and expert axes (None on an
    axis of 1)."""

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
    expert: int = 1
    expert_rank: int = 0
    expert_group: object = None

    @property
    def axis_names(self) -> tuple:
        """The reference's axis names: 'seq' and 'expert' only when their
        size is > 1."""
        return ((DATA_AXIS,) + ((SEQ_AXIS,) if self.seq > 1 else ())
                + ((EXPERT_AXIS,) if self.expert > 1 else ()) + (MODEL_AXIS,))

    @property
    def shape(self) -> dict:
        sizes = {DATA_AXIS: self.data, SEQ_AXIS: self.seq, EXPERT_AXIS: self.expert,
                 MODEL_AXIS: self.model}
        return {a: sizes[a] for a in self.axis_names}

    def axis_group(self, axis: str):
        """The process group of mesh axis ``axis`` on this rank."""
        return {DATA_AXIS: self.group, SEQ_AXIS: self.seq_group,
                EXPERT_AXIS: self.expert_group, MODEL_AXIS: self.model_group}[axis]

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _data_size(spec: MeshSpec, n: int) -> int:
    """The data axis of ``spec`` over ``n`` devices, with ``make_mesh``'s
    checks: too few devices, and fixed axes that do not divide ``n``."""
    model, seq, expert = max(1, spec.model), max(1, spec.seq), max(1, spec.expert)
    fixed = seq * expert * model
    if spec.data > 0:
        if spec.data * fixed > n:
            raise ValueError(f"mesh {spec.data}x{seq}x{expert}x{model} needs more than {n} "
                             "devices")
        return spec.data
    if n % fixed:
        raise ValueError(f"seq*expert*model axes {seq}*{expert}*{model} do not divide "
                         f"device count {n}")
    return n // fixed


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device, or the CPU when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def make_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """A single-process mesh over ``devices`` (default :func:`visible_devices`);
    an explicit ``spec.data`` takes the first ``data × seq × expert × model``
    of them. Its data axis drives the first device of each data coordinate's
    block of ``seq × expert × model``."""
    spec = spec or MeshSpec()
    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    data = _data_size(spec, len(devices))
    model, seq, expert = max(1, spec.model), max(1, spec.seq), max(1, spec.expert)
    block = seq * expert * model
    return Mesh(data=data, devices=tuple(devices[:data * block:block]), model=model, seq=seq,
                expert=expert)


def axis_groups(world: int, model: int, seq: int = 1, expert: int = 1) -> dict[str, list]:
    """{axis: its groups, one for each coordinate of the other axes, in rank
    order of the first member, as :func:`axis_members` lists them} over
    ``world`` ranks laid out as ``((d · seq + s) · expert + e) · model + m``.
    Every rank calls this with the same arguments: each group is formed on
    every rank, in one order (the model groups, then the seq groups, the
    expert groups and the data groups), as ``torch.distributed.new_group``
    requires. An axis that is the whole
    world is the world's own group (the data axis of a world of one too);
    any other axis of size 1 forms no group (None)."""
    import torch.distributed as dist

    sizes = {MODEL_AXIS: model, SEQ_AXIS: seq, EXPERT_AXIS: expert,
             DATA_AXIS: world // (model * seq * expert)}
    out = {}
    for axis in (MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS, DATA_AXIS):
        members = axis_members(world, model, seq, expert, axis)
        if sizes[axis] == world and (axis == DATA_AXIS or world > 1):
            out[axis] = [dist.group.WORLD] * len(members)
        elif sizes[axis] == 1:
            out[axis] = [None] * len(members)
        else:
            out[axis] = [dist.new_group(r) for r in members]
    return out


_ORDER = (DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)


def coords(rank: int, model: int, seq: int = 1, expert: int = 1) -> dict[str, int]:
    """{axis: the coordinate} of ``rank`` in the layout
    ``((d · seq + s) · expert + e) · model + m``."""
    de_s, m = divmod(rank, model)
    ds, e = divmod(de_s, expert)
    d, s = divmod(ds, seq)
    return {DATA_AXIS: d, SEQ_AXIS: s, EXPERT_AXIS: e, MODEL_AXIS: m}


def axis_members(world: int, model: int, seq: int, expert: int, axis: str) -> list[list]:
    """The ranks of each group of ``axis``: one list for each coordinate of
    the other axes (in rank order of its first member), its ranks in the
    axis's order."""
    groups: dict = {}
    for r in range(world):
        c = coords(r, model, seq, expert)
        groups.setdefault(tuple(c[a] for a in _ORDER if a != axis), []).append(r)
    return list(groups.values())


def mesh_from_config(mesh_cfg, device) -> Mesh:
    """The training mesh over the world of ranks, this rank on ``device``:
    ``mesh.model`` ranks to a model group, ``mesh.expert`` model groups to
    an expert group, ``mesh.seq`` expert groups to a data coordinate,
    ``mesh.data`` = -1 (every data coordinate) or the world over ``mesh.seq
    × mesh.expert × mesh.model``; a smaller data axis would leave ranks idle
    and is refused."""
    import torch.distributed as dist

    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    model, seq = max(1, mesh_cfg.model), max(1, mesh_cfg.seq)
    expert = max(1, getattr(mesh_cfg, "expert", 1))
    data = _data_size(MeshSpec(data=mesh_cfg.data, model=model, seq=seq, expert=expert), world)
    n = data * seq * expert * model
    if n != world:
        raise ValueError(f"mesh.data={data} x mesh.seq={seq} x mesh.expert={expert} x "
                         f"mesh.model={model} is a sub-mesh of the {world} ranks; launch {n} "
                         f"ranks (torchrun --nproc_per_node {n}) or set mesh.data=-1")
    if not on:
        return Mesh(data=1, devices=(torch.device(device),))
    rank = dist.get_rank()
    c = coords(rank, model, seq, expert)
    groups = axis_groups(world, model, seq, expert)

    def mine(axis):
        members = axis_members(world, model, seq, expert, axis)
        return groups[axis][next(i for i, g in enumerate(members) if rank in g)]

    return Mesh(data=data, devices=(torch.device(device),), rank=c[DATA_AXIS],
                group=mine(DATA_AXIS), model=model, model_rank=c[MODEL_AXIS],
                model_group=mine(MODEL_AXIS), seq=seq, seq_rank=c[SEQ_AXIS],
                seq_group=mine(SEQ_AXIS), expert=expert, expert_rank=c[EXPERT_AXIS],
                expert_group=mine(EXPERT_AXIS))


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
