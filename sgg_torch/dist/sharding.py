"""The train state's placement over a mesh: the experts over ``'expert'``, TP
over ``'model'`` and FSDP/ZeRO over ``'data'``, from ``sgg/dist/sharding.py``.

The rule is the reference's, path-based over the whole train state
(parameters, both Adam moments, the EMA), in this order (:func:`state_sharding`):
  - EP: whenever the mesh has an 'expert' axis, the ``wi`` and ``wo`` of
    every ``moe`` layer ([E, ...]) split dim 0 over ``'expert'`` (the
    router stays replicated), whatever the TP and FSDP switches;
  - TP: a leaf whose path holds ``token_embedding`` ([V, E]) splits dim 0
    over ``'model'``; ``vocab_proj``'s kernel ([E, V]) splits dim 1 and its
    bias [V] dim 0; a dimension that ``'model'`` does not divide stays
    replicated;
  - FSDP: a leaf of at least ``fsdp_min_size`` elements splits over
    ``'data'`` along its largest dimension that ``'data'`` divides, the
    earlier one on a tie; the step is never split;
  - everything else is replicated.
The rule reads the flax layout: a torch ``nn.Linear`` weight is ``[out, in]``
where flax's kernel is ``[in, out]`` (the attention-LSTM's Linears,
``sgg_torch.convert_flax``), so its dimension and tie-break are taken on the
transposed shape and mapped back. Every other module of the port keeps the
flax layout.

XLA inserts the reference's collectives; here they are explicit.
:func:`place_state` turns a global state (the same on every rank) into this
rank's part of it:
  - a TP leaf keeps this rank's slice as the module's own parameter, and the
    module computes over the vocabulary in parallel (:class:`VocabShard`:
    the logits all-gathered, the embedding's partial products all-reduced);
  - an expert leaf keeps this rank's experts as the MoE layer's own
    parameter, and the layer runs expert parallel (its ``ep_mesh`` set:
    ``sgg_torch.dist.expert_parallel``); its gradient is this rank's
    experts' whole, reduced over 'data' alone, and the clip's global norm
    sums its squares over the expert group;
  - an FSDP leaf keeps this rank's slice apart (:attr:`Placement.shards`)
    and the module's parameter empty between updates; the step all-gathers
    it before an update's forward (:meth:`Placement.gathered`), reduces the
    gradients to their slices (:meth:`Placement.reduce`), runs Adam on the
    slices and drops the full copy;
  - each leaf's Adam moments and EMA hold the same part as the leaf.
:func:`gather_state` is its inverse, a global ``state_dict`` as
``GANTrainState.state_dict`` gives it, for checkpoints.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from sgg_torch.dist import multihost as mh
from sgg_torch.dist.mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, Mesh

# Parameter-name fragments that carry a vocabulary dimension: TP targets.
_TP_VOCAB_ROWS = ("token_embedding",)  # [V, E]: dim 0
_TP_VOCAB_COLS = ("vocab_proj",)  # kernel [E, V]: dim 1; bias [V]: dim 0
FSDP_MIN_SIZE = 2 ** 16
TREES = (("g", "generator", "g_tx"), ("d", "critic", "d_tx"), ("enc", "encoder", "enc_tx"))


@dataclass(frozen=True)
class LeafSpec:
    """Where a leaf lives: split over mesh axis ``axis`` on the port
    tensor's dim ``dim`` (the flax layout's ``flax_dim``), or replicated
    (all None)."""

    axis: str | None = None
    dim: int | None = None
    flax_dim: int | None = None


REPLICATED = LeafSpec()


def _tp_dim(names: list[str], shape: tuple, n_model: int) -> int | None:
    if n_model <= 1:
        return None
    joined = "/".join(names)
    for key in _TP_VOCAB_ROWS:
        if key in joined and len(shape) >= 1 and shape[0] % n_model == 0:
            return 0
    for key in _TP_VOCAB_COLS:
        if key in joined:
            if len(shape) == 2 and shape[1] % n_model == 0:
                return 1
            if len(shape) == 1 and shape[0] % n_model == 0:
                return 0
    return None


def _ep_dim(names: list[str], shape: tuple, n_expert: int) -> int | None:
    if n_expert <= 1 or "moe" not in names:
        return None
    if names[-1] in ("wi", "wo") and shape and shape[0] % n_expert == 0:
        return 0
    return None


def _fsdp_dim(shape: tuple, n_data: int, min_size: int) -> int | None:
    if n_data <= 1 or int(np.prod(shape)) < min_size:
        return None
    for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):  # stable: earlier on a tie
        if shape[dim] % n_data == 0 and shape[dim] >= n_data:
            return dim
    return None


def _linear_weights(module: nn.Module) -> set[str]:
    """The state_dict keys of ``module``'s ``nn.Linear`` weights, whose flax
    kernels are their transposes."""
    return {f"{name}.weight" if name else "weight" for name, mod in module.named_modules()
            if isinstance(mod, nn.Linear)}


def module_sharding(module: nn.Module, mesh: Mesh, tp: bool = False, fsdp: bool = False,
                    fsdp_min_size: int = FSDP_MIN_SIZE) -> dict[str, LeafSpec]:
    """{state_dict key: LeafSpec} of one module's tensors by the rule."""
    linear = _linear_weights(module)
    out = {}
    for key, t in module.state_dict().items():
        transposed = key in linear
        shape = tuple(t.shape)[::-1] if transposed else tuple(t.shape)
        fdim = _ep_dim(key.split("."), shape, mesh.expert)
        axis = None if fdim is None else EXPERT_AXIS
        if axis is None and tp:
            fdim = _tp_dim(key.split("."), shape, mesh.model)
            axis = None if fdim is None else MODEL_AXIS
        if axis is None and fsdp:
            fdim = _fsdp_dim(shape, mesh.data, fsdp_min_size)
            axis = None if fdim is None else DATA_AXIS
        if axis is None:
            out[key] = REPLICATED
        else:
            out[key] = LeafSpec(axis, len(shape) - 1 - fdim if transposed else fdim, fdim)
    return out


def state_sharding(state, mesh: Mesh, tp: bool = False, fsdp: bool = False,
                   fsdp_min_size: int = FSDP_MIN_SIZE) -> dict[str, LeafSpec]:
    """The :class:`LeafSpec` of every tensor of a ``GANTrainState``, keyed
    ``{g,d,enc}_params/<key>``, ``{g,d,enc}_opt/{mu,nu}/<key>``,
    ``{g,d,enc}_opt/count``, ``g_ema/<key>`` and ``step`` (keys: the
    modules' state_dict keys). A leaf's moments and EMA share its spec."""
    out = {"step": REPLICATED}
    for tree, mod_name, tx_name in TREES:
        module, tx = getattr(state, mod_name), getattr(state, tx_name)
        if module is None:
            continue
        specs = module_sharding(module, mesh, tp, fsdp, fsdp_min_size)
        out.update({f"{tree}_params/{k}": v for k, v in specs.items()})
        if tx is not None:
            out[f"{tree}_opt/count"] = REPLICATED
            for name, _ in module.named_parameters():
                out[f"{tree}_opt/mu/{name}"] = out[f"{tree}_opt/nu/{name}"] = specs[name]
        if tree == "g" and state.g_ema is not None:
            out.update({f"g_ema/{k}": specs[k] for k in state.g_ema})
    return out


@dataclass(frozen=True)
class VocabShard:
    """A module's vocabulary split over the model axis's ``group``: its
    vocab-sized parameters hold this rank's slice of V."""

    group: object

    def logits(self, local_fn, x: torch.Tensor) -> torch.Tensor:
        """Full logits from ``local_fn(x)``, this rank's ``[..., V/n]``: all-
        gathered over the group, so that masking and sampling downstream run
        on every logit; x's gradient, a partial sum on each rank, is
        all-reduced."""
        return mh.all_gather(local_fn(mh.copy_to(x, self.group)), self.group, -1)

    def embed(self, y: torch.Tensor, table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``y @ table`` over the full V: this rank's columns of y times its
        rows of the table (cast to ``dtype`` as the unsplit product casts
        it), summed in float32 (float64 stays) over the group, then cast to
        ``dtype``."""
        acc = torch.promote_types(dtype, torch.float32)
        part = torch.matmul(mh.split(y, self.group, -1).to(acc), table.to(dtype).to(acc))
        return mh.all_reduce(part, self.group).to(dtype)


def axis_group(mesh: Mesh, spec: LeafSpec):
    """The process group over which a leaf of ``spec`` is split (None when
    it is replicated)."""
    return None if spec.axis is None else mesh.axis_group(spec.axis)


def _set_tensor(module: nn.Module, key: str, value: torch.Tensor) -> None:
    """Point ``module``'s parameter or buffer ``key`` at ``value``."""
    owner_name, _, name = key.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    if name in owner._parameters:
        owner._parameters[name].data = value
    else:
        owner._buffers[name] = value


@dataclass
class ModulePlacement:
    module: nn.Module
    specs: dict  # state_dict key -> LeafSpec
    shards: dict = field(default_factory=dict)  # FSDP key -> this rank's slice


class Placement:
    """A placed state's bookkeeping: the mesh, the specs, each module's FSDP
    slices (``shards``) and what the step needs to gather and reduce."""

    def __init__(self, mesh: Mesh, specs: dict, modules: dict):
        self.mesh, self.specs, self.modules = mesh, specs, modules

    def _of(self, module) -> ModulePlacement | None:
        return next((mp for mp in self.modules.values() if mp.module is module), None)

    def stored(self, module: nn.Module) -> dict:
        """{key: the tensor this rank keeps between steps} of ``module``: the
        FSDP slices, the TP slices and the replicated tensors."""
        mp = self._of(module)
        return {k: mp.shards.get(k, v) for k, v in module.state_dict().items()}

    @contextlib.contextmanager
    def gathered(self, *modules):
        """The FSDP leaves of ``modules`` all-gathered (one bucket per
        module) into the modules' parameters for the block, emptied after."""
        held = []
        try:
            for module in modules:
                mp = None if module is None else self._of(module)
                if mp is None or not mp.shards:
                    continue
                keys = list(mp.shards)
                fulls = mh.gather_tensors([mp.shards[k] for k in keys],
                                          [mp.specs[k].dim for k in keys], self.mesh.group)
                for k, full in zip(keys, fulls):
                    _set_tensor(module, k, full)
                held.append(mp)
            yield
        finally:
            for mp in held:
                for k, shard in mp.shards.items():
                    _set_tensor(mp.module, k, shard.new_empty(0))

    def reduce(self, tx, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each gradient of ``tx``'s parameters averaged over the data axis:
        an FSDP leaf's reduce-scattered to this rank's slice (one bucket),
        every other leaf's all-reduced whole (one bucket). A TP leaf's
        gradient is this rank's slice already."""
        out = list(grads)
        group = self.mesh.group
        if mh.group_size(group) == 1:
            return out
        split = [i for i, s in enumerate(tx.specs) if s.axis == DATA_AXIS]
        whole = [i for i, s in enumerate(tx.specs) if s.axis != DATA_AXIS]
        for i, g in zip(split, mh.scatter_mean_tensors([grads[i] for i in split],
                                                       [tx.specs[i].dim for i in split], group)):
            out[i] = g
        for i, g in zip(whole, mh.pmean([grads[i] for i in whole], group)):
            out[i] = g
        return out


def place_state(state, specs: dict, mesh: Mesh):
    """Turn ``state``, global and equal on every rank, into this rank's part
    of it by ``specs`` (:func:`state_sharding`), in place; returns it with
    ``state.placement`` set. Each optimizer learns its leaves' specs and the
    groups that its global norm sums over."""
    modules = {}
    for tree, mod_name, tx_name in TREES:
        module, tx = getattr(state, mod_name), getattr(state, tx_name)
        if module is None:
            continue
        mp = ModulePlacement(module, {k: specs[f"{tree}_params/{k}"]
                                      for k in module.state_dict()})
        for key, t in module.state_dict().items():
            spec = mp.specs[key]
            if spec.axis is None:
                continue
            part = mh.slice_of(t.detach(), axis_group(mesh, spec), spec.dim).clone()
            if spec.axis == DATA_AXIS:
                mp.shards[key] = part
                _set_tensor(module, key, part.new_empty(0))
            else:
                _set_tensor(module, key, part)
        if any(s.axis == MODEL_AXIS for s in mp.specs.values()):
            module.vocab_shard = VocabShard(mesh.model_group)
        for key, spec in mp.specs.items():  # the MoE layers that hold this rank's experts
            if spec.axis == EXPERT_AXIS:
                module.get_submodule(key.rsplit(".", 1)[0]).ep_mesh = mesh
        if tx is not None:
            names = [n for n, _ in module.named_parameters()]
            tx.specs = [mp.specs[n] for n in names]
            tx.norm_groups = [axis_group(mesh, s) for s in tx.specs]
            for i, (name, spec) in enumerate(zip(names, tx.specs)):
                if spec.axis is None:
                    continue
                g = axis_group(mesh, spec)
                tx.mu[i] = mh.slice_of(tx.mu[i], g, spec.dim).clone()
                tx.nu[i] = mh.slice_of(tx.nu[i], g, spec.dim).clone()
                if spec.axis == DATA_AXIS:
                    tx.params[i] = mp.shards[name]
        if tree == "g" and state.g_ema is not None:
            for k, spec in mp.specs.items():
                if spec.axis is not None:
                    state.g_ema[k] = mh.slice_of(state.g_ema[k], axis_group(mesh, spec),
                                                 spec.dim).clone()
        modules[tree] = mp
    state.placement = Placement(mesh, specs, modules)
    return state


def _gather_dict(tensors: dict, specs: dict, mesh: Mesh) -> dict:
    """{key: the global tensor}: each axis's slices gathered in one bucket."""
    out = dict(tensors)
    for axis in (EXPERT_AXIS, MODEL_AXIS, DATA_AXIS):
        keys = [k for k in tensors if specs[k].axis == axis]
        if keys:
            fulls = mh.gather_tensors([tensors[k] for k in keys], [specs[k].dim for k in keys],
                                      axis_group(mesh, specs[keys[0]]))
            out.update(zip(keys, fulls))
    return out


def gather_state(state) -> dict:
    """The global ``state_dict`` of a placed state, in
    ``GANTrainState.state_dict``'s format (its tensors on the state's
    device), on every rank; every rank of the mesh calls it."""
    pl = state.placement
    if pl is None:
        return state.state_dict()
    sd = {"step": state.step, "g_ema": None, "enc_params": None,
          "g_opt": None, "d_opt": None, "enc_opt": None}
    for tree, mod_name, tx_name in TREES:
        module, tx = getattr(state, mod_name), getattr(state, tx_name)
        if module is None:
            continue
        mp = pl.modules[tree]
        sd[f"{tree}_params"] = _gather_dict(pl.stored(module), mp.specs, pl.mesh)
        if tx is not None:
            names = [n for n, _ in module.named_parameters()]
            mom = _gather_dict({**{("mu", n): m for n, m in zip(names, tx.mu)},
                                **{("nu", n): v for n, v in zip(names, tx.nu)}},
                               {(w, n): mp.specs[n] for w in ("mu", "nu") for n in names},
                               pl.mesh)
            sd[f"{tree}_opt"] = {"count": tx.count, "mu": [mom[("mu", n)] for n in names],
                                 "nu": [mom[("nu", n)] for n in names]}
        if tree == "g" and state.g_ema is not None:
            sd["g_ema"] = _gather_dict(state.g_ema, mp.specs, pl.mesh)
    return sd


def state_bytes(state) -> int:
    """Bytes that this rank keeps between steps: parameters and buffers (an
    FSDP leaf's slice), the Adam moments and counts, the EMA."""
    pl = getattr(state, "placement", None)
    total = 0
    for _, mod_name, tx_name in TREES:
        module, tx = getattr(state, mod_name), getattr(state, tx_name)
        if module is None:
            continue
        held = module.state_dict() if pl is None else pl.stored(module)
        total += sum(t.numel() * t.element_size() for t in held.values())
        if tx is not None:
            total += sum(t.numel() * t.element_size() for t in tx.mu + tx.nu + [tx._count])
    if state.g_ema is not None:
        total += sum(t.numel() * t.element_size() for t in state.g_ema.values())
    return total
