"""The WGAN-GP train step, from ``sgg/train/step.py``, on one device or data
parallel over ranks.

One step is ``n_critic`` critic updates (each a forward, the gradient penalty's
double backward and an Adam update), one generator update through the
straight-through Gumbel decode, and the generator's EMA. The reference fuses
these into one compiled program; here they run eagerly and update the
:class:`~sgg_torch.train.state.GANTrainState` in place. Three critic branches,
as in the reference:
  - precomputed features: the frozen generator samples all n_critic fakes in
    one batched forward over n_critic·B rows;
  - ``train.train_encoder``: each critic iteration differentiates the critic
    loss jointly with respect to the critic and the encoder (the ViT's
    attention through ``flash_attention``'s backward; VGG-19's and
    ResNet-50's convs on the library conv, the state's encoder built on
    ``train_route``, and ResNet-50's batch-norm parameters through
    ``fold_batchnorm``; with MoE blocks,
    ``model.moe_experts``, plus ``train.moe_aux_coef`` times their mean
    load-balance term, reported as ``moe_aux``); the fake conditions on
    the features without gradient, and the generator update conditions on
    the updated encoder, without gradient;
  - a frozen encoder: features and fakes without gradient.
``train.grad_accum`` splits each update's batch into equal microbatches and
averages their losses, aux values and gradients. ``train.estimator`` picks the
generator update's gradient: ``gumbel`` differentiates the critic's score of
the straight-through sample; ``reinforce`` draws exact samples
(``detach_sample``) and differentiates the score-function surrogate
(:func:`~sgg_torch.train.losses.reinforce_generator_loss`, with
``train.rl_entropy``), the critic's score a reward without gradient.

All noise is an input (:func:`noise_shapes` gives its layout): the fakes' z and
Gumbel draws, the penalty's ε and the generator update's draws, per
microbatch, and optionally ``tau``, the step's Gumbel temperature as a 0-dim
float32 tensor. Without it the step draws from a ``torch.Generator`` seeded
from ``train.seed`` and the step (``step_fn.inputs``). The step reads nothing
else from the host that changes between steps (the optimizers keep their
counts on the device) and does not wait for the device, so one step can be
captured in a CUDA graph and replayed
(:func:`sgg_torch.data.pipeline.make_fused_device_stepper`).

Data parallel (``group``, a ``torch.distributed`` process group): each rank
steps on its own rows of the batch and the state stays equal on every rank,
since the gradients are averaged over the ranks where the reference calls
``maybe_pmean``: the critic's in each critic iteration (with
``train_encoder`` the encoder's with them, before ``enc_gnorm``), the
generator's, and the metrics (``sgg_torch.dist.pmean``: one bucket each).
The noise is per rank, as the reference folds the shard's index into its key:
rank r's generator seed adds ``r · RANK_SEED_STRIDE``, so rank 0, and a world
of one, draws what the single-device step draws.

The gspmd step (``mesh``, ``make_train_step_gspmd``'s counterpart) runs on a
state placed over a ``('data'[, 'seq'][, 'expert'], 'model')`` mesh by
``sgg_torch.dist.sharding.place_state``. Its body is the single-device step
on global arrays: the noise is the single-device step's draw at the global
batch B · data (no rank in the seed), and each rank takes its data
coordinate's rows of it and of the batch (the ranks that share a data
coordinate take the same rows). Under TP the generator and critic compute over the
vocabulary in parallel (``VocabShard``). Each update all-gathers the FSDP
leaves of the modules that it runs before its forward
(``Placement.gathered``) and drops the full copies after it; its gradients
are averaged over the data axis, an FSDP leaf's reduce-scattered to this
rank's slice, and Adam runs on the slices. A TP leaf's gradient is this
rank's slice already. The clip's global norm and ``enc_gnorm`` sum a split
leaf's squares over its axis's group. The EMA updates the stored parts.

Sequence parallelism (``model.sp_mode`` 'ring' or 'ulysses', ``sgg/train/
step.py:112-144``) acts on the gspmd step of a vit_b16 encoder: the ViT's
attention layers attend through ``sgg_torch.dist.sequence_parallel.
make_sp_attention`` over the mesh's 'seq' axis, or its 'model' axis when the
mesh has none (there it shares the group of TP over the vocabulary). The
ranks of the axis take the same rows; each runs the attention on its S/n
patch rows and everything else on all of them, so the gradients stay equal
over the axis and are reduced over 'data' alone. Without a mesh, and on the
data-parallel step, ``sp_mode`` is ignored, as the reference's ``sp_mesh``
is None there.

Pipeline parallelism (``model.pp_microbatches``, ``sgg/train/step.py:116-
142``) acts on the gspmd step of a frozen vit_b16 encoder: its features come
from ``sgg_torch.dist.pipeline_parallel.pipeline_vit_features``, the block
stack in stages over the mesh's 'model' axis, without gradient; with a 'seq'
axis and ``sp_mode`` each seq rank carries its S/n patch rows through the
stages and the blocks attend by the ring or Ulysses over 'seq' (DP×SP×PP).
The reference's refusals stand: ``sp_mode`` with PP on a mesh without
'seq', PP with expert-parallel MoE, and ``train.train_encoder`` with PP.

Expert parallelism (``mesh.expert`` > 1 with ``model.moe_experts``,
``sgg/train/step.py:144-170``) is on whenever the mesh has an 'expert' axis
and the encoder has MoE layers: the step refuses experts that the axis does
not divide (the reference's message) and a state whose MoE layers were not
placed over the axis. ``place_state`` leaves each MoE layer this rank's
experts and sets it to run ``sgg_torch.dist.expert_parallel.moe_forward_ep``
over the 'expert' axis, whose ranks take the same rows; an expert's gradient
is complete on its rank and, like every other gradient, is averaged over
'data' alone; ``moe_aux`` is the reference's EP term.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from sgg_torch.config import Config
from sgg_torch.dist.mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS
from sgg_torch.dist.multihost import pmean
from sgg_torch.dist.pipeline_parallel import pipeline_vit_features
from sgg_torch.dist.sequence_parallel import make_sp_attention, sp_encoder
from sgg_torch.models.encoders import features_and_aux, normalize_for
from sgg_torch.models.generator import TRIPLE_LEN
from sgg_torch.models.moe import MoEMLP
from sgg_torch.train.losses import critic_loss, generator_loss, reinforce_generator_loss
from sgg_torch.train.state import GANTrainState, global_norm
from sgg_torch.utils.gumbel import sample_gumbel
from sgg_torch.utils.profiling import annotate

# Rank r's noise seed is rank 0's plus r times this: below 2^32, as the CPU's
# generator keeps only a seed's low 32 bits.
RANK_SEED_STRIDE = 1_000_000_007
# How far ``warm_autograd`` puts the calling thread's autograd sequence number
# above the device thread's: more than the nodes one gradient penalty's
# create_graph backward records there (138 for the critic of 3 layers).
SEQUENCE_MARGIN = 1 << 14
_warmed: set = set()  # the devices that warm_autograd has seen in this process


def warm_autograd(device) -> int:
    """Put the calling thread's autograd sequence number ``SEQUENCE_MARGIN``
    above the one of ``device``'s autograd thread, once per device and
    process; return how many nodes that took (0 when done before).

    The engine runs a backward on a CUDA device in a thread of its own, and
    the nodes that the gradient penalty's ``create_graph`` backward records
    take their sequence numbers from that thread's counter, which starts at 0
    in a new process, as the calling thread's does. Among the nodes that are
    ready together the engine runs the higher number first, so in a process's
    first critic update those nodes interleave with the forward's, and a
    parameter whose gradient gathers terms from both (the critic's first
    LayerNorm scale) sums them in another order than in every later update,
    where the calling thread's numbers lie above. Nodes recorded here (a tiny
    backward on the device, then views of a scalar on the CPU) touch no
    tensor of the state. On the CPU the backward runs in the calling thread,
    and nothing needs doing."""
    device = torch.device(device)
    if device in _warmed:
        return 0
    _warmed.add(device)
    x = torch.ones(1, device=device, requires_grad=True)
    (g,) = torch.autograd.grad((x * x).sum(), x, create_graph=True)
    target = g.grad_fn._sequence_nr() + SEQUENCE_MARGIN  # numbered on the device's thread
    z = torch.zeros((), requires_grad=True)
    n = max(0, target - z.view(()).grad_fn._sequence_nr())
    for _ in range(n):
        z.view(())
    return n


def refuse_unported(cfg: Config) -> None:
    """Raise the reference's errors for training options that it refuses."""
    m, t = cfg.model, cfg.train
    if t.estimator not in ("gumbel", "reinforce"):
        raise ValueError(f"unknown train.estimator {t.estimator!r} (expected 'gumbel' or "
                         "'reinforce')")
    if t.train_encoder and m.encoder == "precomputed":
        raise ValueError("train.train_encoder requires an end-to-end encoder config "
                         "(model.encoder != 'precomputed')")


def tau_schedule(cfg: Config, step: int) -> float:
    """Gumbel temperature max(tau_min, tau0·exp(−rate·step)), in float32."""
    t = cfg.train
    f32 = np.float32
    tau = np.maximum(f32(t.tau_min), f32(t.tau0) * np.exp(f32(-t.tau_anneal) * f32(step)))
    return float(tau)


def _accum_vg(vg_fn: Callable, batch: tuple, accum: int):
    """``vg_fn(microbatch, m) → (loss, aux, grads)`` over ``accum`` equal
    splits of the leading batch axis, averaged; ``accum == 1`` is one call on
    the whole batch."""
    if accum == 1:
        return vg_fn(batch, 0)
    n = batch[0].shape[0] // accum
    total = None
    for m in range(accum):
        loss, aux, grads = vg_fn(tuple(x[m * n:(m + 1) * n] for x in batch), m)
        if total is None:
            total = [loss, dict(aux), list(grads)]
        else:
            total[0] = total[0] + loss
            total[1] = {k: total[1][k] + v for k, v in aux.items()}
            total[2] = [a + g for a, g in zip(total[2], grads)]
    inv = 1.0 / accum
    loss, aux, grads = total
    return loss * inv, {k: v * inv for k, v in aux.items()}, [g * inv for g in grads]


def noise_shapes(cfg: Config, B: int) -> dict[str, tuple]:
    """The shape of each noise tensor of one step for batch B.

    ``fake_z`` [nc, Af, Bf, Z] and ``fake_gumbel`` [nc, Af, Bf, 3, V]: the
    critic loop's fakes (Af, Bf = accum, B / accum with ``train_encoder``,
    whose fakes are drawn per microbatch; else 1, B; precomputed features
    sample all nc·B rows in one forward, in that order). ``gp_eps``
    [nc, accum, B / accum, 1, 1]: ε per microbatch. ``gen_z`` [accum,
    B / accum, Z] and ``gen_gumbel`` [accum, B / accum, 3, V]: the generator
    update's draws."""
    nc, A = cfg.train.n_critic, max(1, int(cfg.train.grad_accum))
    Z, V, Bm = cfg.model.noise_dim, cfg.model.vocab_size, B // A
    Af, Bf = (A, Bm) if cfg.train.train_encoder else (1, B)
    return {"fake_z": (nc, Af, Bf, Z), "fake_gumbel": (nc, Af, Bf, TRIPLE_LEN, V),
            "gp_eps": (nc, A, Bm, 1, 1), "gen_z": (A, Bm, Z),
            "gen_gumbel": (A, Bm, TRIPLE_LEN, V)}


def draw_noise(cfg: Config, B: int, generator: torch.Generator, device) -> dict:
    """One step's noise from ``generator``: z in the model dtype (normal),
    Gumbel float32, ε in the model dtype (uniform [0, 1))."""
    dt, out = cfg.model.dtype, {}
    for name, shape in noise_shapes(cfg, B).items():
        if name.endswith("_gumbel"):
            out[name] = sample_gumbel(shape, generator, device=device)
        elif name == "gp_eps":
            out[name] = torch.rand(shape, generator=generator, device=device).to(dt)
        else:
            out[name] = torch.randn(shape, generator=generator, device=device).to(dt)
    return out


def _whole(*modules):
    """Off a placed state every module is whole already."""
    return contextlib.nullcontext()


def local_rows(cfg: Config, noise: dict, B: int, index: int) -> dict:
    """Rows ``index · B`` to ``(index + 1) · B`` of one step's noise drawn at
    a global batch (``noise_shapes``' layout, its batch axes flattened in
    order): this data coordinate's noise, in the layout of batch B."""
    out = {k: v for k, v in noise.items() if k == "tau"}
    for name, shape in noise_shapes(cfg, B).items():
        lead = 0 if name.startswith("gen_") else 1
        rows = noise[name].flatten(lead, lead + 1).narrow(lead, index * B, B)
        out[name] = rows.unflatten(lead, shape[lead:lead + 2])
    return out


def make_step_fn(cfg: Config, step_mask=None, group=None, mesh=None) -> Callable[..., dict]:
    """Build ``step(state, batch, noise=None) → metrics``, with
    ``step.inputs(step, B, device)``: the noise and ``tau`` that the step
    draws at ``step`` when it is given none. With ``group`` (a process
    group; every rank of it calls the step alike) the step is data parallel
    over its ranks, ``batch`` this rank's rows. With ``mesh`` (a training
    mesh; the state placed over it) the step is the gspmd step, ``batch``
    this data coordinate's rows, ``noise`` (and ``step.inputs``) the global
    batch's.

    ``batch``: ``features`` [n_critic+1, B, R, F] (or ``images`` uint8
    [n_critic+1, B, H, W, 3] for pixels-in configs) and ``triples`` int
    [n_critic+1, B, 3] on the state's device. Sub-batches 0..n_critic-1 feed
    the critic updates, the last one the generator update. The state is
    updated in place; the metrics (0-dim tensors) are the last critic
    iteration's aux values, the generator's and ``tau``."""
    t, m = cfg.train, cfg.model
    sp_on = mesh is not None and bool(m.sp_mode) and m.encoder == "vit_b16"
    pp_on = mesh is not None and bool(m.pp_microbatches) and m.encoder == "vit_b16"
    if sp_on and pp_on and SEQ_AXIS not in mesh.axis_names:
        raise ValueError(
            "sp_mode and pp_microbatches both set on a mesh without a 'seq' axis: they would "
            "contend for the single 'model' axis. Set mesh.seq > 1 (MeshSpec.seq) to compose "
            "DP×SP×PP on a ('data','seq','model') mesh.")
    ep_on = mesh is not None and m.moe_experts > 0 and EXPERT_AXIS in mesh.axis_names
    if pp_on and ep_on:
        raise ValueError(
            "pp_microbatches with expert-parallel MoE is unsupported: the pipeline's shard_map "
            "cannot nest the expert-exchange shard_map. Drop the 'expert' mesh axis (experts "
            "then run data-parallel, replicated) or disable PP.")
    if ep_on and m.moe_experts % mesh.expert:
        raise ValueError(f"num_experts {m.moe_experts} not divisible by '{EXPERT_AXIS}' axis "
                         f"size {mesh.expert}")
    refuse_unported(cfg)
    if pp_on and t.train_encoder:
        raise ValueError(
            "train.train_encoder is incompatible with model.pp_microbatches: the pipeline path "
            "bakes a stop_gradient at the encoder stage boundary")
    sp_attn = None
    if sp_on and not pp_on:
        sp_attn = make_sp_attention(
            mesh, m.sp_mode, SEQ_AXIS if SEQ_AXIS in mesh.axis_names else MODEL_AXIS)
    V, nc, dtype = m.vocab_size, t.n_critic, m.dtype
    accum = max(1, int(t.grad_accum))
    mask = None if step_mask is None else torch.as_tensor(np.asarray(step_mask), dtype=torch.bool)
    train_enc = bool(t.train_encoder)
    moe_on = m.moe_experts > 0
    reinforce = t.estimator == "reinforce"
    masks: dict = {}  # the step mask on each device, copied there once
    gspmd = mesh is not None
    if gspmd:
        group = mesh.group  # the data axis's (None on a data axis of one)
    n_data = mesh.data if gspmd else 1
    rank = 0 if gspmd or group is None else torch.distributed.get_rank(group)

    def maybe_pmean(tensors: list) -> list:
        return tensors if group is None else pmean(list(tensors), group)

    def tau_at(step: int, device) -> torch.Tensor:
        return torch.full((), tau_schedule(cfg, step), dtype=torch.float32, device=device)

    def inputs(step: int, B: int, device) -> dict:
        """The noise and tau of ``step``: its noise from a ``torch.Generator``
        seeded ``train.seed``·1,000,003 + step (+ rank · RANK_SEED_STRIDE;
        on the gspmd step, drawn at the global batch B · data)."""
        seed = int(t.seed) * 1_000_003 + step + rank * RANK_SEED_STRIDE
        generator = torch.Generator(device=device).manual_seed(seed)
        return {**draw_noise(cfg, B * n_data, generator, device), "tau": tau_at(step, device)}

    def step_fn(state: GANTrainState, batch: dict, noise: dict | None = None) -> dict:
        if ep_on and state.encoder is not None and any(
                isinstance(x, MoEMLP) and x.ep_mesh is None for x in state.encoder.modules()):
            raise ValueError(f"the mesh has an '{EXPERT_AXIS}' axis but the MoE layers do not "
                             "hold their experts over it: place the state with "
                             "sgg_torch.dist.sharding.place_state first")
        with sp_encoder(state.encoder, sp_attn):
            return one_step(state, batch, noise)

    def one_step(state: GANTrainState, batch: dict, noise: dict | None) -> dict:
        gen, critic, encoder = state.generator, state.critic, state.encoder
        data = batch["features"] if encoder is None else batch["images"]
        triples = batch["triples"].long()
        dev, B = data.device, data.shape[1]
        if dev.type == "cuda":
            warm_autograd(dev)
        if accum > 1 and B % accum:
            raise ValueError(f"train.grad_accum={accum} must divide the batch ({B})")
        if noise is None:
            noise = inputs(state.step, B, dev)
        if gspmd:
            noise = local_rows(cfg, noise, B, mesh.rank)
        noise = {k: v.to(dev) for k, v in noise.items()}
        tau = noise["tau"] if "tau" in noise else tau_at(state.step, dev)
        if mask is not None and dev not in masks:
            masks[dev] = mask.to(dev)
        step_mask_d = None if mask is None else masks[dev]
        pl = state.placement
        full = _whole if pl is None else pl.gathered

        def reduce(tx, grads: list) -> list:
            return maybe_pmean(grads) if pl is None else pl.reduce(tx, grads)

        def sample_fake(feats, z, g):
            return gen(feats, z, g, tau=tau, hard=t.hard, step_mask=step_mask_d)["soft"]

        def enc_feats(images):
            x = normalize_for(m.encoder, images)
            if pp_on:  # the block stack pipelined over 'model', without gradient
                return pipeline_vit_features(
                    encoder, x, mesh, num_microbatches=m.pp_microbatches, batch_axis=DATA_AXIS,
                    seq_axis=SEQ_AXIS if sp_on else None, sp_mode=m.sp_mode or "ring").to(dtype)
            return encoder(x).to(dtype)

        def enc_feats_aux(images):
            feats, aux = features_and_aux(encoder, normalize_for(m.encoder, images))
            return feats.to(dtype), aux

        d_params = list(critic.parameters())

        def d_loss(feats, real_ids, fake, eps):
            real = F.one_hot(real_ids, V).to(fake.dtype)
            return critic_loss(critic, feats, real, fake, eps, gp_lambda=t.gp_lambda,
                               drift=t.drift)

        def critic_update(i: int, fakes) -> dict:
            eps = noise["gp_eps"][i]
            if train_enc:
                enc_params = list(encoder.parameters())

                def vg(mb, k):
                    raw_mb, real_mb = mb
                    with annotate("encoder"):
                        if moe_on:
                            feats, moe_aux = enc_feats_aux(raw_mb)
                        else:
                            feats = enc_feats(raw_mb)
                    with torch.no_grad():
                        fake = sample_fake(feats.detach(), noise["fake_z"][i, k],
                                           noise["fake_gumbel"][i, k])
                    loss, aux = d_loss(feats, real_mb, fake, eps[k])
                    if moe_on:  # the router's load balance, in the encoder's objective
                        loss = loss + t.moe_aux_coef * moe_aux
                        aux = {**aux, "moe_aux": moe_aux}
                    return loss, aux, torch.autograd.grad(loss, d_params + enc_params)

                _, d_aux, grads = _accum_vg(vg, (data[i], triples[i]), accum)
                if pl is None:
                    grads = maybe_pmean(grads)
                    d_grads, enc_grads = grads[:len(d_params)], grads[len(d_params):]
                else:
                    d_grads = reduce(state.d_tx, grads[:len(d_params)])
                    enc_grads = reduce(state.enc_tx, grads[len(d_params):])
                d_aux["enc_gnorm"] = global_norm(enc_grads, state.enc_tx.norm_groups)
                state.d_tx.update(d_grads)
                state.enc_tx.update(enc_grads)
                return d_aux
            if encoder is None:
                feats, fake = data[i], fakes[i]
            else:
                with torch.no_grad():
                    with annotate("encoder"):
                        feats = enc_feats(data[i])
                    fake = sample_fake(feats, noise["fake_z"][i, 0], noise["fake_gumbel"][i, 0])

            def vg(mb, k):
                loss, aux = d_loss(*mb, eps[k])
                return loss, aux, torch.autograd.grad(loss, d_params)

            _, d_aux, d_grads = _accum_vg(vg, (feats, triples[i], fake), accum)
            state.d_tx.update(reduce(state.d_tx, d_grads))
            return d_aux

        def generator_update() -> dict:
            if encoder is None:
                feats_g = data[nc]
            else:  # the updated encoder with train_encoder, without gradient
                with torch.no_grad():
                    feats_g = enc_feats(data[nc])
            g_params = list(gen.parameters())

            def g_vg(mb, k):
                if reinforce:
                    out = gen(mb[0], noise["gen_z"][k], noise["gen_gumbel"][k], tau=tau,
                              hard=True, step_mask=step_mask_d, detach_sample=True)
                    loss, aux = reinforce_generator_loss(critic, mb[0], out["soft"],
                                                         out["log_prob"], logits=out["logits"],
                                                         entropy_coef=t.rl_entropy)
                else:
                    fake = sample_fake(mb[0], noise["gen_z"][k], noise["gen_gumbel"][k])
                    loss, aux = generator_loss(critic, mb[0], fake)
                grads = torch.autograd.grad(loss, g_params, allow_unused=True)
                return loss, aux, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(g_params, grads)]

            _, g_aux, g_grads = _accum_vg(g_vg, (feats_g,), accum)
            state.g_tx.update(reduce(state.g_tx, g_grads))
            return g_aux

        # ---- n_critic critic updates ----
        # The generator (and a frozen encoder) only runs forward here; the
        # critic (and a trained encoder) is gathered anew for each update.
        # The regions carry the reference's scope names (``annotate``).
        with full(gen, None if train_enc else encoder):
            fakes = None
            if encoder is None:
                with annotate("sample_fakes_batched"), torch.no_grad():
                    fakes = sample_fake(
                        data[:nc].reshape(nc * B, *data.shape[2:]),
                        noise["fake_z"].reshape(nc * B, -1),
                        noise["fake_gumbel"].reshape(nc * B, TRIPLE_LEN, V),
                    ).reshape(nc, B, TRIPLE_LEN, V)
            for i in range(nc):
                with annotate("critic_update"), full(critic, encoder if train_enc else None):
                    d_aux = critic_update(i, fakes)

        # ---- one generator update on the last sub-batch ----
        with annotate("generator_update"), full(gen, critic, encoder):
            g_aux = generator_update()

        if t.ema_decay > 0:
            d = np.float32(t.ema_decay)
            keep, take = float(d), float(np.float32(1.0) - d)
            held = gen.state_dict() if pl is None else pl.stored(gen)
            with torch.no_grad():
                for k, p in held.items():
                    e = state.g_ema[k]
                    e.copy_((e * keep + p * take).to(e.dtype))

        state.step += 1
        metrics = {k: v.detach() for k, v in {**d_aux, **g_aux}.items()}
        metrics["tau"] = tau
        return dict(zip(metrics, maybe_pmean(metrics.values())))

    step_fn.inputs = inputs
    return step_fn
