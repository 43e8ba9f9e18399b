"""Train state: generator, critic, optimizers, step, from ``sgg/train/state.py``.

:class:`GANTrainState` holds the modules themselves (the reference's
``g_params``/``d_params``/``enc_params`` trees), an :class:`Adam` per module
(its ``*_opt_state``), the step and the generator's EMA. The step updates it
in place. Optimizers follow optax's ``adam`` with β = (0.5, 0.9), eps 1e-8,
written out in tensor ops, behind an optional ``clip_by_global_norm``
(:func:`clip_by_global_norm`, optax's function: scale by max/‖g‖ only when
‖g‖ ≥ max) and an optional schedule that counts updates from 0
(:func:`lr_schedule_fn`, the critic's and the encoder's horizons stretched by
n_critic).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from sgg_torch.config import Config


def make_generator(cfg: Config) -> nn.Module:
    """The generator ``cfg.model.decoder`` names: ``lstm`` (the
    attention-LSTM) or ``transformer`` (the slot decoder)."""
    decoder = cfg.model.decoder
    if decoder == "lstm":
        from sgg_torch.models.generator import AttentionLSTMGenerator

        return AttentionLSTMGenerator.from_config(cfg)
    if decoder == "transformer":
        from sgg_torch.models.transformer import TransformerTripleGenerator

        return TransformerTripleGenerator.from_config(cfg)
    raise ValueError(f"unknown decoder {decoder!r}")


def make_models(cfg: Config) -> tuple[nn.Module, nn.Module]:
    """(generator, critic) from the config."""
    from sgg_torch.models.discriminator import TripleCritic

    return make_generator(cfg), TripleCritic.from_config(cfg)


def lr_schedule_fn(cfg: Config, peak: float, updates_per_step: int
                   ) -> Callable[[int], float] | None:
    """count → lr of one optimizer in float32, or None when both the
    schedule and the warmup are off (a constant lr). ``count`` is the number
    of updates before this one, from 0; ``updates_per_step`` stretches the
    warmup and decay horizons (n_critic for the critic and the encoder). The
    function also takes an integer array of counts and returns their lrs."""
    t = cfg.train
    if t.lr_schedule == "constant" and t.warmup_steps <= 0:
        return None
    if t.lr_schedule not in ("constant", "cosine", "linear"):
        raise ValueError(
            f"unknown train.lr_schedule {t.lr_schedule!r} (constant | cosine | linear)")
    f32 = np.float32
    warm = f32(max(t.warmup_steps, 0) * updates_per_step)
    total = f32(max(t.total_steps, 1) * updates_per_step)
    pk, end, kind = f32(peak), f32(peak * t.lr_final_frac), t.lr_schedule

    def sched(count):
        c = np.asarray(count).astype(f32)
        warm_lr = pk * (c + f32(1.0)) / max(warm, f32(1.0))
        frac = np.clip((c - warm) / max(total - warm, f32(1.0)), f32(0.0), f32(1.0))
        if kind == "cosine":
            lr = end + (pk - end) * f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac))
        elif kind == "linear":
            lr = pk + (end - pk) * frac
        else:
            lr = np.full_like(c, pk)
        lr = np.where(c < warm, warm_lr, lr).astype(f32)
        return float(lr) if lr.ndim == 0 else lr

    # Past max(warm, total) + 1 updates the lr stays where it is.
    sched.horizon = int(max(warm, total)) + 2
    return sched


def global_norm(grads: list[torch.Tensor], groups: list | None = None) -> torch.Tensor:
    """‖g‖ over all tensors, in float32 (``optax.global_norm``). With
    ``groups`` (one per tensor: the process group over whose ranks that
    tensor is split, or None where it is whole on every rank), each split
    tensor's squares are summed over its group, so every part counts once."""
    if groups is None or not any(g is not None for g in groups):
        return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    from sgg_torch.dist.multihost import sum_tensor

    by_group: dict = {}
    for g, group in zip(grads, groups, strict=True):
        by_group.setdefault(group, []).append((g.float() ** 2).sum())
    total = sum(sum(sq) for group, sq in by_group.items() if group is None)
    for group, sq in by_group.items():
        if group is not None:
            total = total + sum_tensor(torch.stack(sq).sum(), group)
    return torch.sqrt(total)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        groups: list | None = None) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients as they are when
    ‖g‖ < max_norm, else each scaled by max_norm / ‖g‖ (``groups`` as
    :func:`global_norm` takes them)."""
    norm = global_norm(grads, groups)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


class Adam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr, b1, b2, eps=1e-8))``
    over a module's parameters, with the config's betas, clip and schedule;
    without a config (``cfg=None``) ``optax.adam(lr)``, as pretraining uses.
    :meth:`update` takes the gradients in ``parameters()`` order and applies
    optax's update in float32 tensor ops (``torch._foreach_*``): mu and nu,
    their bias corrections at the count after this update, then
    p -= lr·mû / (√nû + eps). The count lives on the device, and a scheduled
    lr is read at it from a device table of the
    schedule's float32 values, so the update reads nothing from the host and
    runs alike eagerly and inside a captured CUDA graph. On a placed state
    (``sgg_torch.dist.sharding.place_state``) ``params`` holds each FSDP
    leaf's slice in place of the parameter, the moments hold the same parts
    as their leaves, ``specs`` their specs and ``norm_groups`` the groups
    that the clip's global norm sums each split leaf over."""

    def __init__(self, module: nn.Module, peak: float, cfg: Config | None,
                 updates_per_step: int = 1):
        self.params = [p for p in module.parameters()]
        dev = self.params[0].device
        if cfg is None:  # optax.adam(peak): its default betas, no clip, no schedule
            self.b1, self.b2, self.clip, sched = 0.9, 0.999, 0, None
        else:
            t = cfg.train
            self.b1, self.b2, self.clip = float(t.beta1), float(t.beta2), t.grad_clip
            sched = lr_schedule_fn(cfg, peak, updates_per_step)
        self.eps = 1e-8
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self._count = torch.zeros((), dtype=torch.int64, device=dev)
        self.lr = peak
        self.specs = self.norm_groups = None
        self._lr_table = None
        if sched is not None:
            self._lr_table = torch.from_numpy(sched(np.arange(sched.horizon))).to(dev)

    @property
    def count(self) -> int:
        """Updates so far (a read from the device)."""
        return int(self._count)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> None:
        if self.clip > 0:
            grads = clip_by_global_norm(grads, self.clip, self.norm_groups)
        grads = [g.to(p.dtype) for p, g in zip(self.params, grads, strict=True)]
        lr = self.lr
        if self._lr_table is not None:
            at = self._count.clamp(max=self._lr_table.shape[0] - 1).reshape(1)
            lr = self._lr_table.index_select(0, at).reshape(())
        self._count.add_(1)
        c = self._count.to(torch.float32)
        bc1, bc2 = 1.0 - torch.pow(self.b1, c), 1.0 - torch.pow(self.b2, c)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        step = torch._foreach_div(self.mu, bc1)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(step, den)
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(self.params, step)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @staticmethod
    def moments_of(sd: dict, n: int) -> tuple[list, list]:
        """(mu, nu) of a saved state of ``n`` parameters, lists by position.
        Also reads the layout written before the update was spelled out
        here, ``{"count", "adam": torch.optim.Adam.state_dict()}``, whose
        ``exp_avg`` and ``exp_avg_sq`` are mu and nu (None where a
        parameter had no state yet)."""
        if "adam" not in sd:
            return list(sd["mu"]), list(sd["nu"])
        state = sd["adam"]["state"]
        return ([state[i]["exp_avg"] if i in state else None for i in range(n)],
                [state[i]["exp_avg_sq"] if i in state else None for i in range(n)])

    def load_state_dict(self, sd: dict) -> None:
        """Copies into the live tensors (a captured graph keeps reading
        them); a moment without state (:meth:`moments_of`) is zeroed."""
        self._count.fill_(int(sd["count"]))
        mu, nu = self.moments_of(sd, len(self.params))
        for dst, src in zip(self.mu + self.nu, mu + nu, strict=True):
            if src is None:
                dst.zero_()
            else:
                dst.copy_(src)


def make_optimizers(cfg: Config, generator: nn.Module, critic: nn.Module) -> tuple[Adam, Adam]:
    """(generator's, critic's) optimizers; the critic takes n_critic updates
    per step."""
    t = cfg.train
    return Adam(generator, t.g_lr, cfg, 1), Adam(critic, t.d_lr, cfg, t.n_critic)


def make_encoder_optimizer(cfg: Config, encoder: nn.Module) -> Adam:
    """The encoder updates inside the critic loop: n_critic updates per step."""
    return Adam(encoder, cfg.train.enc_lr, cfg, cfg.train.n_critic)


@dataclass
class GANTrainState:
    step: int
    generator: nn.Module
    critic: nn.Module
    g_tx: Adam
    d_tx: Adam
    # The backbone for pixels-in configs (None when features are
    # precomputed); trained, with its optimizer, only with train.train_encoder.
    encoder: nn.Module | None = None
    enc_tx: Adam | None = None
    # EMA of the generator's state_dict (train.ema_decay > 0).
    g_ema: dict[str, torch.Tensor] | None = None
    # Set by sgg_torch.dist.sharding.place_state: the state is this rank's
    # part of a global one (its state_dict() the parts; gather_state the
    # global one).
    placement: object = None

    def state_dict(self) -> dict:
        def opt(tx):
            return None if tx is None else tx.state_dict()

        return {
            "step": self.step,
            "g_params": self.generator.state_dict(),
            "d_params": self.critic.state_dict(),
            "enc_params": None if self.encoder is None else self.encoder.state_dict(),
            "g_ema": self.g_ema,
            "g_opt": opt(self.g_tx), "d_opt": opt(self.d_tx), "enc_opt": opt(self.enc_tx),
        }

    def tensors(self) -> list[torch.Tensor]:
        """Every live tensor of the state, in a fixed order: the modules'
        parameters and buffers, the optimizers' moments and counts, the EMA.
        Writing into them (as ``sgg_torch.dist.host_local_to_global``'s
        broadcast does) sets the state."""
        out = []
        for mod in (self.generator, self.critic, self.encoder):
            if mod is not None:
                out += list(mod.state_dict().values())
        for tx in (self.g_tx, self.d_tx, self.enc_tx):
            if tx is not None:
                out += tx.mu + tx.nu + [tx._count]
        if self.g_ema is not None:
            out += list(self.g_ema.values())
        return out

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.generator.load_state_dict(sd["g_params"])
        self.critic.load_state_dict(sd["d_params"])
        self.g_tx.load_state_dict(sd["g_opt"])
        self.d_tx.load_state_dict(sd["d_opt"])
        if self.encoder is not None:
            self.encoder.load_state_dict(sd["enc_params"])
        if self.enc_tx is not None:
            self.enc_tx.load_state_dict(sd["enc_opt"])
        if self.g_ema is not None:
            for k, v in sd["g_ema"].items():
                self.g_ema[k].copy_(v)


def create_train_state(cfg: Config, seed: int = 0, enc_params: dict | None = None,
                       device: torch.device | str = "cpu") -> GANTrainState:
    """A fresh state on ``device``, parameters initialized from ``seed``. For
    pixels-in configs ``enc_params`` (a port state_dict) sets the encoder's
    weights, else they are initialized too. The encoder is float whatever
    ``model.quant`` says, as the reference's (``sgg/train/state.py:161-166``):
    the step never trains through int8 rounding, which has no gradient; the
    probe, generate and serve quantize their own copy. Under
    ``train.train_encoder`` it is built ``trainable``, on
    ``sgg_torch.models.encoders.train_route``: a CNN's convs on the library
    conv, which carries the backward (the reference's ``'auto'`` route),
    whatever ``model.use_pallas`` says; the probe, generate, evaluate and
    serve build their own encoder on the kernel route with its weights."""
    from sgg_torch.models.encoders import make_encoder

    m = cfg.model
    train_enc = bool(cfg.train.train_encoder)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator, critic = make_models(cfg)
        encoder = make_encoder(
            m.encoder, use_pallas=m.use_pallas, dtype=m.dtype,
            image_size=cfg.data.image_size, vit_dims=m.vit_dims, moe_experts=m.moe_experts,
            moe_top_k=m.moe_top_k, trainable=train_enc)
    if encoder is not None and enc_params is not None:
        encoder.load_state_dict(enc_params)
    for mod in (generator, critic, encoder):
        if mod is not None:
            mod.to(device)
    g_tx, d_tx = make_optimizers(cfg, generator, critic)
    return GANTrainState(
        step=0, generator=generator, critic=critic, g_tx=g_tx, d_tx=d_tx,
        encoder=encoder,
        enc_tx=(make_encoder_optimizer(cfg, encoder)
                if train_enc and encoder is not None else None),
        g_ema=({k: v.detach().clone() for k, v in generator.state_dict().items()}
               if cfg.train.ema_decay > 0 else None),
    )


def param_count(module: nn.Module | dict) -> int:
    """Number of parameters of a module (or of a state_dict's tensors)."""
    tensors = module.values() if isinstance(module, dict) else module.parameters()
    return sum(int(t.numel()) for t in tensors)
