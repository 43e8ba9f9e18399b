"""Weights between the reference's flax param trees and the port.

Generator: the flax tree is the nested dict of numpy arrays that
``sgg.train.checkpoint`` restores as ``g_params`` (or ``g_ema``). A flax
``Dense`` kernel is ``[in, out]``, the transpose of a torch ``Linear``
weight. The TF1 LSTM kernel stays one ``[I+H, 4H]`` matrix in i, j, f, o
order, and the embedding is ``[V, E]`` in both.

Encoders (VGG-19, ResNet-50, ViT-B/16), the transformer generator and the
critic: the port's modules keep the flax names and layouts (HWIO kernels, Dense kernels
[in, out], float32 BN and LayerNorm vectors), so a leaf's path joined with
``.`` is its state_dict key (a MoE ViT block's ``moe/router`` [M, E],
``moe/wi`` [E, M, H] and ``moe/wo`` [E, H, M] too); VGG's flat flax names
``conv1_1/kernel`` become ``conv1_1.kernel``. Given the port module's own state_dict (``like``), the
conversion raises on a missing or unknown leaf, or on a shape that differs.
``encoder_params.npz`` files (``::``-joined keys, as
``sgg.train.pretrain.save_params_npz`` writes them) read with numpy alone.
:func:`train_state_from_flax` builds a port train state from a reference
train state's parameters, with fresh optimizers.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

# (flax path, port state_dict key, transposed)
_GENERATOR_MAP = (
    (("AdditiveAttention_0", "feat_proj", "kernel"), "attention.feat_proj.weight", True),
    (("AdditiveAttention_0", "state_proj", "kernel"), "attention.state_proj.weight", True),
    (("AdditiveAttention_0", "state_proj", "bias"), "attention.state_proj.bias", False),
    (("AdditiveAttention_0", "score", "kernel"), "attention.score.weight", True),
    (("TF1LSTMCell_0", "kernel"), "cell.kernel", False),
    (("TF1LSTMCell_0", "bias"), "cell.bias", False),
    (("token_embedding",), "token_embedding", False),
    (("init_c", "kernel"), "init_c.weight", True),
    (("init_c", "bias"), "init_c.bias", False),
    (("init_h", "kernel"), "init_h.weight", True),
    (("init_h", "bias"), "init_h.bias", False),
    (("deep_out", "kernel"), "deep_out.weight", True),
    (("deep_out", "bias"), "deep_out.bias", False),
    (("vocab_proj", "kernel"), "vocab_proj.weight", True),
    (("vocab_proj", "bias"), "vocab_proj.bias", False),
)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(g_params: dict) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``AttentionLSTMGenerator`` params → ``AttentionLSTMGenerator``
    state_dict of the port. Raises on a missing or an unknown leaf."""
    flat = {path: np.asarray(v) for path, v in _leaves(g_params)}
    known = {path for path, _, _ in _GENERATOR_MAP}
    unknown = sorted("/".join(p) for p in flat if p not in known)
    missing = sorted("/".join(p) for p in known if p not in flat)
    if unknown or missing:
        raise ValueError(f"generator tree mismatch: unknown {unknown}, missing {missing}")
    sd = OrderedDict()
    for path, key, transposed in _GENERATOR_MAP:
        a = flat[path]
        sd[key] = torch.from_numpy(np.array(a.T if transposed else a, order="C"))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    """The reverse of :func:`flax_to_state_dict`: a nested dict of numpy arrays."""
    tree: dict = {}
    for path, key, transposed in _GENERATOR_MAP:
        a = sd[key].detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a.T if transposed else a)
    return tree


def _check_like(sd: dict, like: dict, what: str) -> None:
    unknown = sorted(k for k in sd if k not in like)
    missing = sorted(k for k in like if k not in sd)
    if unknown or missing:
        raise ValueError(f"{what} tree mismatch: unknown {unknown}, missing {missing}")
    bad = sorted(k for k in sd if tuple(sd[k].shape) != tuple(like[k].shape))
    if bad:
        raise ValueError(f"{what} tree mismatch: shapes differ at {bad}")


def tree_to_state_dict(tree: dict, like: dict | None = None,
                       what: str = "flax") -> "OrderedDict[str, torch.Tensor]":
    """A flax param tree (with or without the outer ``{'params': …}``) →
    the state_dict of a port module that keeps the flax names and layouts:
    float32 leaves keyed by their path joined with ``.``. With ``like`` (the
    port module's own state_dict), raises on a missing or unknown leaf or a
    shape that differs."""
    tree = tree.get("params", tree)
    sd = OrderedDict()
    for path, v in _leaves(tree):
        key = ".".join(p.replace("/", ".") for p in path)
        sd[key] = torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
    if like is not None:
        _check_like(sd, like, what)
    return sd


def state_dict_to_tree(sd: dict) -> dict:
    """The reverse of :func:`tree_to_state_dict`: keys split at ``.`` into a
    nested dict of numpy arrays."""
    tree: dict = {}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def encoder_flax_to_state_dict(enc_params: dict, like: dict | None = None
                               ) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``VGG19Features``, ``ResNet50Features`` or ``ViTB16Features``
    params (with or without the outer ``{'params': …}``) → the port module's
    state_dict; checked against ``like`` when given."""
    return tree_to_state_dict(enc_params, like, "encoder")


def encoder_state_dict_to_flax(sd: dict, name: str) -> dict:
    """The reverse of :func:`encoder_flax_to_state_dict` for encoder ``name``
    (``vgg19`` keeps flat ``conv1_1/kernel`` leaves, ``resnet50`` and
    ``vit_b16`` nest) → ``{'params': tree}`` of numpy arrays."""
    if name not in ("vgg19", "resnet50", "vit_b16"):
        raise ValueError(f"no flax layout for encoder {name!r}")
    if name == "vgg19":
        return {"params": {k.replace(".", "/"): t.detach().cpu().numpy()
                           for k, t in sd.items()}}
    return {"params": state_dict_to_tree(sd)}


def generator_flax_to_state_dict(g_params: dict, cfg) -> "OrderedDict[str, torch.Tensor]":
    """The generator of ``cfg.model.decoder`` from its flax tree: the
    attention-LSTM through :func:`flax_to_state_dict`, the transformer leaf
    by leaf, checked against a port module built from ``cfg``."""
    if cfg.model.decoder == "lstm":
        return flax_to_state_dict(g_params)
    from sgg_torch.train.state import make_generator

    return tree_to_state_dict(g_params, make_generator(cfg).state_dict(), "generator")


def generator_state_dict_to_flax(sd: dict) -> dict:
    """The reverse of :func:`generator_flax_to_state_dict`, for either
    decoder."""
    from sgg_torch.train.checkpoint import decoder_of

    return state_dict_to_tree(sd) if decoder_of(sd) == "transformer" else state_dict_to_flax(sd)


def critic_flax_to_state_dict(d_params: dict, cfg) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``TripleCritic`` params → the port critic's state_dict, checked
    leaf by leaf against a port critic built from ``cfg``."""
    from sgg_torch.models.discriminator import TripleCritic

    return tree_to_state_dict(d_params, TripleCritic.from_config(cfg).state_dict(), "critic")


def critic_state_dict_to_flax(sd: dict) -> dict:
    """The reverse of :func:`critic_flax_to_state_dict`."""
    return state_dict_to_tree(sd)


def train_state_from_flax(cfg, ref, device="cpu"):
    """A port ``GANTrainState`` holding the parameters of ``ref``, a
    reference train state (its ``step``, ``g_params``, ``d_params``,
    ``enc_params`` and ``g_ema``, arrays that numpy reads), with fresh
    optimizers: the state ``create_train_state`` makes, at ``ref``'s weights."""
    from sgg_torch.train.state import create_train_state

    state = create_train_state(cfg, device=device)
    state.step = int(ref.step)
    g_sd = generator_flax_to_state_dict(ref.g_params, cfg)
    state.generator.load_state_dict(g_sd)
    state.critic.load_state_dict(critic_flax_to_state_dict(ref.d_params, cfg))
    if state.encoder is not None:
        if ref.enc_params is None:
            raise ValueError("the config has an encoder but the reference state has no enc_params")
        state.encoder.load_state_dict(
            encoder_flax_to_state_dict(ref.enc_params, state.encoder.state_dict()))
    if state.g_ema is not None:
        if ref.g_ema is None:
            raise ValueError("train.ema_decay > 0 but the reference state has no g_ema")
        for k, v in generator_flax_to_state_dict(ref.g_ema, cfg).items():
            state.g_ema[k].copy_(v)
    return state


def load_params_npz(path: str) -> dict:
    """A params file written with ``::``-joined keys → the nested dict of
    numpy arrays (a copy of ``sgg.train.pretrain.load_params_npz``)."""
    raw = np.load(path)
    out: dict = {}
    for key in raw.files:
        parts = key.split("::")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = raw[key]
    return out
