"""Encoder factory: config name → backbone module, from
``sgg/models/encoders.py``. ``precomputed`` means the data already carries
features. The int8 tier comes with a later slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_STATS: dict = {}  # device → (mean, std) float32 [3]
_LATER = "is not ported yet; a later slice of the port brings it"


def normalize_for(name: str, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [B,H,W,3] → the float32 normalization the backbone was
    trained with (VGG: BGR minus the mean pixel; others: ImageNet mean/std)."""
    if name == "vgg19":
        from sgg_torch.models.vgg import vgg_preprocess

        return vgg_preprocess(images_u8)
    x = images_u8.float() / 255.0
    if x.device not in _STATS:  # copied to each device once, not at every call
        _STATS[x.device] = (torch.tensor(_IMAGENET_MEAN).to(x.device),
                            torch.tensor(_IMAGENET_STD).to(x.device))
    mean, std = _STATS[x.device]
    return (x - mean) / std


def make_encoder(
    name: str, use_pallas: bool = False, dtype: torch.dtype = torch.float32,
    quant: str = "", image_size: int | None = None,
    vit_dims: tuple[int, int, int] = (768, 12, 12), moe_experts: int = 0,
    trainable: bool = False, moe_top_k: int = 2,
) -> nn.Module | None:
    """The feature extractor, or None for ``precomputed``: frozen (its
    parameters need no gradient) unless ``trainable``, as training with
    ``train.train_encoder`` asks. Either way in ``eval()`` mode: no module
    here behaves differently in training. The conv route (CNNs) and the
    attention route (ViT) follow ``use_pallas``; the CNN modules take any route of
    ``sgg_torch.kernels.conv`` through their own ``conv_impl``, the ViT any
    attention through its ``attn_fn``. ViT only: ``image_size`` (default
    224) sizes ``pos_embed``; ``vit_dims`` is (embed_dim, num_layers,
    num_heads), the config's ``model.vit_dims``; ``moe_experts`` > 0 puts a
    top-``moe_top_k`` MoE layer in every block (``forward_aux`` returns its
    load-balance term beside the features)."""
    if quant not in ("", "int8"):
        raise ValueError(f"unknown quant mode {quant!r} (want '' or 'int8')")
    if quant == "int8":
        raise NotImplementedError(f"quant 'int8' {_LATER} (ROADMAP A7)")
    if name == "precomputed":
        return None
    if name == "vgg19":
        from sgg_torch.models.vgg import VGG19Features

        enc = VGG19Features(use_pallas=use_pallas, dtype=dtype)
    elif name == "resnet50":
        from sgg_torch.models.resnet import ResNet50Features

        enc = ResNet50Features(use_pallas=use_pallas, dtype=dtype)
    elif name == "vit_b16":
        from sgg_torch.models.vit import ViTB16Features

        dim, layers, heads = vit_dims
        enc = ViTB16Features(
            embed_dim=dim, num_heads=heads, num_layers=layers, use_pallas=use_pallas,
            moe_experts=moe_experts, moe_top_k=moe_top_k, dtype=dtype,
            num_patches=((image_size or 224) // 16) ** 2,
        )
    else:
        raise ValueError(f"unknown encoder {name!r}")
    return enc.requires_grad_(trainable).eval()


def features_and_aux(encoder: nn.Module, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(features, the MoE blocks' mean load-balance term, float32) of a
    normalized batch; the term is 0 for an encoder without MoE blocks, as
    the reference's empty ``"moe"`` collection."""
    if hasattr(encoder, "forward_aux"):
        feats, aux = encoder.forward_aux(x)
    else:
        feats, aux = encoder(x), None
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return feats, aux


def make_image_encoder(cfg, enc_params: dict, device: torch.device):
    """uint8 images [n, S, S, 3] on ``device`` → features [n, R, F] in the
    compute dtype, on ``device``: the config's encoder (``cfg.model``, a
    ``sgg_torch.config.Config``) on ``model.use_pallas``'s route with the
    weights ``enc_params`` (a port state_dict), after ``normalize_for``.
    ``sgg_torch.cli.generate`` and ``sgg_torch.serve`` encode through it."""
    m = cfg.model
    enc = make_encoder(m.encoder, use_pallas=m.use_pallas, dtype=m.dtype, quant=m.quant,
                       image_size=cfg.data.image_size, vit_dims=m.vit_dims,
                       moe_experts=m.moe_experts, moe_top_k=m.moe_top_k)
    enc.load_state_dict(enc_params)
    enc.to(device)

    def encode(images_u8: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return enc(normalize_for(m.encoder, images_u8))

    return encode
