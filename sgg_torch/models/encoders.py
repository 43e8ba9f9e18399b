"""Encoder factory: config name → backbone module, from
``sgg/models/encoders.py``. ``precomputed`` means the data already carries
features. ``quant='int8'`` builds the dynamic int8 PTQ tier
(``sgg_torch.kernels.quant``), for inference only.
"""

from __future__ import annotations

import torch
from torch import nn

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_STATS: dict = {}  # (vgg?, device) → normalize_stats there


def normalize_stats(name: str) -> torch.Tensor:
    """The constants of :func:`normalize_for` for encoder ``name``, float32 on
    the CPU: VGG's mean pixel in BGR order [1, 3], else ImageNet's mean and
    std [2, 3]."""
    if name == "vgg19":
        from sgg_torch.models.vgg import VGG_BGR_MEAN

        return torch.from_numpy(VGG_BGR_MEAN)[None]
    return torch.tensor([_IMAGENET_MEAN, _IMAGENET_STD])


def normalize_for(name: str, images_u8: torch.Tensor,
                  stats: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 RGB [B,H,W,3] → the float32 normalization the backbone was
    trained with (VGG: BGR minus the mean pixel; others: ImageNet mean/std).
    ``stats`` is :func:`normalize_stats` on the images' device (None: a copy
    made there once, not at every call)."""
    if stats is None:
        key = (name == "vgg19", images_u8.device)
        if key not in _STATS:
            _STATS[key] = normalize_stats(name).to(images_u8.device)
        stats = _STATS[key]
    if name == "vgg19":
        return images_u8.float().flip(-1) - stats[0]  # RGB → BGR, minus the mean pixel
    x = images_u8.float() / 255.0
    return (x - stats[0]) / stats[1]


def train_route(encoder_name: str, use_pallas: bool = True) -> bool:
    """``use_pallas`` for an encoder that trains: ``use_pallas`` for the ViT
    (the flash kernels carry a backward), False for the CNNs, which train on
    the library conv, the reference's ``'auto'`` route (the conv kernels have
    no backward). Pretraining and the GAN step's encoder under
    ``train.train_encoder`` both take it."""
    return use_pallas and encoder_name == "vit_b16"


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
    attention route (ViT) follow ``use_pallas``, a ``trainable`` encoder's
    :func:`train_route` of it (a CNN's convs on the library conv, whatever
    ``use_pallas`` says); the CNN modules take any route of
    ``sgg_torch.kernels.conv`` through their own ``conv_impl``, the ViT any
    attention through its ``attn_fn``. ViT only: ``image_size`` (default
    224) sizes ``pos_embed``; ``vit_dims`` is (embed_dim, num_layers,
    num_heads), the config's ``model.vit_dims``; ``moe_experts`` > 0 puts a
    top-``moe_top_k`` MoE layer in every block (``forward_aux`` returns its
    load-balance term beside the features).

    ``quant``: '' (float) or 'int8', the dynamic PTQ tier: every conv of
    VGG-19 and ResNet-50 on ``conv_impl='int8'``, and the ViT's qkv, out,
    mlp1 and mlp2 projections on ``int8_linear`` (its attention stays on
    ``use_pallas``'s route). Inference only: an int8 encoder is never
    ``trainable``."""
    if quant not in ("", "int8"):
        raise ValueError(f"unknown quant mode {quant!r} (want '' or 'int8')")
    if quant and trainable:
        raise ValueError("an int8 encoder is for inference only: rounding has no gradient")
    if name == "precomputed":
        return None
    if trainable:
        use_pallas = train_route(name, use_pallas)
    conv_impl = "int8" if quant == "int8" else None
    if name == "vgg19":
        from sgg_torch.models.vgg import VGG19Features

        enc = VGG19Features(use_pallas=use_pallas, conv_impl=conv_impl, dtype=dtype)
    elif name == "resnet50":
        from sgg_torch.models.resnet import ResNet50Features

        enc = ResNet50Features(use_pallas=use_pallas, conv_impl=conv_impl, dtype=dtype)
    elif name == "vit_b16":
        from sgg_torch.kernels.quant import int8_linear
        from sgg_torch.models.vit import ViTB16Features

        dim, layers, heads = vit_dims
        enc = ViTB16Features(
            embed_dim=dim, num_heads=heads, num_layers=layers, use_pallas=use_pallas,
            moe_experts=moe_experts, moe_top_k=moe_top_k, dtype=dtype,
            num_patches=((image_size or 224) // 16) ** 2,
            dot_fn=int8_linear if quant == "int8" else None,
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


class ImageEncoder:
    """uint8 images [n, S, S, 3] on its device → features [n, R, F] in the
    compute dtype, on that device, without gradients: ``encoder`` after
    ``normalize_for``."""

    def __init__(self, name: str, encoder: nn.Module):
        self.name, self.encoder = name, encoder

    def __call__(self, images_u8: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.encoder(normalize_for(self.name, images_u8))


def make_image_encoder(cfg, enc_params: dict, device: torch.device,
                       quant: str | None = None) -> ImageEncoder:
    """The config's encoder (``cfg.model``, a ``sgg_torch.config.Config``) on
    ``model.use_pallas``'s route with the weights ``enc_params`` (a port
    state_dict), on ``device``, quantized as ``quant`` says (None:
    ``model.quant``; '' float; 'int8'), as ``sgg.cli.common``'s
    (``sgg/cli/common.py:224-246``). ``sgg_torch.cli.generate``,
    ``sgg_torch.serve``, ``sgg_torch.api`` and the in-loop probe encode
    through it. The module is built on the meta device and takes
    ``enc_params``'s own tensors, with no init and no copy where they lie on
    ``device`` already: the probe's encoder reads the train state's weights."""
    m = cfg.model
    with torch.device("meta"):
        enc = make_encoder(m.encoder, use_pallas=m.use_pallas, dtype=m.dtype,
                           quant=m.quant if quant is None else quant,
                           image_size=cfg.data.image_size, vit_dims=m.vit_dims,
                           moe_experts=m.moe_experts, moe_top_k=m.moe_top_k)
    enc.load_state_dict(enc_params, assign=True)
    return ImageEncoder(m.encoder, enc.to(device))
