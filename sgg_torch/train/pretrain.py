"""Supervised encoder pretraining on object-presence labels, from
``sgg/train/pretrain.py``.

The grounded recipe's stand-in for ImageNet weights: the synthetic corpus
knows every image's objects and boxes, so object presence (and, with
``spatial``, which object owns each cell of the feature grid) is a free
supervised task. The encoder trained on it is the product
(``encoder_params.npz``), which ``preprocess --encoder-ckpt`` extracts
through.

One step gathers a batch from a device-resident uint8 store at indices that
are an argument (by default drawn by a ``torch.Generator`` on the device,
seeded from ``seed`` and the step), runs the encoder and the presence head,
the loss (sigmoid BCE mean; plus ``spatial_weight`` times the per-cell
softmax CE over the head's pre-max region logits; plus 0.01 times the mean
MoE load-balance term of a MoE ViT) and optax's ``adam(lr)`` update
(``sgg_torch.train.state.Adam`` without a config). Routes
(``sgg_torch.models.encoders.train_route``): VGG-19 and ResNet-50 train on
the library conv (``use_pallas`` off: the CUDA conv kernels have no
backward; the reference trains through XLA's conv too), the
ViT on the CUDA flash attention and its backward kernels;
:func:`evaluate_presence` runs forward on the kernel route (``conv_direct``,
and ``fused_matmul`` for ResNet-50). The library conv sets cuDNN's TF32 for
both of its passes from its operands' dtype
(``sgg_torch.kernels.conv_direct.conv2d_nhwc_f32``).

Parameter names are the flax module's (``encoder.…``, ``head.proj``), so the
reference's trees convert leaf by leaf; :func:`save_params_npz` writes the
reference's flat ``::``-keyed file of the encoder's flax tree.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgg_torch.convert_flax import encoder_state_dict_to_flax
from sgg_torch.models.encoders import features_and_aux, make_encoder, normalize_for, train_route
from sgg_torch.models.layers import Dense
from sgg_torch.train.state import Adam

FEATURE_DIMS = {"vgg19": 512, "resnet50": 2048}
MOE_AUX_WEIGHT = 0.01  # the Switch load-balance weight the reference applies

class PresenceHead(nn.Module):
    """Region features [B, R, F] → (presence logits [B, V], per-region logits
    [B, R, V]), float32: a projection in the compute dtype, then the max over
    regions (an object is present if some region says so)."""

    def __init__(self, feat_dim: int, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(feat_dim, num_classes, dtype)

    def forward(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.proj(feats).float()
        return x.amax(dim=1), x  # amax splits the gradient over ties, as jnp.max


class PresenceModel(nn.Module):
    """Encoder + presence head: uint8 images → ``{"presence": [B, V],
    "regions": [B, R, V]}`` (float32 logits). ``encoder`` is the product."""

    def __init__(self, encoder_name: str, num_classes: int, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32, image_size: int = 224,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 vit_dims: tuple = (768, 12, 12)):
        super().__init__()
        self.encoder_name, self.dtype, self.use_pallas = encoder_name, dtype, use_pallas
        self.moe_experts = moe_experts
        self.encoder = make_encoder(
            encoder_name, use_pallas=use_pallas, dtype=dtype, image_size=image_size,
            vit_dims=tuple(vit_dims), moe_experts=moe_experts, moe_top_k=moe_top_k,
            trainable=True)
        feat_dim = vit_dims[0] if encoder_name == "vit_b16" else FEATURE_DIMS[encoder_name]
        self.head = PresenceHead(feat_dim, num_classes, dtype)

    def forward_aux(self, images_u8: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """(the logits, the MoE blocks' mean load-balance term; 0 without)."""
        feats, aux = features_and_aux(self.encoder, normalize_for(self.encoder_name, images_u8))
        presence, regions = self.head(feats)
        return {"presence": presence, "regions": regions}, aux

    def forward(self, images_u8: torch.Tensor) -> dict:
        return self.forward_aux(images_u8)[0]

    def set_route(self, use_pallas: bool) -> None:
        """Put every conv or attention of the encoder on the kernel route
        (True) or the plain one (False)."""
        self.use_pallas = use_pallas
        for mod in self.encoder.modules():
            if hasattr(mod, "use_pallas"):
                mod.use_pallas = use_pallas


def multi_hot_labels(triples_per_image: Sequence[np.ndarray], vocab_size: int) -> np.ndarray:
    """Per-image multi-hot over the subject/object token ids (float32 [N, V])."""
    out = np.zeros((len(triples_per_image), vocab_size), np.float32)
    for i, t in enumerate(triples_per_image):
        t = np.asarray(t, np.int32).reshape(-1, 3)
        out[i, t[:, 0]] = 1.0
        out[i, t[:, 2]] = 1.0
    out[:, 0] = 0.0  # never predict <pad>
    return out


def feature_grid(encoder_name: str, image_size: int) -> int:
    """Side length of the encoder's spatial feature grid (R = grid²)."""
    return image_size // (32 if encoder_name == "resnet50" else 16)


def cell_labels(entities_per_image: Sequence[Sequence[tuple[str, tuple]]], vocab, grid: int,
                image_wh: tuple[int, int]) -> np.ndarray:
    """Per-cell owner labels int32 [N, grid²]: each cell takes the vocab id of
    the smallest entity box containing its center (the renderer paints larger
    boxes first), 0 (``<pad>``, background) where no box does; entities out
    of vocab are skipped."""
    w, h = image_wh
    out = np.zeros((len(entities_per_image), grid * grid), np.int32)
    cx = (np.arange(grid, dtype=np.float32) + 0.5) * (w / grid)
    cy = (np.arange(grid, dtype=np.float32) + 0.5) * (h / grid)
    for i, ents in enumerate(entities_per_image):
        labels = out[i].reshape(grid, grid)
        for name, (x, y, bw, bh) in sorted(ents, key=lambda e: -(e[1][2] * e[1][3])):
            tid = vocab.id(name)
            if tid == vocab.unk_id or tid == 0:
                continue
            row = (cy >= y) & (cy < y + bh)
            col = (cx >= x) & (cx < x + bw)
            labels[np.ix_(row, col)] = tid
    return out


def make_pretrain_state(encoder_name: str, vocab_size: int, image_size: int = 224,
                        lr: float = 1e-4, dtype: torch.dtype = torch.float32, seed: int = 0,
                        moe_experts: int = 0, moe_top_k: int = 2,
                        vit_dims: tuple = (768, 12, 12), device="cpu"
                        ) -> tuple[PresenceModel, Adam]:
    """(model on ``device``, its optimizer: optax's ``adam(lr)``), parameters
    initialized on ``device`` from ``seed`` (on the card, since the MoE
    ViT-B/16's truncated-normal init of 540M parameters takes minutes on the
    host), on :func:`train_route`."""
    device = torch.device(device)
    cuda = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda), device:
        torch.manual_seed(seed)
        model = PresenceModel(encoder_name, vocab_size, use_pallas=train_route(encoder_name),
                              dtype=dtype, image_size=image_size, moe_experts=moe_experts,
                              moe_top_k=moe_top_k, vit_dims=vit_dims)
    return model, Adam(model, lr, None)


def draw_indices(seed: int, step: int, batch_size: int, n: int, device) -> torch.Tensor:
    """The batch indices step ``step`` draws when it is given none: int64 [B]
    in [0, n), from a ``torch.Generator`` on ``device`` seeded
    ``seed``·1,000,003 + step."""
    gen = torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))
    return torch.randint(0, n, (batch_size,), generator=gen, device=device)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's, element by element."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def make_pretrain_step(model: PresenceModel, opt: Adam, batch_size: int, seed: int = 0,
                       spatial: bool = False, spatial_weight: float = 1.0):
    """``step(images, labels, cells=None, step_idx=0, idx=None) → metrics``
    over a device-resident store: ``images`` uint8 [N, S, S, 3], ``labels``
    float32 [N, V], ``cells`` int [N, R] (with ``spatial``); ``idx`` int [B],
    the batch's rows (default :func:`draw_indices`). Updates the model in
    place; the metrics are 0-dim float32 tensors: ``presence_recall``,
    ``cell_acc`` (spatial) and ``loss``."""
    params = [p for p in model.parameters()]
    moe_on = model.moe_experts > 0

    def step(images, labels, cells=None, step_idx: int = 0, idx=None) -> dict:
        dev = images.device
        if idx is None:
            idx = draw_indices(seed, step_idx, batch_size, images.shape[0], dev)
        idx = torch.as_tensor(idx, device=dev).long()
        out, aux = model.forward_aux(images[idx])
        logits, labs = out["presence"], labels[idx]
        loss = sigmoid_binary_cross_entropy(logits, labs).mean()
        pos = labs > 0.5
        metrics = {"presence_recall": ((logits > 0.0) & pos).sum() / pos.sum().clamp(min=1)}
        if spatial:
            cell = cells[idx].long()
            regions = out["regions"]
            label_logits = regions.gather(-1, cell[..., None])[..., 0]
            ce = (torch.logsumexp(regions, dim=-1) - label_logits).mean()
            loss = loss + spatial_weight * ce
            fg = cell > 0  # non-background cells only
            hit = ((regions.argmax(dim=-1) == cell) & fg).sum()
            metrics["cell_acc"] = hit / fg.sum().clamp(min=1)
        if moe_on:
            loss = loss + MOE_AUX_WEIGHT * aux
        metrics["loss"] = loss
        grads = torch.autograd.grad(loss, params)
        opt.update(list(grads))
        return {k: v.detach().float() for k, v in metrics.items()}

    return step


@torch.no_grad()
def evaluate_presence(model: PresenceModel, images: np.ndarray, labels: np.ndarray,
                      batch_size: int = 32, cells: np.ndarray | None = None) -> dict:
    """Held-out presence quality on the kernel route: BCE loss, recall of
    positives at 0.5 and precision@k (k = the image's positive count); with
    ``cells`` also the non-background cell accuracy. Host metrics as the
    reference computes them."""
    device = next(model.parameters()).device
    route = model.use_pallas
    model.set_route(True)
    try:
        n = images.shape[0]
        tot_loss, tot_hit, tot_pos, tot_prec = 0.0, 0.0, 0, 0.0
        cell_hit, cell_fg = 0, 0
        for lo in range(0, n, batch_size):
            imgs = torch.from_numpy(np.ascontiguousarray(images[lo:lo + batch_size])).to(device)
            labs = labels[lo:lo + batch_size]
            out = model(imgs)
            if cells is not None:
                pred = out["regions"].argmax(dim=-1).cpu().numpy()
                lab_c = cells[lo:lo + batch_size]
                fg = lab_c > 0
                cell_hit += int(((pred == lab_c) & fg).sum())
                cell_fg += int(fg.sum())
            logits = out["presence"].cpu().numpy().astype(np.float32)
            tot_loss += float(np.mean(np.logaddexp(0.0, logits) - labs * logits)) * len(imgs)
            tot_hit += ((logits > 0.0) & (labs > 0.5)).sum()
            tot_pos += (labs > 0.5).sum()
            for b in range(logits.shape[0]):
                k = int((labs[b] > 0.5).sum())
                if k == 0:
                    continue
                topk = np.argpartition(-logits[b], k)[:k]
                tot_prec += labs[b][topk].sum() / k
    finally:
        model.set_route(route)
    report = {
        "loss": tot_loss / max(n, 1),
        "presence_recall": float(tot_hit) / max(tot_pos, 1),
        "precision_at_k": float(tot_prec) / max(n, 1),
    }
    if cells is not None:
        report["cell_acc"] = cell_hit / max(cell_fg, 1)
    return report


def encoder_params_tree(model: PresenceModel) -> dict:
    """The encoder's flax param tree (nested dict of float32 numpy arrays)."""
    return encoder_state_dict_to_flax(model.encoder.state_dict(), model.encoder_name)["params"]


def save_params_npz(path: str, params: dict) -> None:
    """Nested param dict → flat npz with ``::``-joined keys (the reference's
    keys, shapes and dtypes; ``/`` would re-nest VGG's flat ``conv1_1/kernel``
    names). Uncompressed, where the reference compresses: float weights
    barely compress, and compressing the MoE ViT-B/16's 2.2 GB takes over a
    minute; ``np.load`` reads both."""
    flat = {}

    def rec(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}::{k}" if prefix else str(k)
            if isinstance(v, dict):
                rec(v, key)
            else:
                flat[key] = np.asarray(v)

    rec(params, "")
    np.savez(path, **flat)
