"""The exported sampler artifact: a trained sampler as one file that torch
alone loads and calls, from ``sgg/export.py``.

``torch.export`` traces the generator-forward K-draw sampler (one draw of
``make_sampler``'s loop, ``sgg_torch.eval.sampler.draw_tokens``, mapped over
the K draws) and,
for a pixels-in artifact, ``normalize_for`` and the encoder in front of it.
The traced ATen program is the artifact, so model-code drift cannot skew
serving.

- **Weights are lifted parameters** of the exported program, not constants
  folded into it: the program takes them as inputs, and its ``state_dict``
  may be swapped (the reference's "params ride as arguments").
- **Randomness is explicit.** The reference's entry takes ``jax.random``
  key data, whose generator torch cannot reproduce, so the port's takes the
  draws themselves: ``tokens int32[B, K, 3] = call(x, z [K, B, Z],
  gumbel [K, B, 3, V])``, ``z`` in the compute dtype (``meta['feats_dtype']``)
  and ``gumbel`` float32, the ``noise`` pair that ``make_sampler`` accepts.
  The caller draws them on the device, e.g. :func:`artifact_noise` from a
  ``torch.Generator``: z ~ N(0, 1), then g = -log(-log u), u uniform, for
  each of the K draws in turn.
- **Inputs.** Features in: ``x = feats [B, R, F]`` in the compute dtype.
  Pixels in (``enc_params``): ``x = images uint8 [B, S, S, 3]``, and the
  encoder runs inside, on the library route (the reference builds it without
  ``use_pallas``): the library conv and the unfused attention, and under
  ``quant='int8'`` the int32 products on ``torch._int_mm``. The hand-written
  CUDA kernels are reached through ``ctypes`` and cannot be traced, so an
  artifact launches none of them.
- **Platforms.** The program is traced once, on the CPU; its operators are
  device-generic, and :func:`load_artifact` moves it to the device asked for
  (``torch.export.passes.move_to_device_pass``). One file thus serves
  ``cpu`` and ``cuda``; ``meta['platforms']`` lists those it was exported
  for, and loading on another is refused. ``tpu`` is refused at export.
- **Batch.** ``batch_size`` N traces at N (callers pad to it, as
  :class:`sgg_torch.serve.ArtifactEngine` does); 0 traces a symbolic batch
  (``torch.export.Dim``).

File: ``torch.export.save``'s archive (a zip) holding the program, its
weights and ``meta.json`` (the reference's meta fields: shapes, sampling
settings, the vocab; ``step`` added by the CLI; ``noise`` the entry's noise
shapes). Without any of this package::

    extra = {"meta.json": ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra["meta.json"])
    with torch.no_grad():
        tokens = ep.module()(x, z, gumbel)

The reference's own ``.sgx`` (a numpy archive of serialized StableHLO)
cannot be read by the port: :func:`load_artifact` refuses it.

Usage:
    python -m sgg_torch.cli.export --workdir /runs/vg1k --out model.pt2 --check
    call, meta = sgg_torch.export.load_artifact("model.pt2", device="cuda")
"""

from __future__ import annotations

import json
import zipfile

import numpy as np
import torch
from torch import nn

from sgg_torch.cli.common import resolve_device
from sgg_torch.config import Config
from sgg_torch.kernels.quant import forced_route

ARTIFACT_VERSION = 1
PLATFORMS = ("cpu", "cuda")
META_FILE = "meta.json"


class SamplerProgram(nn.Module):
    """The traced entry: ``(x, z, gumbel)`` → tokens int32 [B, K, 3].

    One draw (``sgg_torch.eval.sampler.draw_tokens``) is traced and mapped
    over the K draws (``torch._higher_order_ops.map``): the same operators on
    the same [B, ...] shapes as ``make_sampler``'s loop, in a program one draw
    long whatever K is. A pixels-in program holds ``normalize_for``'s
    constants as a buffer."""

    def __init__(self, cfg: Config, generator: nn.Module, step_mask, temperature: float,
                 encoder: nn.Module | None = None):
        super().__init__()
        from sgg_torch.models.encoders import normalize_stats

        self.encoder_name, self.temperature = cfg.model.encoder, temperature
        self.generator, self.encoder = generator, encoder
        self.register_buffer("step_mask", torch.as_tensor(step_mask, dtype=torch.bool))
        if encoder is not None:
            self.register_buffer("norm_stats", normalize_stats(self.encoder_name))

    def forward(self, x: torch.Tensor, z: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
        from torch._higher_order_ops.map import map as map_draws

        from sgg_torch.eval.sampler import draw_tokens
        from sgg_torch.models.encoders import normalize_for

        feats = x
        if self.encoder is not None:
            feats = self.encoder(normalize_for(self.encoder_name, x, self.norm_stats))
        temp = torch.as_tensor(self.temperature, dtype=torch.float32, device=feats.device)

        def one(zg, feats, mask, temp):
            return draw_tokens(self.generator, feats, *zg, mask, temp)

        tokens = map_draws(one, (z, gumbel), feats, self.step_mask, temp)
        return tokens.transpose(0, 1).contiguous()  # [K, B, 3] → [B, K, 3]


def check_platforms(platforms) -> tuple[str, ...]:
    """``platforms`` as a tuple; raises ValueError for ``tpu`` or an unknown
    device, or for none."""
    platforms = tuple(platforms)
    for p in platforms:
        if p == "tpu":
            raise ValueError("platform 'tpu': the port's artifact is a torch program for "
                             f"{' and '.join(PLATFORMS)}; a TPU artifact comes from "
                             "sgg.cli.export")
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}; one of {PLATFORMS}")
    if not platforms:
        raise ValueError(f"no platform given; one or more of {PLATFORMS}")
    return platforms


def export_sampler(
    cfg: Config,
    vocab,
    g_params: dict,
    *,
    enc_params: dict | None = None,
    quant: str = "",
    batch_size: int = 32,
    num_samples: int = 50,
    temperature: float | None = None,
    platforms=PLATFORMS,
):
    """Trace the K-draw sampler → ``(exported, meta)`` for :func:`save_artifact`.

    ``g_params`` (and ``enc_params``, for an encoder config) are port
    state_dicts; with ``enc_params`` the artifact takes pixels, its encoder
    quantized as ``quant`` ('' or 'int8') says. ``batch_size`` 0 exports a
    symbolic batch."""
    from sgg_torch.models.encoders import make_encoder
    from sgg_torch.train.state import make_generator

    platforms = check_platforms(platforms)
    m, d = cfg.model, cfg.data
    with_encoder = enc_params is not None and m.encoder != "precomputed"
    with torch.random.fork_rng(devices=[]):
        gen = make_generator(cfg)
        enc = None
        if with_encoder:
            enc = make_encoder(m.encoder, dtype=m.dtype, quant=quant, image_size=d.image_size,
                               vit_dims=m.vit_dims, moe_experts=m.moe_experts,
                               moe_top_k=m.moe_top_k)
    gen.load_state_dict({k: v.float().cpu() for k, v in g_params.items()})
    if enc is not None:
        enc.load_state_dict({k: v.float().cpu() for k, v in enc_params.items()})
    tau = 1.0 if temperature is None else float(temperature)
    program = SamplerProgram(cfg, gen, vocab.step_mask(), tau,
                             enc).requires_grad_(False).eval()
    B = int(batch_size) or 2  # a symbolic batch traces at 2, its least value
    K, Z, V = int(num_samples), m.noise_dim, m.vocab_size
    if with_encoder:
        x = torch.zeros(B, d.image_size, d.image_size, 3, dtype=torch.uint8)
    else:
        x = torch.zeros(B, d.regions, d.feat_dim, dtype=m.dtype)
    z = torch.zeros(K, B, Z, dtype=m.dtype)
    gumbel = torch.zeros(K, B, 3, V, dtype=torch.float32)
    dynamic = None
    if not batch_size:
        b = torch.export.Dim("batch")
        dynamic = {"x": {0: b}, "z": {1: b}, "gumbel": {1: b}}
    # The map over draws traces its body through dynamo, whose cache of an
    # earlier export (another batch) would add that export's shape guards.
    torch._dynamo.reset()
    with forced_route("int_mm"):  # the card's int8 product, whatever device traces
        exported = torch.export.export(program, (x, z, gumbel), dynamic_shapes=dynamic,
                                       strict=False)
    batch = int(batch_size) or "batch"
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "format": "torch.export",
        "torch_version": torch.__version__,
        "input": "images" if with_encoder else "features",
        "encoder": m.encoder if with_encoder else "",
        "quant": quant if with_encoder else "",
        "image_size": int(d.image_size) if with_encoder else 0,
        "batch_size": int(batch_size),
        "num_samples": K,
        "regions": int(d.regions),
        "feat_dim": int(d.feat_dim),
        "feats_dtype": m.compute_dtype,
        "temperature": tau,
        "platforms": list(platforms),
        "noise": {"z": [K, batch, Z], "z_dtype": m.compute_dtype,
                  "gumbel": [K, batch, 3, V], "gumbel_dtype": "float32"},
        "vocab_tokens": list(vocab.tokens),
        "vocab_is_object": [bool(b_) for b_ in vocab.is_object],
        "vocab_is_predicate": [bool(b_) for b_ in vocab.is_predicate],
    }
    return exported, meta


def save_artifact(path: str, exported, meta: dict) -> None:
    """One file: ``torch.export.save``'s archive with ``meta.json`` inside."""
    torch.export.save(exported, path, extra_files={META_FILE: json.dumps(meta)})


def _is_reference_artifact(path: str) -> bool:
    """Whether ``path`` is the reference's ``.sgx``: a numpy archive with a
    ``__module__`` array of serialized StableHLO."""
    try:
        with zipfile.ZipFile(path) as zf:
            return "__module__.npy" in zf.namelist()
    except zipfile.BadZipFile:
        return False


def load_artifact(path: str, device="cuda"):
    """Artifact → ``(call, meta)`` on ``device``: CUDA unless ``'cpu'`` is
    given, and raises if CUDA is not there.

    ``call(x, z, gumbel)`` → tokens int32 [B, K, 3] on ``device``: ``x`` is
    feats [B, R, F] (``meta['input'] == 'features'``) or images uint8
    [B, S, S, 3] (``'images'``), ``z`` [K, B, Z] and ``gumbel`` [K, B, 3, V]
    the draws (:func:`artifact_noise`); ``call.exported`` is the loaded
    ``ExportedProgram``. ``meta`` carries the vocab (``vocab_tokens``). On
    CUDA, cuDNN's TF32 follows the compute dtype as in the live library conv
    (``sgg_torch.kernels.conv_direct.tf32_allowed``)."""
    from sgg_torch.kernels.conv_direct import _cudnn_tf32, tf32_allowed

    if _is_reference_artifact(path):
        raise ValueError(
            f"{path} is the reference's artifact (sgg.export: serialized StableHLO for "
            "jax.export), which the port cannot read; export a port artifact with "
            "python -m sgg_torch.cli.export")
    extra = {META_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META_FILE])
    if meta.get("artifact_version") != ARTIFACT_VERSION:
        raise ValueError(f"{path}: artifact version {meta.get('artifact_version')}, this "
                         f"loader reads {ARTIFACT_VERSION}")
    device = resolve_device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not {device.type}")
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    program = exported.module()
    tf32 = tf32_allowed(getattr(torch, meta["feats_dtype"]))

    def call(x, z, gumbel):
        with torch.no_grad(), _cudnn_tf32(tf32):
            return program(x.to(device), z.to(device), gumbel.to(device))

    call.exported = exported  # the loaded program: its signature and lifted weights
    return call, meta


def artifact_noise(meta: dict, batch: int, generator: torch.Generator, device=None):
    """``(z, gumbel)`` for one call of a ``batch``-image artifact from
    ``generator`` (on ``device``), in the order ``make_sampler`` draws
    (``sgg_torch.eval.sampler.draw_noise`` at the artifact's shapes)."""
    from sgg_torch.eval.sampler import draw_noise

    noise = meta["noise"]
    return draw_noise(generator, meta["num_samples"], batch, noise["z"][2], noise["gumbel"][3],
                      getattr(torch, noise["z_dtype"]), device)


def decode_tokens(tokens, meta: dict) -> list[list[tuple[str, str, str]]]:
    """int32 [B, K, 3] + artifact meta → per-image triple strings (a
    consumer's path with no model code; mirrors ``Vocab.token``)."""
    toks = meta["vocab_tokens"]
    out = []
    for row in np.asarray(tokens):
        out.append([(toks[int(s)], toks[int(p)], toks[int(o)]) for s, p, o in row])
    return out
