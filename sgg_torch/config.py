"""Dataclass configuration, mirroring ``sgg/config.py`` without JAX.

Every field of the reference dataclasses is kept, with its default, so that a
workdir ``config.json`` written by ``sgg`` training loads unchanged. Fields
that only a later slice of the port reads (training, encoders, the mesh) are
carried as plain data. Dtype strings map to torch dtypes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ModelConfig:
    vocab_size: int = 1024  # overwritten from the vocab at load time
    encoder: str = "precomputed"  # precomputed | vgg19 | resnet50 | vit_b16
    decoder: str = "lstm"  # lstm | transformer
    hidden: int = 512
    embed_dim: int = 256
    attn_dim: int = 256
    noise_dim: int = 128
    critic_hidden: int = 512
    critic_layers: int = 3
    num_heads: int = 8
    num_layers: int = 4
    mlp_ratio: int = 4
    compute_dtype: str = "float32"  # float32 | bfloat16
    use_pallas: bool = False
    sp_mode: str = ""
    pp_microbatches: int = 0
    moe_experts: int = 0
    moe_top_k: int = 2
    vit_dim: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    quant: str = ""

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def vit_dims(self) -> tuple[int, int, int]:
        """(embed_dim, num_layers, num_heads) for the ViT encoder."""
        return (self.vit_dim, self.vit_layers, self.vit_heads)


@dataclass
class DataConfig:
    regions: int = 196  # 14x14 VGG conv5 grid
    feat_dim: int = 512
    image_size: int = 224
    source: str = "synthetic"  # synthetic | shards | vg
    loader: str = "custom"
    grain_workers: int = 0
    data_dir: str = ""
    vocab_path: str = ""
    num_synthetic_images: int = 1024
    max_triples_per_image: int = 32
    test_fraction: float = 0.1
    device_resident: bool = True
    # Generate uploads the whole feature set once when it is at most this big;
    # training keeps its store on the device up to it, else rotates subsets
    # of at most half of it (rotate_subsets, rotation_min_steps).
    device_resident_max_bytes: int = 4_000_000_000
    rotate_subsets: bool = True
    rotation_min_steps: int = 0
    feature_store_int8: bool = False
    predicate_balance: float = 0.0
    max_images: int = 0
    split_seed: int = 0


@dataclass
class TrainConfig:
    batch_size: int = 32
    n_critic: int = 5
    gp_lambda: float = 10.0
    drift: float = 0.0
    g_lr: float = 1e-4
    d_lr: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.9
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_final_frac: float = 0.0
    grad_clip: float = 0.0
    moe_aux_coef: float = 0.01
    grad_accum: int = 1
    total_steps: int = 100_000
    seed: int = 0
    tau0: float = 1.0
    tau_min: float = 0.5
    tau_anneal: float = 0.0
    hard: bool = True
    estimator: str = "gumbel"
    rl_entropy: float = 0.0
    train_encoder: bool = False
    enc_lr: float = 1e-5
    critic_unroll: int = 8
    steps_per_dispatch: int = 1
    eval_every: int = 0
    eval_images: int = 256
    eval_samples: int = 50
    eval_k: int = 50
    log_every: int = 50
    checkpoint_every: int = 1000
    max_checkpoints: int = 3
    ema_decay: float = 0.0
    host_rss_exit_gb: float = 0.0
    stall_exit_sec: float = 900.0


@dataclass
class MeshConfig:
    data: int = -1
    model: int = 1
    seq: int = 1
    expert: int = 1
    partition: str = "auto"
    fsdp: bool = False


@dataclass
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    workdir: str = "/tmp/sgg_workdir"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            name=d.get("name", "default"),
            model=ModelConfig(**d.get("model", {})),
            data=DataConfig(**d.get("data", {})),
            train=TrainConfig(**d.get("train", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
            workdir=d.get("workdir", "/tmp/sgg_workdir"),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def override(self, assignments: list[str]) -> "Config":
        """Apply ``section.field=value`` overrides (typed via existing value)."""
        cfg = Config.from_dict(json.loads(self.to_json()))
        for a in assignments:
            path, _, raw = a.partition("=")
            parts = path.strip().split(".")
            obj: Any = cfg
            for p in parts[:-1]:
                obj = getattr(obj, p)
            old = getattr(obj, parts[-1])
            if isinstance(old, bool):
                val: Any = raw.strip().lower() in ("1", "true", "yes")
            elif isinstance(old, int):
                val = int(raw)
            elif isinstance(old, float):
                val = float(raw)
            else:
                val = raw
            setattr(obj, parts[-1], val)
        return cfg


def _cfg_vg1k() -> Config:
    """VG 1k-image subset, precomputed VGG-19 features, batch 32."""
    c = Config(name="vg1k")
    c.data.num_synthetic_images = 1024
    c.train.batch_size = 32
    return c


def _cfg_vg_full() -> Config:
    """Full Visual Genome end to end: VG's JPEGs decoded on the host (the
    native loader), VGG-19 on the CUDA conv kernels in bfloat16, then the
    GAN, batch 256. Point ``data.data_dir`` at a directory holding
    ``relationships.json`` and ``images/<id>.jpg``; the held-out split is
    preprocess's (``data.split_seed`` = its ``--seed``). A decoded corpus
    within ``data.device_resident_max_bytes`` trains on the device-resident
    store; full VG's (16.3 GB) trains on the host-prefetch route, decoding
    each step's images (``sgg_torch.cli.train``). ``mesh.data = -1`` is the
    reference's "every device": every rank of a torchrun launch."""
    c = Config(name="vg_full")
    c.model.encoder = "vgg19"
    c.model.compute_dtype = "bfloat16"
    c.model.use_pallas = True
    c.data.source = "vg"
    c.train.batch_size = 256
    c.mesh.data = -1
    return c


def _cfg_resnet50() -> Config:
    """ResNet-50 backbone on pixels, fused conv + BN + ReLU, larger vocab."""
    c = Config(name="resnet50")
    c.model.encoder = "resnet50"
    c.model.vocab_size = 8192
    c.model.compute_dtype = "bfloat16"
    c.model.use_pallas = True
    c.data.feat_dim = 2048
    c.data.regions = 49  # 7x7 conv5 grid
    c.mesh.model = 1
    return c


def _cfg_vit_b16() -> Config:
    """ViT-B/16 encoder + transformer triple decoder + flash attention."""
    c = Config(name="vit_b16")
    c.model.encoder = "vit_b16"
    c.model.decoder = "transformer"
    c.model.compute_dtype = "bfloat16"
    c.model.use_pallas = True
    c.data.feat_dim = 768
    c.data.regions = 196  # 14x14 patches at 224px
    return c


def _cfg_v4_32() -> Config:
    """The reference's multi-process data-parallel WGAN-GP config (a v4-32
    TPU's): ``vg_full``'s VGG-19 on VG's JPEGs, bf16, at batch 128 per
    process, ``mesh.data = -1`` over every rank. Launch one process per card
    with ``torchrun --nproc_per_node N -m sgg_torch.cli.train --config v4_32``
    and point ``data.data_dir`` at VG (``sgg_torch.cli.train``)."""
    c = Config(name="v4_32")
    c.model.encoder = "vgg19"
    c.model.compute_dtype = "bfloat16"
    c.model.use_pallas = True
    c.data.source = "vg"
    c.train.batch_size = 128  # per process; global = 128 * processes
    c.mesh.data = -1
    return c


def _cfg_smoke() -> Config:
    """Tiny shapes for tests."""
    c = Config(name="smoke")
    c.model.hidden = 32
    c.model.embed_dim = 16
    c.model.attn_dim = 16
    c.model.noise_dim = 8
    c.model.critic_hidden = 32
    c.data.regions = 9
    c.data.feat_dim = 16
    c.data.num_synthetic_images = 64
    c.train.batch_size = 8
    c.train.n_critic = 2
    c.train.total_steps = 20
    c.train.log_every = 5
    c.train.checkpoint_every = 10
    return c


def _cfg_pipeline_v4() -> Config:
    """The north star's main path: predicate-balanced (alpha 0.7) training on
    precomputed-feature shards with the int8 feature store, bf16, batch 256,
    grad_accum 2, EMA; evaluated with ``--ema --avg-last 5 --rank logp``.
    Point ``data.data_dir`` at the shards. A store over
    ``data.device_resident_max_bytes`` (4 GB, the reference's budget) trains on
    rotating device-resident subsets of at most half of it each, with at least
    ``data.rotation_min_steps`` steps per subset; raise the budget with
    ``--set`` to keep more of the store on the card at once.
    ``train.steps_per_dispatch`` = 32 fuses 32 steps per dispatch when the
    whole store is on the device, rounded to the gcd of 32 and the log,
    checkpoint and eval cadences (50, 2,000 and 5,000 give 2); the card's
    recipe sets all three to multiples of 32 and a budget that holds the
    store (``sgg_torch.cli.train``)."""
    c = Config(name="pipeline_v4")
    c.model.compute_dtype = "bfloat16"
    c.data.source = "shards"
    c.data.predicate_balance = 0.7
    c.data.feature_store_int8 = True
    c.data.device_resident_max_bytes = 4_000_000_000
    c.data.rotation_min_steps = 10_000
    c.train.batch_size = 256
    c.train.total_steps = 100_000
    c.train.grad_accum = 2
    c.train.steps_per_dispatch = 32
    c.train.ema_decay = 0.999
    c.train.checkpoint_every = 2_000
    c.train.max_checkpoints = 6
    c.train.eval_every = 5_000
    return c


CONFIGS = {"vg1k": _cfg_vg1k, "vg_full": _cfg_vg_full, "resnet50": _cfg_resnet50,
           "vit_b16": _cfg_vit_b16, "v4_32": _cfg_v4_32, "smoke": _cfg_smoke,
           "pipeline_v4": _cfg_pipeline_v4}


def get_config(name: str) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]()
