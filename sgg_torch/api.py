"""High-level library API, from ``sgg/api.py``: one object from a port
workdir to scene graphs.

    from sgg_torch.api import SceneGraphGenerator
    g = SceneGraphGenerator.from_workdir("/runs/vg1k")          # on the card
    graphs = g.generate_from_features(feats)          # [B, R, F]
    graphs = g.generate_from_images(images_u8)        # [B, H, W, 3] (encoder configs)
    graphs = g.generate_from_paths(["a.jpg", "b.jpg"])  # JPEGs (encoder configs)

It runs on CUDA unless it is given ``device='cpu'``. Pixels-in configs
encode on ``model.use_pallas``'s route, as ``sgg_torch.cli.generate`` does,
quantized as ``model.quant`` says ('int8': the encoder's dynamic int8 PTQ,
``sgg_torch.kernels.quant``, as the reference's ``quant=cfg.model.quant``);
``generate_from_paths`` decodes with the native loader at
``data.image_size`` first.
"""

from __future__ import annotations

import numpy as np
import torch

from sgg_torch.cli.common import resolve_device
from sgg_torch.data.extract import load_batch
from sgg_torch.eval.sampler import assemble_scene_graph, make_sampler, rank_triples
from sgg_torch.models.encoders import make_image_encoder
from sgg_torch.serve import ServeWeights, read_workdir_weights


class SceneGraphGenerator:
    def __init__(self, cfg, vocab, weights: ServeWeights, num_samples: int = 50,
                 seed: int = 0, temperature: float | None = None, rank: str = "freq",
                 device="cuda"):
        self.cfg = cfg
        self.vocab = vocab
        self.device = resolve_device(device)
        self.step = int(weights.step)
        self.num_samples = num_samples
        self.rank = rank
        self._g_params = {k: v.to(self.device) for k, v in weights.g_params.items()}
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._sampler = make_sampler(
            cfg, step_mask=vocab.step_mask(), num_samples=num_samples,
            tau=temperature, with_logp=rank != "freq",
        )
        self._encode = None
        if cfg.model.encoder != "precomputed":
            if weights.enc_params is None:
                raise ValueError(f"encoder {cfg.model.encoder!r}: the checkpoint has no "
                                 "encoder weights (enc_params)")
            self._encode = make_image_encoder(cfg, weights.enc_params, self.device)

    @classmethod
    def from_workdir(
        cls, workdir: str, num_samples: int = 50, seed: int = 0,
        temperature: float | None = None, rank: str = "freq",
        avg_last: int = 0, device="cuda",
    ) -> "SceneGraphGenerator":
        """``temperature``: tokens ~ softmax(logits/T), default 1.0.
        ``rank``: triple confidence order — 'freq' (sample count),
        'freq_logp', or 'logp' (see :func:`sgg_torch.eval.sampler.rank_triples`).
        ``avg_last`` > 1: the mean of the last N retained checkpoints'
        generator weights."""
        cfg, vocab, weights = read_workdir_weights(workdir, avg_last)
        return cls(cfg, vocab, weights, num_samples=num_samples, seed=seed,
                   temperature=temperature, rank=rank, device=device)

    # ------------------------------------------------------------- generate
    def generate_from_features(self, feats, temperature=None) -> list[dict]:
        """[B, R, F] features (a float array or a tensor) → per-image
        scene-graph dicts (ranked triples). ``temperature`` overrides the
        constructor's default for this call only: a number or float[B]."""
        if not isinstance(feats, torch.Tensor):
            feats = torch.from_numpy(np.array(feats, np.float32))  # writable copy
        feats = feats.to(self.device, self.cfg.model.dtype)
        if temperature is not None:
            temperature = torch.as_tensor(np.asarray(temperature, np.float32),
                                          device=self.device)
        out = self._sampler(self._g_params, feats, self._generator, temp=temperature)
        if self.rank == "freq":
            tokens = out.cpu().numpy()
            return [
                assemble_scene_graph(tokens[i], self.vocab)
                for i in range(len(tokens))
            ]
        tokens, logp = (x.cpu().numpy() for x in out)
        graphs = []
        for i in range(len(tokens)):
            ordered = rank_triples(tokens[i], logp[i], rank=self.rank)
            names = [self.vocab.decode_triple(t) for t in ordered]
            graphs.append({"triples": [
                {"subject": s, "predicate": p, "object": o}
                for (s, p, o) in names
            ]})
        return graphs

    def generate_from_images(self, images_u8, temperature=None) -> list[dict]:
        """uint8[B, H, W, 3] → scene graphs (requires an encoder config)."""
        if self._encode is None:
            raise ValueError(
                "this run used precomputed features; call generate_from_features"
            )
        images = torch.from_numpy(np.array(images_u8, np.uint8))  # writable copy
        return self.generate_from_features(self._encode(images.to(self.device)), temperature)

    def generate_from_paths(self, paths: list[str], temperature=None) -> list[dict]:
        """JPEG paths → scene graphs (requires an encoder config)."""
        if self._encode is None:
            raise ValueError(
                "this run used precomputed features; call generate_from_features"
            )
        return self.generate_from_images(
            load_batch(list(paths), self.cfg.data.image_size), temperature)
