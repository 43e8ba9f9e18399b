"""The in-loop held-out probe (``train.eval_every``), from
``sgg/train/eval_probe.py``.

Every ``eval_every`` steps (and at the last step) the train loop samples
``eval_samples`` draws per image for up to ``eval_images`` held-out images
with the current generator weights (the EMA weights when the run tracks them,
as ``--ema`` inference uses) and reports recall@``eval_k`` beside the losses,
ranked by frequency as ``sgg_torch.cli.evaluate`` ranks by default. The best
value and its step are kept in ``W/best_eval.json``. Each probe's noise comes
from a ``torch.Generator`` seeded by (``train.seed + 1``, step): probes at
different steps draw different noise, and a rerun reproduces the curve.
Pixels-in configs encode the held-out images at each probe with the run's
current encoder weights (``sgg/train/eval_probe.py:59-89``): its in-memory
images, or the path-backed split's JPEGs decoded per batch; the last batch's
features are padded with its last row, as the reference pads them. The probe
encodes through its own ``make_image_encoder``, quantized as ``model.quant``
says (the reference's ``quant=cfg.model.quant``), while the train state's
encoder stays float; the two modules share one copy of the weights.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from sgg_torch.config import Config


def probe_seed(cfg: Config, step: int) -> int:
    """The seed of the probe's generator at ``step``."""
    return (int(cfg.train.seed) + 1) * 1_000_003 + int(step)


class EvalProbe:
    """Held-out recall probe bound to a config and vocab; ``run(state, step)``."""

    def __init__(self, cfg: Config, vocab, device, log=None):
        from sgg_torch.cli.common import load_dataset
        from sgg_torch.eval.sampler import make_sampler

        self.cfg = cfg
        self.device = torch.device(device)
        self.k = int(cfg.train.eval_k)
        self.log = log or (lambda m: None)
        ds, _ = load_dataset(cfg, split="test")
        n = min(int(cfg.train.eval_images) or len(ds), len(ds))
        self.n_images = n
        self.batch = min(cfg.train.batch_size, n)
        self.gt = [[tuple(int(x) for x in t) for t in ds.triples[i]] for i in range(n)]
        self._ds = ds
        self._sampler = make_sampler(cfg, step_mask=vocab.step_mask(),
                                     num_samples=int(cfg.train.eval_samples))
        self._encode = None  # the probe's ImageEncoder, built at each probe
        self.best = None  # (recall, step)
        self._best_path = os.path.join(cfg.workdir, "best_eval.json")
        if os.path.exists(self._best_path):
            try:
                with open(self._best_path) as f:
                    prev = json.load(f)
                self.best = (float(prev["recall"]), int(prev["step"]))
            except (ValueError, KeyError, OSError):
                pass  # an unreadable best file: start afresh

    def _batch_features(self, state, idx: np.ndarray) -> torch.Tensor:
        """Features [n, R, F] of held-out images ``idx`` on the device: the
        stored features, or the probe's encoder with the run's current weights
        (``state.encoder``'s, fine-tuned with ``train_encoder``) on their uint8
        images, in memory or decoded from their JPEGs."""
        ds = self._ds
        if state.encoder is None:
            return torch.from_numpy(ds.features[idx]).to(self.device)
        from sgg_torch.data.extract import load_batch

        if hasattr(ds, "images"):
            imgs = ds.images[idx]
        else:
            imgs = load_batch([ds.paths[int(i)] for i in idx], ds.image_size)
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        return self._encode(x)

    def run(self, state, step: int, noise: list | None = None) -> dict:
        """Probe the current weights → {"eval_recall@k": v, "eval_seconds": s}.
        ``noise`` (one ``(z, gumbel)`` per batch, the sampler's layout)
        replaces the probe's own draws."""
        from sgg_torch.eval.recall import corpus_recall_multi
        from sgg_torch.eval.sampler import rank_triples

        t0 = time.perf_counter()
        ema = state.g_ema is not None
        g = state.g_ema if ema else state.generator.state_dict()
        g = {k: v.detach() for k, v in g.items()}
        generator = torch.Generator(device=self.device).manual_seed(
            probe_seed(self.cfg, step))
        B = self.batch
        if state.encoder is not None:  # the state's current weights, shared, not copied
            from sgg_torch.models.encoders import make_image_encoder

            self._encode = make_image_encoder(self.cfg, state.encoder.state_dict(), self.device)
        gen_triples = []
        for b, lo in enumerate(range(0, self.n_images, B)):
            idx = np.arange(lo, min(lo + B, self.n_images))
            feats = self._batch_features(state, idx)
            if len(idx) < B:  # the last batch padded with its last row
                feats = torch.cat([feats, feats[-1:].expand(B - len(idx), *feats.shape[1:])])
            tokens = self._sampler(g, feats, generator,
                                   None if noise is None else noise[b]).cpu().numpy()
            for j in range(min(B, self.n_images - lo)):
                gen_triples.append(rank_triples(tokens[j]))
        recall = corpus_recall_multi(gen_triples, self.gt, [self.k])[self.k]
        secs = time.perf_counter() - t0
        if self.best is None or recall > self.best[0]:
            self.best = (recall, step)
            tmp = self._best_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"recall": recall, "k": self.k, "step": step,
                           "images": self.n_images,
                           "samples": int(self.cfg.train.eval_samples), "ema": ema}, f)
            os.replace(tmp, self._best_path)
        self.log(f"[sgg.train] eval step {step}: recall@{self.k} = {recall:.4f} "
                 f"({self.n_images} held-out images, {secs:.1f}s; "
                 f"best {self.best[0]:.4f} @ {self.best[1]})")
        return {f"eval_recall@{self.k}": recall, "eval_seconds": secs}
