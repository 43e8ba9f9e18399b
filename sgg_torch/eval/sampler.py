"""Batched scene-graph sampling, from ``sgg/eval/sampler.py``.

Per image batch, K noise draws, each a hard Gumbel-max triple at temperature
1.0, then the K triples of each image are deduped and ranked by sample
frequency. Two samplers draw the tokens:
  - :func:`make_sampler` / :func:`make_indexed_sampler` run the generator's
    own forward (either decoder), the reference's XLA sampler;
  - :func:`make_fused_sampler` runs one launch of ``fused_decode`` per draw
    (attention-LSTM only).
Log-prob ranking, temperatures other than 1 and top-k/top-p come with a later
slice (ROADMAP A4).
"""

from __future__ import annotations

import numpy as np
import torch

from sgg_torch.config import Config
from sgg_torch.data.vocab import Vocab
from sgg_torch.kernels.fused_decode import (
    TRIPLE_LEN,
    decode_params_from_generator,
    fused_decode,
    step_mask_bias,
)
from sgg_torch.train.state import make_generator
from sgg_torch.utils.gumbel import sample_gumbel

_LATER_A4 = "is not ported yet; a later slice of the port brings it (ROADMAP A4)"


def _draw(noise, i, B, Z, V, dtype, dev, generator):
    """Draw i's z [B, Z] in ``dtype`` and Gumbel noise [B, 3, V] float32:
    from ``noise = (z [K,B,Z], gumbel [K,B,3,V])`` when given, else from
    ``generator``."""
    if noise is None:
        z = torch.randn(B, Z, generator=generator, device=dev).to(dtype)
        return z, sample_gumbel((B, TRIPLE_LEN, V), generator, device=dev)
    z = noise[0][i].to(device=dev, dtype=dtype).contiguous()
    return z, noise[1][i].to(device=dev, dtype=torch.float32).contiguous()


def _sample_body(cfg: Config, step_mask, num_samples: int, tau, with_logp: bool,
                 top_k: int, top_p):
    """(g_params, feats [B,R,F], generator=None, noise=None) → tokens
    int32[B, K, 3] through the generator's forward, hard, at temperature 1."""
    if with_logp:
        raise NotImplementedError(f"with_logp (log-prob ranking) {_LATER_A4}")
    if tau is not None and float(tau) != 1.0:
        raise NotImplementedError(f"sampling temperature other than 1.0 {_LATER_A4}")
    if top_k or top_p is not None:
        raise NotImplementedError(f"top-k/top-p sampling {_LATER_A4}")
    gen = make_generator(cfg).requires_grad_(False).eval()
    mask = None if step_mask is None else torch.as_tensor(step_mask, dtype=torch.bool)
    dtype, Z, V = cfg.model.dtype, cfg.model.noise_dim, cfg.model.vocab_size
    loaded = {"params": None}

    def body(g_params, feats, generator=None, noise=None):
        dev = feats.device
        if loaded["params"] is not g_params:  # load each weights dict once
            gen.load_state_dict(g_params)
            gen.to(dev)
            loaded["params"] = g_params
        m = None if mask is None else mask.to(dev)
        B = feats.shape[0]
        toks = []
        with torch.no_grad():
            for i in range(num_samples):
                z, g = _draw(noise, i, B, Z, V, dtype, dev, generator)
                out = gen(feats, z, g, tau=1.0, hard=True, step_mask=m)
                toks.append(out["tokens"].to(torch.int32))
        return torch.stack(toks, dim=1)  # [B, K, 3]

    return body


def make_sampler(
    cfg: Config, step_mask=None, num_samples: int = 50, tau: float | None = None,
    with_logp: bool = False, top_k: int = 0, top_p: float | None = None,
):
    """Build ``sample(g_params, feats [B,R,F], generator=None, noise=None)`` →
    tokens int32[B, K, 3] on the feats' device, through the forward of the
    generator ``cfg.model.decoder`` names. ``g_params`` is its state_dict.
    Each draw takes z ~ N(0, 1) [B, Z] and Gumbel noise [B, 3, V] from
    ``generator`` (a torch.Generator on the feats' device), or from ``noise
    = (z [K,B,Z], gumbel [K,B,3,V])`` when given, so that a test can feed the
    reference's own draws. Only temperature 1 and ``with_logp=False`` are
    ported."""
    return _sample_body(cfg, step_mask, num_samples, tau, with_logp, top_k, top_p)


def make_indexed_sampler(
    cfg: Config, step_mask=None, num_samples: int = 50, tau: float | None = None,
    with_logp: bool = False, top_k: int = 0, top_p: float | None = None,
):
    """As :func:`make_sampler`, gathering the batch from a device-resident
    feature store: ``sample(g_params, feats_dev [N,R,F], idx [B],
    generator=None, noise=None)``."""
    body = _sample_body(cfg, step_mask, num_samples, tau, with_logp, top_k, top_p)

    def sample(g_params, feats_dev, idx, generator=None, noise=None):
        idx = torch.as_tensor(idx, dtype=torch.long, device=feats_dev.device)
        return body(g_params, feats_dev.index_select(0, idx), generator, noise)

    return sample


def make_fused_sampler(
    cfg: Config, step_mask=None, num_samples: int = 50,
    tau: float | None = None, indexed: bool = False,
):
    """Build the K-draw sampler → tokens int32[B, K, 3] on the feats' device.

    ``sample(g_params, feats [B,R,F], generator, noise=None)``, or with
    ``indexed=True`` ``sample(g_params, feats_dev [N,R,F], idx, generator,
    noise=None)``, which gathers the batch from a device-resident feature
    store. ``g_params`` is the port generator's state_dict. Each draw takes
    z ~ N(0, 1) [B, Z] and Gumbel noise [B, 3, V] from ``generator`` (a
    torch.Generator on the feats' device), or from ``noise = (z [K,B,Z],
    gumbel [K,B,3,V])`` when given, so that a test can feed the reference's
    own draws.
    """
    if cfg.model.decoder != "lstm":
        raise ValueError(
            f"fused decode runs the attention-LSTM decoder only, not "
            f"{cfg.model.decoder!r}; use the generator-forward sampler (make_sampler)"
        )
    if tau is not None and float(tau) != 1.0:
        # argmax((logits + g) / tau) does not depend on tau, so a requested
        # temperature would silently do nothing.
        raise ValueError(
            f"fused decode samples at temperature 1.0 only; temperature other "
            f"than 1.0 {_LATER_A4}"
        )
    dtype = cfg.model.dtype
    Z = cfg.model.noise_dim

    def _tokens(g_params, feats, generator, noise):
        feats = feats.to(dtype)
        dev = feats.device
        params = decode_params_from_generator(g_params, dtype, dev)
        mask_bias = None if step_mask is None else step_mask_bias(step_mask, dev)
        B = feats.shape[0]
        V = params["wv"].shape[1]
        toks = []
        for i in range(num_samples):
            z, g = _draw(noise, i, B, Z, V, dtype, dev, generator)
            y = fused_decode(params, feats, z, g, tau=1.0, mask_bias=mask_bias, hard=True)
            toks.append(torch.argmax(y, dim=-1).to(torch.int32))
        return torch.stack(toks, dim=1)  # [B, K, 3]

    if indexed:
        def sample(g_params, feats_dev, idx, generator=None, noise=None):
            idx = torch.as_tensor(idx, dtype=torch.long, device=feats_dev.device)
            return _tokens(g_params, feats_dev.index_select(0, idx), generator, noise)
    else:
        def sample(g_params, feats, generator=None, noise=None):
            return _tokens(g_params, feats, generator, noise)
    return sample


def device_put_features(
    features: np.ndarray, device, dtype: torch.dtype, chunk_bytes: int = 64 << 20,
) -> torch.Tensor:
    """Upload a [N,R,F] feature array to ``device`` in bounded chunks, cast to
    ``dtype`` there, so the peak is the store plus one chunk."""
    store = torch.empty(features.shape, dtype=dtype, device=device)
    n = features.shape[0]
    per = max(1, chunk_bytes // (features[0].nbytes if n else 1))
    for lo in range(0, n, per):
        store[lo : lo + per] = torch.from_numpy(features[lo : lo + per]).to(device)
    return store


def rank_triples(tokens: np.ndarray, rank: str = "freq") -> list[tuple[int, int, int]]:
    """Rank one image's K sampled triples → deduped [(s,p,o)], best first:
    sample count descending, ties by first-sampled order. Only ``freq`` is
    ported; the log-prob orderings come with a later slice (ROADMAP A4)."""
    if rank != "freq":
        raise ValueError(f"rank={rank!r} is not ported yet (only 'freq')")
    tokens = np.asarray(tokens).reshape(-1, 3)
    counts: dict = {}
    first: dict = {}
    for i, row in enumerate(tokens):
        t = (int(row[0]), int(row[1]), int(row[2]))
        counts[t] = counts.get(t, 0) + 1
        if t not in first:
            first[t] = i
    return sorted(counts, key=lambda t: (-counts[t], first[t]))


def assemble_scene_graphs(
    tokens: np.ndarray, vocab: Vocab, image_ids, rank: str = "freq",
) -> tuple[list[dict], list[list[tuple[int, int, int]]]]:
    """Batch dedupe/aggregate: tokens int[B, K, 3] → (graphs, id_triples).

    One corpus-wide ``np.unique``; each image's triples ordered by count
    descending, ties lexicographic. ``id_triples`` lists each image's unique
    (s,p,o) id triples in the graph's order, for recall scoring.
    """
    if rank != "freq":
        raise ValueError(f"rank={rank!r} is not ported yet (only 'freq')")
    tokens = np.asarray(tokens)
    B, K, _ = tokens.shape
    img = np.repeat(np.arange(B, dtype=np.int64), K)[:, None]
    flat = np.concatenate([img, tokens.reshape(-1, 3)], axis=1)
    uniq, counts = np.unique(flat, axis=0, return_counts=True)
    order = np.lexsort((-counts,))  # count desc, ties lexicographic
    order = order[np.argsort(uniq[order, 0], kind="stable")]  # image-major
    uniq, counts = uniq[order], counts[order]
    bounds = np.searchsorted(uniq[:, 0], np.arange(B + 1))

    decode_cache: dict = {}
    graphs, id_triples = [], []
    for b in range(B):
        triples, ids = [], []
        for j in range(bounds[b], bounds[b + 1]):
            row, c = uniq[j, 1:], counts[j]
            t = (int(row[0]), int(row[1]), int(row[2]))
            ids.append(t)
            names = decode_cache.get(t)
            if names is None:
                names = decode_cache[t] = vocab.decode_triple(t)
            triples.append({"subject": names[0], "predicate": names[1],
                            "object": names[2], "count": int(c)})
        graphs.append({"triples": triples, "image_id": int(image_ids[b])})
        id_triples.append(ids)
    return graphs, id_triples
