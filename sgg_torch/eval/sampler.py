"""Batched scene-graph sampling, from ``sgg/eval/sampler.py``.

Per image batch, K noise draws, each a hard Gumbel-max triple, then the K
triples of each image are deduped and ranked. Two samplers draw the tokens:
  - :func:`make_sampler` / :func:`make_indexed_sampler` run the generator's
    own forward (either decoder), the reference's XLA sampler, with its
    options: a sampling temperature (a default ``tau`` and a per-call
    ``temp``, a number or one per row), top-k/top-p, and ``with_logp``,
    which draws in the decoders' ``detach_sample`` mode (the same tokens for
    the same noise) and also returns each draw's untempered joint
    log-probability;
  - :func:`make_fused_sampler` runs one launch of ``fused_decode`` per draw
    (attention-LSTM only, temperature 1, no log-probabilities);
  - :func:`make_dp_sampler` splits the batch's rows over a single-process
    mesh's devices and runs :func:`make_sampler`'s body on each.
:func:`make_predcls_scorer` scores predicates given the ground-truth
subject and object (PredCls) through the same forward, clamped.
:func:`rank_triples` orders an image's draws by frequency (``freq``),
frequency with a log-probability tiebreak (``freq_logp``) or probability
mass (``logp``, optionally adjusted per predicate);
:func:`assemble_scene_graphs` does the same for a batch at once.
"""

from __future__ import annotations

import contextlib
import math

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


def _draw(noise, i, B, Z, V, dtype, dev, generator):
    """Draw i's z [B, Z] in ``dtype`` and Gumbel noise [B, 3, V] float32:
    from ``noise = (z [K,B,Z], gumbel [K,B,3,V])`` when given, else from
    ``generator``."""
    if noise is None:
        z = torch.randn(B, Z, generator=generator, device=dev).to(dtype)
        return z, sample_gumbel((B, TRIPLE_LEN, V), generator, device=dev)
    z = noise[0][i].to(device=dev, dtype=dtype).contiguous()
    return z, noise[1][i].to(device=dev, dtype=torch.float32).contiguous()


def draw_noise(generator: torch.Generator, num_samples: int, B: int, Z: int, V: int,
               dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(z [K,B,Z] in dtype, gumbel [K,B,3,V] float32)``: the draws that
    :func:`make_sampler` takes from ``generator`` for one batch, in its
    order, so that sampling with this ``noise`` gives its tokens."""
    draws = [_draw(None, i, B, Z, V, dtype, device, generator) for i in range(num_samples)]
    return torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws])


def draw_tokens(gen, feats, z, g, mask, temp, with_logp: bool = False, top_k: int = 0,
                top_p=None):
    """One hard draw of ``gen`` on feats [B, R, F] with z [B, Z] and Gumbel
    noise g [B, 3, V]: tokens int32 [B, 3] (with ``with_logp`` also the
    untempered joint logp float32 [B]), at temperature ``temp`` (float32 on
    the feats' device) under step mask ``mask`` (bool [3, V] or None).
    ``sgg_torch.export`` maps it over an artifact's K draws."""
    out = gen(feats, z, g, tau=1.0, hard=True, step_mask=mask, detach_sample=with_logp,
              sample_temp=temp, sample_top_k=top_k, sample_top_p=top_p)
    tokens = out["tokens"].to(torch.int32)
    return (tokens, out["log_prob"].float()) if with_logp else tokens


def sample_draws(cfg: Config, gen, feats, num_samples: int, mask, temp, generator=None,
                 noise=None, with_logp: bool = False, top_k: int = 0, top_p=None):
    """The K-draw loop of :func:`make_sampler` on ``gen``, the built
    generator of ``cfg``: :func:`draw_tokens` K times, stacked to tokens
    int32 [B, K, 3] (with ``with_logp`` also logp float32 [B, K])."""
    m = cfg.model
    draws = []
    for i in range(num_samples):
        z, g = _draw(noise, i, feats.shape[0], m.noise_dim, m.vocab_size, m.dtype,
                     feats.device, generator)
        draws.append(draw_tokens(gen, feats, z, g, mask, temp, with_logp, top_k, top_p))
    if with_logp:
        return (torch.stack([d[0] for d in draws], dim=1),
                torch.stack([d[1] for d in draws], dim=1))
    return torch.stack(draws, dim=1)  # [B, K, 3]


def _sample_body(cfg: Config, step_mask, num_samples: int, tau, with_logp: bool,
                 top_k: int, top_p):
    """(g_params, feats [B,R,F], generator=None, noise=None, temp=None) →
    tokens int32[B, K, 3], or with ``with_logp`` (tokens, logp float32[B, K]),
    through the generator's forward, hard. ``temp`` (a number or float32
    [B]) overrides the default temperature ``tau`` (None ≡ 1.0)."""
    gen = make_generator(cfg).requires_grad_(False).eval()
    mask = None if step_mask is None else torch.as_tensor(step_mask, dtype=torch.bool)
    default = 1.0 if tau is None else float(tau)
    loaded = {"params": None}

    def body(g_params, feats, generator=None, noise=None, temp=None):
        dev = feats.device
        if loaded["params"] is not g_params:  # load each weights dict once
            gen.load_state_dict(g_params)
            gen.to(dev)
            loaded["params"] = g_params
        m = None if mask is None else mask.to(dev)
        st = torch.as_tensor(default if temp is None else temp, dtype=torch.float32,
                             device=dev)
        with torch.no_grad():
            return sample_draws(cfg, gen, feats, num_samples, m, st, generator, noise,
                                with_logp, top_k, top_p)

    return body


def make_sampler(
    cfg: Config, step_mask=None, num_samples: int = 50, tau: float | None = None,
    with_logp: bool = False, top_k: int = 0, top_p: float | None = None,
):
    """Build ``sample(g_params, feats [B,R,F], generator=None, noise=None,
    temp=None)`` → tokens int32[B, K, 3] on the feats' device (with
    ``with_logp``: ``(tokens, logp float32[B, K])``, each draw's untempered
    joint log-probability), through the forward of the generator
    ``cfg.model.decoder`` names. ``g_params`` is its state_dict. Each draw
    takes z ~ N(0, 1) [B, Z] and Gumbel noise [B, 3, V] from ``generator``
    (a torch.Generator on the feats' device), or from ``noise = (z [K,B,Z],
    gumbel [K,B,3,V])`` when given, so that a test can feed the reference's
    own draws. Tokens are drawn at temperature ``temp`` (default ``tau``,
    None ≡ 1.0; a number or float32 [B] per row) after top-k/top-p
    filtering (``top_k`` 0 and ``top_p`` None: off)."""
    return _sample_body(cfg, step_mask, num_samples, tau, with_logp, top_k, top_p)


def make_dp_sampler(
    cfg: Config, mesh, step_mask=None, num_samples: int = 50, tau: float | None = None,
    with_logp: bool = False, top_k: int = 0, top_p: float | None = None,
):
    """Data-parallel batch inference over a single-process mesh
    (``sgg_torch.dist.make_mesh``): ``sample(g_params, feats [B,R,F],
    generator=None, noise=None, temp=None)`` as :func:`make_sampler`'s, with
    the batch split into ``mesh.data`` contiguous row chunks, one per device
    of the mesh (B must divide), each chunk's noise rows and temperatures
    beside it. Each chunk runs on its device (on its own stream on CUDA) and
    the results come back concatenated on the mesh's first device. Rows are
    independent, so there is no collective: given the same noise, or the
    same ``generator`` (whose K draws for the whole batch are taken first, on
    its device, in :func:`make_sampler`'s order), the tokens and log-probs
    are :func:`make_sampler`'s."""
    devices = list(mesh.devices)
    bodies = [_sample_body(cfg, step_mask, num_samples, tau, with_logp, top_k, top_p)
              for _ in devices]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]
    m = cfg.model

    def sample(g_params, feats, generator=None, noise=None, temp=None):
        B, n = feats.shape[0], len(devices)
        if B % n:
            raise ValueError(f"batch {B} not divisible by the mesh's data axis ({n})")
        if noise is None:
            noise = draw_noise(generator, num_samples, B, m.noise_dim, m.vocab_size, m.dtype,
                               generator.device)
        per_row = (torch.is_tensor(temp) and temp.ndim == 1) or isinstance(temp, np.ndarray)
        per, outs = B // n, []
        for body, dev, stream, j in zip(bodies, devices, streams, range(n)):
            rows = slice(j * per, (j + 1) * per)
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            with ctx:
                if stream is not None and feats.device.type == "cuda":
                    stream.wait_stream(torch.cuda.current_stream(feats.device))
                outs.append(body(g_params, feats[rows].to(dev),
                                 noise=(noise[0][:, rows].to(dev), noise[1][:, rows].to(dev)),
                                 temp=temp[rows] if per_row else temp))
        home = devices[0]
        for stream in streams:
            if stream is not None:
                torch.cuda.current_stream(home).wait_stream(stream)
        if with_logp:
            return (torch.cat([o[0].to(home) for o in outs]),
                    torch.cat([o[1].to(home) for o in outs]))
        return torch.cat([o.to(home) for o in outs])

    return sample


def make_indexed_sampler(
    cfg: Config, step_mask=None, num_samples: int = 50, tau: float | None = None,
    with_logp: bool = False, top_k: int = 0, top_p: float | None = None,
):
    """As :func:`make_sampler`, gathering the batch from a device-resident
    feature store: ``sample(g_params, feats_dev [N,R,F], idx [B],
    generator=None, noise=None, temp=None)``."""
    body = _sample_body(cfg, step_mask, num_samples, tau, with_logp, top_k, top_p)

    def sample(g_params, feats_dev, idx, generator=None, noise=None, temp=None):
        idx = torch.as_tensor(idx, dtype=torch.long, device=feats_dev.device)
        return body(g_params, feats_dev.index_select(0, idx), generator, noise, temp)

    return sample


def make_predcls_scorer(cfg: Config, step_mask=None, num_samples: int = 16,
                        tau: float | None = None):
    """Build the PredCls scorer ``score(g_params, feats [B,R,F], subj [B],
    obj [B], generator=None, z=None)`` → float32 [B, V], log p(predicate |
    subject, object, image).

    The decode is clamped to the ground-truth subject at step 0 and object at
    step 2 (inert for the predicate step's logits under the s→p→o order), and
    the predicate step's log-softmax is mixture-averaged over K =
    ``num_samples`` noise draws: logsumexp_k log_softmax(logits_k[:, 1]) −
    log K. The predicate logits come before any unclamped draw, so z [K, B, Z]
    is the only noise: given, or drawn from ``generator`` (a torch.Generator
    on the feats' device). The K draws run as one forward over K·B rows (k
    major); rows are independent. For the slot decoder the clamp cannot
    condition the predicate slot, so this scores the marginal predicate
    distribution, as the reference does. ``tau`` is accepted for the CLI's
    symmetry and unused: the score reads the logits, not a draw."""
    del tau
    gen = make_generator(cfg).requires_grad_(False).eval()
    mask = None if step_mask is None else torch.as_tensor(step_mask, dtype=torch.bool)
    dtype, Z, V, K = cfg.model.dtype, cfg.model.noise_dim, cfg.model.vocab_size, num_samples
    loaded = {"params": None}

    def score(g_params, feats, subj, obj, generator=None, z=None):
        dev = feats.device
        if loaded["params"] is not g_params:  # load each weights dict once
            gen.load_state_dict(g_params)
            gen.to(dev)
            loaded["params"] = g_params
        B = feats.shape[0]
        if z is None:
            z = torch.randn(K, B, Z, generator=generator, device=dev)
        z = z.to(device=dev, dtype=dtype).reshape(K * B, Z)
        subj = torch.as_tensor(subj, dtype=torch.long, device=dev)
        obj = torch.as_tensor(obj, dtype=torch.long, device=dev)
        forced = torch.stack([subj, torch.zeros_like(subj), obj], dim=1).repeat(K, 1)
        rows = feats.unsqueeze(0).expand(K, *feats.shape).reshape(K * B, *feats.shape[1:])
        m = None if mask is None else mask.to(dev)
        # Step 1's draw does not reach its own logits; its noise is zero.
        g = torch.zeros(K * B, TRIPLE_LEN, V, device=dev)
        with torch.no_grad():
            out = gen(rows, z, g, tau=1.0, hard=True, step_mask=m, forced_tokens=forced,
                      forced_steps=(0, 2))
            lps = torch.log_softmax(out["logits"][:, 1].float(), dim=-1).reshape(K, B, V)
            return torch.logsumexp(lps, dim=0) - math.log(K)

    return score


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
            "fused decode samples at temperature 1.0 only; use the generator-forward "
            "sampler (--decode xla) for --temperature"
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


def rank_triples(
    tokens: np.ndarray, logp: np.ndarray | None = None, rank: str = "freq",
    pred_adjust: np.ndarray | None = None,
) -> list[tuple[int, int, int]]:
    """Rank one image's K sampled triples → deduped [(s,p,o)], best first.

    ``tokens`` int[K, 3]; ``logp`` float[K], each draw's joint
    log-probability (``with_logp=True`` on the samplers), or None. Modes:
      - ``freq``: sample count descending, ties by first-sampled order;
      - ``freq_logp``: count descending, ties by the triple's aggregated
        log-probability descending;
      - ``logp``: per unique triple, the logsumexp of its draws'
        log-probabilities, descending.
    ``pred_adjust`` (float[V], ``logp`` only) is subtracted per predicate
    from each triple's aggregated score (logit adjustment for the long
    predicate tail).
    """
    tokens = np.asarray(tokens).reshape(-1, 3)
    if rank != "freq" and logp is None:
        raise ValueError(f"rank={rank!r} needs per-draw log-probs")
    counts: dict = {}
    first: dict = {}
    agg: dict = {}
    for i, row in enumerate(tokens):
        t = (int(row[0]), int(row[1]), int(row[2]))
        counts[t] = counts.get(t, 0) + 1
        if t not in first:
            first[t] = i
        if logp is not None:
            lp = float(logp[i])
            agg[t] = float(np.logaddexp(agg[t], lp)) if t in agg else lp
    if pred_adjust is not None and rank != "logp":
        raise ValueError("pred_adjust applies to rank='logp' only")
    if rank == "freq":
        key = lambda t: (-counts[t], first[t])  # noqa: E731
    elif rank == "freq_logp":
        key = lambda t: (-counts[t], -agg[t])  # noqa: E731
    elif rank == "logp":
        if pred_adjust is not None:
            adj = np.asarray(pred_adjust, np.float64)
            key = lambda t: -(agg[t] - adj[t[1]])  # noqa: E731
        else:
            key = lambda t: -agg[t]  # noqa: E731
    else:
        raise ValueError(f"unknown rank mode {rank!r}")
    return sorted(counts, key=key)


def assemble_scene_graphs(
    tokens: np.ndarray, vocab: Vocab, image_ids,
    logp: np.ndarray | None = None, rank: str = "freq",
) -> tuple[list[dict], list[list[tuple[int, int, int]]]]:
    """Batch dedupe/aggregate: tokens int[B, K, 3] → (graphs, id_triples).

    One corpus-wide ``np.unique``. ``freq`` orders each image's triples by
    count descending, ties lexicographic; with ``logp`` float[B, K]
    (per-draw log-probabilities) ``freq_logp`` breaks count ties by the
    triple's aggregated log-probability (a segmented logsumexp) and ``logp``
    orders by it alone, and each triple dict gains its ``"logp"``.
    ``id_triples`` lists each image's unique (s,p,o) id triples in the
    graph's order, for recall scoring.
    """
    tokens = np.asarray(tokens)
    B, K, _ = tokens.shape
    img = np.repeat(np.arange(B, dtype=np.int64), K)[:, None]
    flat = np.concatenate([img, tokens.reshape(-1, 3)], axis=1)
    uniq, inverse, counts = np.unique(
        flat, axis=0, return_inverse=True, return_counts=True
    )
    inverse = np.asarray(inverse).reshape(-1)
    group_lp = None
    if logp is not None:
        # Segmented logsumexp of draw log-probs per unique (img, s, p, o).
        lp = np.asarray(logp, np.float64).reshape(-1)
        order = np.argsort(inverse, kind="stable")
        starts = np.r_[0, np.cumsum(counts)[:-1]]
        m = np.maximum.reduceat(lp[order], starts)
        sums = np.add.reduceat(np.exp(lp[order] - np.repeat(m, counts)), starts)
        group_lp = m + np.log(sums)
    if rank == "freq":
        order = np.lexsort((-counts,))  # count desc, ties lexicographic
    elif rank == "freq_logp":
        if group_lp is None:
            raise ValueError("rank='freq_logp' needs logp")
        order = np.lexsort((-group_lp, -counts))
    elif rank == "logp":
        if group_lp is None:
            raise ValueError("rank='logp' needs logp")
        order = np.lexsort((-group_lp,))
    else:
        raise ValueError(f"unknown rank mode {rank!r}")
    order = order[np.argsort(uniq[order, 0], kind="stable")]  # image-major
    uniq, counts = uniq[order], counts[order]
    if group_lp is not None:
        group_lp = group_lp[order]
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
            d = {"subject": names[0], "predicate": names[1],
                 "object": names[2], "count": int(c)}
            if group_lp is not None:
                d["logp"] = float(group_lp[j])
            triples.append(d)
        graphs.append({"triples": triples, "image_id": int(image_ids[b])})
        id_triples.append(ids)
    return graphs, id_triples


def assemble_scene_graph(tokens: np.ndarray, vocab: Vocab, image_id: int | None = None
                         ) -> dict:
    """One image's K sampled triples (int[K, 3]) as a deduped scene graph,
    triples ordered by sample count (ties lexicographic)."""
    uniq, counts = np.unique(np.asarray(tokens).reshape(-1, 3), axis=0,
                             return_counts=True)
    order = np.argsort(-counts, kind="stable")
    triples = []
    for i in order:
        s, p, o = (int(x) for x in uniq[i])
        subj, pred, obj = vocab.decode_triple((s, p, o))
        triples.append({"subject": subj, "predicate": pred, "object": obj,
                        "count": int(counts[i])})
    out = {"triples": triples}
    if image_id is not None:
        out["image_id"] = int(image_id)
    return out
