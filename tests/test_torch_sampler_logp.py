"""The rest of the XLA sampler against the reference: both decoders with
``detach_sample`` (identical tokens, the straight-through path's for the same
noise, and ``log_prob`` within 1e-5 absolute in float32), the sampling
temperature (scalar and per row) and top-k/top-p (identical tokens), through
``make_sampler``/``make_indexed_sampler`` on the reference's own draws; and
``rank_triples`` in all three modes with ``pred_adjust``,
``assemble_scene_graphs`` with log-probabilities and
``assemble_scene_graph`` (identical).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.config import get_config as jax_get_config
from sgg.data.vocab import Vocab as JaxVocab
from sgg.eval import assemble_scene_graphs as jax_assemble
from sgg.eval import rank_triples as jax_rank_triples
from sgg.eval.sampler import assemble_scene_graph as jax_assemble_one
from sgg.eval.sampler import make_indexed_sampler as jax_make_indexed_sampler
from sgg.eval.sampler import make_sampler as jax_make_sampler
from sgg.kernels.fused_decode import decode_gumbel_noise
from sgg.train.state import make_models
from sgg.utils.gumbel import sample_gumbel as jax_sample_gumbel
from sgg.utils.gumbel import top_k_top_p_filter as jax_filter
from sgg_torch.config import Config as PortConfig
from sgg_torch.convert_flax import generator_flax_to_state_dict
from sgg_torch.data import Vocab
from sgg_torch.eval.sampler import (
    assemble_scene_graph,
    assemble_scene_graphs,
    make_indexed_sampler,
    make_sampler,
    rank_triples,
)
from sgg_torch.train.state import make_generator
from sgg_torch.utils.gumbel import top_k_top_p_filter

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, K, B = 40, 4, 6
LOGP_TOL = 1e-5


def _cfg(decoder):
    cfg = jax_get_config("smoke")
    cfg.model.vocab_size = V
    if decoder == "transformer":
        cfg.model.decoder = "transformer"
        cfg.model.num_layers, cfg.model.num_heads = 2, 4
    return cfg


@pytest.fixture(scope="module", params=["lstm", "transformer"])
def setup(request):
    cfg = _cfg(request.param)
    gen, _ = make_models(cfg)
    r = np.random.RandomState(0)
    feats = r.randn(B, cfg.data.regions, cfg.data.feat_dim).astype(np.float32)
    z = r.randn(B, cfg.model.noise_dim).astype(np.float32)
    params = gen.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(z),
                      jax.random.key(1))["params"]
    mask = np.zeros((3, V), bool)
    mask[0, :20] = mask[2, :20] = True
    mask[1, 20:] = True
    sd = generator_flax_to_state_dict(jax.tree.map(np.asarray, params), cfg)
    return cfg, PortConfig.from_json(cfg.to_json()), gen, params, sd, feats, mask


def _gumbel(cfg, key, n):
    """The decoder's Gumbel noise from its key: per-step splits for the
    attention-LSTM, one [n, 3, V] draw for the slot decoder."""
    if cfg.model.decoder == "lstm":
        return np.array(decode_gumbel_noise(key, n, V))
    return np.array(jax_sample_gumbel(key, (n, 3, V), jnp.float32))


def _reference_noise(cfg, rng, n):
    zs, gs = [], []
    for key in jax.random.split(rng, K):
        kz, kg = jax.random.split(key)
        zs.append(np.array(jax.random.normal(kz, (n, cfg.model.noise_dim), cfg.model.dtype)))
        gs.append(_gumbel(cfg, kg, n))
    return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(gs))


def test_detach_sample_tokens_and_log_prob_match_reference(setup):
    cfg, pcfg, gen, params, sd, feats, mask = setup
    port = make_generator(pcfg)
    port.load_state_dict(sd)
    z = np.random.RandomState(1).randn(B, cfg.model.noise_dim).astype(np.float32)
    key = jax.random.key(3)
    g = torch.from_numpy(_gumbel(cfg, key, B))
    args = (torch.from_numpy(feats), torch.from_numpy(z), g)
    for temp in (None, 0.7):
        want = gen.apply({"params": params}, jnp.asarray(feats), jnp.asarray(z), key, tau=1.0,
                         hard=True, step_mask=mask, detach_sample=True, sample_temp=temp)
        with torch.no_grad():
            got = port(*args, tau=1.0, hard=True, step_mask=torch.from_numpy(mask),
                       detach_sample=True, sample_temp=temp)
            straight = port(*args, tau=1.0, hard=True, step_mask=torch.from_numpy(mask),
                            sample_temp=temp)
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        np.testing.assert_array_equal(straight["tokens"].numpy(), got["tokens"].numpy())
        assert got["log_prob"].dtype == torch.float32 and got["log_prob"].shape == (B,)
        np.testing.assert_allclose(got["log_prob"].numpy(), np.asarray(want["log_prob"]),
                                   rtol=0, atol=LOGP_TOL)
        np.testing.assert_array_equal(got["soft"].numpy(), np.asarray(want["soft"]))
    # Forced steps, refused before PredCls was ported, clamp the draw
    # (tests/test_torch_predcls.py holds them against the reference).
    forced = torch.full((B, 3), 21, dtype=torch.long)
    with torch.no_grad():
        got = port(*args, tau=1.0, hard=True, step_mask=torch.from_numpy(mask),
                   detach_sample=True, forced_steps=(1,), forced_tokens=forced)
    assert torch.equal(got["tokens"][:, 1], forced[:, 1])
    assert bool(torch.isfinite(got["log_prob"]).all())


SAMPLER_CASES = [
    dict(with_logp=True), dict(with_logp=False, tau=0.5), dict(with_logp=True, temp="row"),
    dict(with_logp=False, top_k=3), dict(with_logp=True, top_p=0.8),
    dict(with_logp=True, tau=1.5, top_k=5, top_p=0.9),
]


@pytest.mark.parametrize("case", SAMPLER_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_sampler_options_match_reference(setup, case):
    cfg, pcfg, _, params, sd, feats, mask = setup
    case = dict(case)
    temp = case.pop("temp", None)
    if temp == "row":
        temp = np.linspace(0.5, 2.0, B).astype(np.float32)
    rng = jax.random.key(7)
    noise = _reference_noise(cfg, rng, B)
    port = make_sampler(pcfg, step_mask=mask, num_samples=K, **case)
    got = port(sd, torch.from_numpy(feats), noise=noise,
               temp=None if temp is None else torch.from_numpy(temp))
    if cfg.model.decoder == "transformer" and temp is not None:
        # The reference's slot decoder cannot broadcast a per-row temperature
        # [B, 1] against its [B, 3, V] logits; the port's takes it row by
        # row, as the scalar temperature of each row.
        with pytest.raises(ValueError, match="broadcast"):
            jax_make_sampler(cfg, step_mask=mask, num_samples=K, **case)(
                params, jnp.asarray(feats), rng, temp)
        for b in range(B):
            one = port(sd, torch.from_numpy(feats), noise=noise, temp=float(temp[b]))
            np.testing.assert_array_equal(got[0][b].numpy(), one[0][b].numpy())
            np.testing.assert_array_equal(got[1][b].numpy(), one[1][b].numpy())
        return
    want = jax_make_sampler(cfg, step_mask=mask, num_samples=K, **case)(
        params, jnp.asarray(feats), rng, temp)
    if case["with_logp"]:
        (tok, lp), (wtok, wlp) = got, want
        assert lp.dtype == torch.float32 and lp.shape == (B, K)
        np.testing.assert_allclose(lp.numpy(), np.asarray(wlp), rtol=0, atol=LOGP_TOL)
    else:
        tok, wtok = got, want
    assert tok.dtype == torch.int32 and tok.shape == (B, K, 3)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(wtok))


def test_indexed_sampler_with_logp_matches_reference(setup):
    cfg, pcfg, _, params, sd, feats, mask = setup
    rng = jax.random.key(11)
    idx = np.array([4, 1, 5, 0], np.int32)
    wtok, wlp = jax_make_indexed_sampler(cfg, step_mask=mask, num_samples=K, with_logp=True)(
        params, jnp.asarray(feats), jnp.asarray(idx), rng, 0.8)
    tok, lp = make_indexed_sampler(pcfg, step_mask=mask, num_samples=K, with_logp=True)(
        sd, torch.from_numpy(feats), idx, noise=_reference_noise(cfg, rng, len(idx)), temp=0.8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(wtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(wlp), rtol=0, atol=LOGP_TOL)


def test_top_k_top_p_filter_matches_reference():
    """Identical at p away from float32 rounding of a cumulative sum. XLA and
    torch sum the softmax and its prefix sums in other orders, so where a
    cumulative sum rounds across p (as tail sums do at p = 1.0) the two may
    keep different tails."""
    x = np.random.RandomState(2).randn(7, 33).astype(np.float32) * 3
    x[:, 5] = -1e9  # a masked token stays masked
    for k, p in ((0, None), (4, None), (0, 0.5), (6, 0.9), (0, 0.75), (33, 0.3)):
        np.testing.assert_array_equal(top_k_top_p_filter(torch.from_numpy(x), k, p).numpy(),
                                      np.asarray(jax_filter(jnp.asarray(x), k, p)))


def _draws(seed=0, n_img=5, k=16):
    r = np.random.RandomState(seed)
    tokens = r.randint(0, 4, size=(n_img, k, 3)).astype(np.int32)  # many repeats
    logp = (-r.gamma(2.0, 2.0, size=(n_img, k))).astype(np.float32)
    return tokens, logp


def test_rank_triples_all_modes_match_reference():
    tokens, logp = _draws()
    adj = np.random.RandomState(3).randn(V) * 0.5
    for row, lp in zip(tokens, logp):
        for rank in ("freq", "freq_logp", "logp"):
            assert rank_triples(row, lp, rank=rank) == jax_rank_triples(row, lp, rank=rank)
        assert rank_triples(row, lp, rank="logp", pred_adjust=adj) == \
            jax_rank_triples(row, lp, rank="logp", pred_adjust=adj)
    with pytest.raises(ValueError):
        rank_triples(tokens[0], None, rank="logp")
    with pytest.raises(ValueError):
        rank_triples(tokens[0], logp[0], rank="freq", pred_adjust=adj)


@pytest.mark.parametrize("rank", ["freq", "freq_logp", "logp"])
def test_assemble_scene_graphs_match_reference(rank):
    path = os.path.join(REPO, "results", "run_v3_bal0.7_ckpt", "vocab.json")
    tokens, logp = _draws(1)
    ids = np.arange(200, 205)
    lp = None if rank == "freq" else logp
    got = assemble_scene_graphs(tokens, Vocab.load(path), ids, logp=lp, rank=rank)
    want = jax_assemble(tokens, JaxVocab.load(path), ids, logp=lp, rank=rank)
    assert got == want
    if rank == "freq":
        got_lp = assemble_scene_graphs(tokens, Vocab.load(path), ids, logp=logp)
        assert got_lp == jax_assemble(tokens, JaxVocab.load(path), ids, logp=logp)
        for row, i in zip(tokens, ids):
            assert assemble_scene_graph(row, Vocab.load(path), int(i)) == \
                jax_assemble_one(row, JaxVocab.load(path), int(i))
