"""Forced steps and PredCls against the reference.

- Both decoders' forward with ``forced_steps`` (0,), (0, 2) and (1,), with
  and without ``detach_sample``, against ``gen.apply(..., forced_tokens=,
  forced_steps=)`` on the same weights and the reference's own noise: float32
  logits within 1e-5 x max|ref|, soft within 1e-5, ``log_prob`` within 1e-5,
  identical tokens; the forced tokens land where forced, and a call that
  forces nothing is unchanged by ``forced_tokens``.
- ``make_predcls_scorer`` against ``sgg.eval.make_predcls_scorer`` on z drawn
  along the reference's key splits: on both small decoders and on the trained
  ``results/run_v3_bal0.7_ckpt`` weights (vg1k widths, V = 210, float32): the
  legal predicates' scores within 1e-4, the masked ones below -1e8 in both,
  and identical P-R@k.
- ``evaluate --predcls`` in both CLIs on a smoke-width ``pipeline_v4``
  workdir, with their samplers, weights and scorers replaced by the same
  function of the rows they are given: identical ``predcls (...)`` lines;
  and the port's CLI end to end on that workdir with ``--ema --avg-last 5``.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.config import get_config as jax_get_config
from sgg.eval import make_predcls_scorer as jax_make_predcls_scorer
from sgg.eval import predicate_recall as jax_predicate_recall
from sgg.train.checkpoint import CheckpointManager as JaxCheckpointManager
from sgg.train.checkpoint import load_workdir as jax_load_workdir
from sgg.train.state import create_train_state as jax_create_train_state
from sgg.train.state import make_models
from sgg_torch.cli import evaluate
from sgg_torch.config import Config as PortConfig
from sgg_torch.convert_flax import generator_flax_to_state_dict, generator_state_dict_to_flax
from sgg_torch.eval.recall import predicate_recall
from sgg_torch.eval.sampler import make_predcls_scorer
from sgg_torch.train.state import make_generator
from test_torch_evaluate import corpus, v4_workdir  # noqa: F401
from test_torch_sampler_logp import _gumbel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "results", "run_v3_bal0.7_ckpt")
V, B = 40, 6


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
    torch.manual_seed(0)  # the port's init, for both (flax's init compiles for seconds)
    port = make_generator(PortConfig.from_json(cfg.to_json()))
    params = jax.tree.map(jnp.asarray, generator_state_dict_to_flax(port.state_dict()))
    mask = np.zeros((3, V), bool)
    mask[0, :20] = mask[2, :20] = True
    mask[1, 20:] = True
    forced = np.stack([r.randint(2, 20, B), r.randint(20, V, B), r.randint(2, 20, B)],
                      axis=1).astype(np.int32)
    return cfg, gen, params, port, feats, z, mask, forced


@pytest.mark.parametrize("detach", [False, True])
@pytest.mark.parametrize("steps", [(0,), (0, 2), (1,)])
def test_forced_steps_match_reference(setup, steps, detach):
    cfg, gen, params, port, feats, z, mask, forced = setup
    key = jax.random.key(7)
    kw = dict(tau=0.7, hard=False, step_mask=mask, detach_sample=detach)
    want = gen.apply({"params": params}, jnp.asarray(feats), jnp.asarray(z), key,
                     forced_tokens=jnp.asarray(forced), forced_steps=steps,
                     **{**kw, "step_mask": jnp.asarray(mask)})
    args = (torch.from_numpy(feats), torch.from_numpy(z), torch.from_numpy(_gumbel(cfg, key, B)))
    kw["step_mask"] = torch.from_numpy(mask)
    with torch.no_grad():
        got = port(*args, forced_tokens=torch.from_numpy(forced), forced_steps=steps, **kw)
        free = port(*args, **kw)
        ignored = port(*args, forced_tokens=torch.from_numpy(forced), **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    for t in steps:
        np.testing.assert_array_equal(got["tokens"][:, t].numpy(), forced[:, t])
    w_logits = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), w_logits, rtol=0,
                               atol=1e-5 * np.abs(w_logits).max())
    np.testing.assert_allclose(got["soft"].numpy(), np.asarray(want["soft"]), rtol=0, atol=1e-5)
    if detach:
        np.testing.assert_allclose(got["log_prob"].numpy(), np.asarray(want["log_prob"]),
                                   rtol=0, atol=1e-5)
    for k in free:
        assert torch.equal(ignored[k], free[k])
    unforced = gen.apply({"params": params}, jnp.asarray(feats), jnp.asarray(z), key,
                         **{**kw, "step_mask": jnp.asarray(mask)})
    np.testing.assert_array_equal(free["tokens"].numpy(), np.asarray(unforced["tokens"]))


def _reference_z(cfg, rng, K, n):
    """The scorer's z [K, n, Z]: split(rng, K), then each key's first split."""
    return torch.from_numpy(np.stack([
        np.array(jax.random.normal(jax.random.split(k)[0], (n, cfg.model.noise_dim),
                                   cfg.model.dtype))
        for k in jax.random.split(rng, K)]).astype(np.float32))


def _scorer_pair(cfg, g_params, mask, feats, subj, obj, K, seed):
    rng = jax.random.key(seed)
    want = np.asarray(jax_make_predcls_scorer(cfg, step_mask=mask, num_samples=K)(
        g_params, jnp.asarray(feats), jnp.asarray(subj), jnp.asarray(obj), rng))
    sd = generator_flax_to_state_dict(jax.tree.map(np.asarray, g_params), cfg)
    score = make_predcls_scorer(PortConfig.from_json(cfg.to_json()), step_mask=mask,
                                num_samples=K)
    got = score(sd, torch.from_numpy(feats), torch.from_numpy(subj), torch.from_numpy(obj),
                z=_reference_z(cfg, rng, K, len(subj)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


def _assert_scores_match(got, want, mask, gt):
    legal = mask[1]
    np.testing.assert_allclose(got[:, legal], want[:, legal], rtol=0, atol=1e-4)
    assert (got[:, ~legal] < -1e8).all() and (want[:, ~legal] < -1e8).all()
    ks = [1, 3, 5, 10]
    assert predicate_recall(got, gt, ks) == jax_predicate_recall(want, gt, ks)


def test_predcls_scorer_matches_reference(setup):
    cfg, _, params, _, feats, _, mask, forced = setup
    got, want = _scorer_pair(cfg, params, mask, feats, forced[:, 0], forced[:, 2], 5, 11)
    _assert_scores_match(got, want, mask, forced[:, 1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("run_v3"))
    os.makedirs(os.path.join(workdir, "checkpoints"))
    os.symlink(os.path.join(TRAINED, "100000"), os.path.join(workdir, "checkpoints", "100000"))
    cfg, vocab = jax_load_workdir(TRAINED)
    cfg.model.vocab_size = len(vocab)
    cfg.model.compute_dtype = "float32"
    state = JaxCheckpointManager(workdir, cfg).restore(
        jax_create_train_state(cfg, jax.random.key(0)))
    return cfg, vocab, state.g_params


def test_predcls_scorer_matches_reference_on_trained_weights(trained):
    cfg, vocab, g_params = trained
    r = np.random.RandomState(3)
    n = 12
    feats = np.abs(r.randn(n, cfg.data.regions, cfg.data.feat_dim)).astype(np.float32)
    objs, preds = np.flatnonzero(vocab.is_object), np.flatnonzero(vocab.is_predicate)
    subj, obj = r.choice(objs, n).astype(np.int32), r.choice(objs, n).astype(np.int32)
    mask = vocab.step_mask()
    got, want = _scorer_pair(cfg, g_params, mask, feats, subj, obj, 8, 2)
    assert len(vocab) == 210
    _assert_scores_match(got, want, mask, r.choice(preds, n))


def _row_scores(feats, subj, obj, V_):
    """A deterministic [B, V] score of a chunk's rows (float64 math, float32 out)."""
    f = np.asarray(feats, np.float64).reshape(len(subj), -1).sum(-1)
    v = np.arange(V_)[None, :] + 1.0
    return np.sin(0.01 * f[:, None] * v + 0.37 * np.asarray(subj)[:, None]
                  + 0.11 * np.asarray(obj)[:, None]).astype(np.float32)


def test_evaluate_predcls_lines_match_reference(corpus, v4_workdir, monkeypatch,  # noqa: F811
                                                capsys):
    """Both CLIs on the smoke-width pipeline_v4 workdir (its config.json and
    vocab.json; the weights are replaced)."""
    import types

    import sgg.cli.common as jax_common
    import sgg.cli.evaluate as jax_evaluate
    import sgg.eval as jax_eval

    wd = v4_workdir
    V_ = len(corpus[1])
    n_images, Bq = 13, 8
    argv = ["--workdir", wd, "--k", "1,3,5", "--num-samples", "2", "--rank", "freq",
            "--batch-size", str(Bq), "--num-images", str(n_images), "--predcls",
            "--predcls-samples", "6", "--ema", "--avg-last", "5"]
    seen = {"ref": [], "port": []}

    def scorer_factory(tag, to_out):
        def factory(cfg, step_mask=None, num_samples=16, tau=None):
            assert num_samples == 6 and step_mask is not None

            def score(g, feats, subj, obj, *_):
                feats = feats.numpy() if isinstance(feats, torch.Tensor) else np.asarray(feats)
                seen[tag].append((np.asarray(subj).copy(), np.asarray(obj).copy()))
                return to_out(_row_scores(feats, subj, obj, V_))
            return score
        return factory

    fake_state = types.SimpleNamespace(g_params={}, g_ema={}, enc_params=None, step=1)
    monkeypatch.setattr(jax_evaluate, "CheckpointManager", lambda *a, **k: types.SimpleNamespace(
        restore_averaged=lambda s, n: fake_state, all_steps=lambda: [2, 4, 6, 8, 10]))
    monkeypatch.setattr(jax_evaluate, "create_train_state", lambda *a, **k: None)
    monkeypatch.setattr(jax_evaluate, "make_sampler", lambda cfg, **kw: (
        lambda g, feats, rng, T: jnp.zeros((feats.shape[0], kw["num_samples"], 3), jnp.int32)))
    monkeypatch.setattr(jax_common, "make_batch_features",
                        lambda cfg, ds, enc, quant=None: (lambda idx: ds.features[idx]))
    monkeypatch.setattr(jax_eval, "make_predcls_scorer", scorer_factory("ref", jnp.asarray))
    assert jax_evaluate.main(argv) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if "predcls (" in ln]

    monkeypatch.setattr(evaluate, "restore_weights", lambda *a: (1, {}, {}, None, None))
    monkeypatch.setattr(evaluate, "make_sampler", lambda cfg, **kw: (
        lambda g, feats, gen, temp=None: torch.zeros(feats.shape[0], kw["num_samples"], 3,
                                                     dtype=torch.int32)))
    monkeypatch.setattr(evaluate, "make_predcls_scorer", scorer_factory("port", torch.from_numpy))
    assert evaluate.main(argv + ["--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if "predcls (" in ln]
    assert len(want) == 1 and got == want
    assert "draws/row): P-R@1 = " in got[0]
    assert len(seen["port"]) == len(seen["ref"]) > 1
    for (s1, o1), (s2, o2) in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(o1, o2)


def test_evaluate_predcls_on_a_pipeline_v4_workdir(v4_workdir, capsys):  # noqa: F811
    assert evaluate.main(["--workdir", v4_workdir, "--device", "cpu", "--ema", "--avg-last", "5",
                          "--num-samples", "2", "--k", "1,5,50", "--predcls",
                          "--predcls-samples", "4", "--batch-size", "16"]) == 0
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if "predcls (" in ln]
    n_rows = int(line.split("predcls (")[1].split(" GT")[0])
    assert n_rows > 16 and "4 draws/row" in line
    pr = {int(k): float(v) for k, v in re.findall(r"P-R@(\d+) = ([0-9.]+)", line)}
    assert pr[50] == 1.0 and 0.0 <= pr[1] <= pr[5] <= 1.0
