"""``sgg_torch.cli.evaluate`` and what it stands on, against the reference:
``restore_averaged`` over the same (converted) checkpoints within 1e-6
relative; evaluate's whole result grid from the same tokens and
log-probabilities, identical (every combo of temperature, K, rank,
predicate adjustment and exclude-seen, with bootstrap intervals, zero-shot
and mean recall); the in-loop probe's recall and ``best_eval.json`` against
``EvalProbe`` on the reference's draws, identical; and the CLI end to end on
a smoke-width ``pipeline_v4`` workdir on the CPU (``--ema --avg-last 5 --rank
logp`` and ``--decode fused``), with its refusals.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.config import get_config as jax_get_config
from sgg.data import Vocab as JaxVocab
from sgg.kernels.fused_decode import decode_gumbel_noise
from sgg.train.checkpoint import CheckpointManager as JaxCheckpointManager
from sgg.train.eval_probe import EvalProbe as JaxEvalProbe
from sgg.train.state import create_train_state as jax_create_train_state
from sgg_torch.cli import evaluate, train
from sgg_torch.config import Config as PortConfig
from sgg_torch.convert_flax import (
    encoder_state_dict_to_flax,
    generator_flax_to_state_dict,
    generator_state_dict_to_flax,
    train_state_from_flax,
)
from sgg_torch.data import write_feature_shard
from sgg_torch.data.shards import shard_name
from sgg_torch.train.checkpoint import CheckpointManager
from sgg_torch.train.eval_probe import EvalProbe
from sgg_torch.train.state import create_train_state
from test_torch_jpeg import reference_native  # noqa: F401  (sgg's JPEG loader, private)

torch.set_num_threads(1)

N_OBJ, N_PRED = 12, 8
SMOKE = {"model.hidden": 32, "model.embed_dim": 16, "model.attn_dim": 16,
         "model.noise_dim": 8, "model.critic_hidden": 32, "data.regions": 9,
         "data.feat_dim": 16}


def write_corpus(root, n_train=48, n_test=20, R=9, F=16, seed=0):
    """A seeded feature-shard corpus as ``load_dataset`` reads it:
    ``vocab.json`` and the train shards in ``root``, the held-out ones in
    ``root/test``; 1-5 triples per image, predicates on a long tail."""
    from collections import Counter

    from sgg_torch.data import Vocab

    vocab = Vocab.build(Counter({f"obj{i}": 100 - i for i in range(N_OBJ)}),
                        Counter({f"pred{i}": 100 - i for i in range(N_PRED)}))
    objs = [vocab.id(f"obj{i}") for i in range(N_OBJ)]
    preds = [vocab.id(f"pred{i}") for i in range(N_PRED)]
    w = 1.0 / (np.arange(N_PRED) + 1.0) ** 1.5
    r = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    vocab.save(os.path.join(root, "vocab.json"))
    for d, n in ((root, n_train), (os.path.join(root, "test"), n_test)):
        os.makedirs(d, exist_ok=True)
        feats = (r.randn(n, R, F) * r.uniform(0.5, 3, (n, R, 1))).astype(np.float16)
        trip = [np.stack([r.choice(objs, k), r.choice(preds, k, p=w / w.sum()),
                          r.choice(objs, k)], axis=1) for k in r.randint(1, 6, n)]
        write_feature_shard(os.path.join(d, shard_name(0, 1)), np.arange(n), feats, trip)
    return vocab


def _sets(d: dict) -> list:
    out = []
    for k, v in d.items():
        out += ["--set", f"{k}={v}"]
    return out


def _port_state(pcfg, st):
    """The port's train state holding a reference state's weights."""
    host = lambda t: None if t is None else jax.tree.map(np.asarray, t)  # noqa: E731
    return train_state_from_flax(pcfg, types.SimpleNamespace(
        step=int(st.step), g_params=host(st.g_params), d_params=host(st.d_params),
        enc_params=host(st.enc_params), g_ema=host(st.g_ema)))


def test_restore_averaged_matches_reference(tmp_path):
    cfg = jax_get_config("smoke")
    cfg.model.vocab_size = 26
    cfg.train.ema_decay = 0.99
    pcfg = PortConfig.from_json(cfg.to_json())
    st = jax_create_train_state(cfg, jax.random.key(0))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_mgr = JaxCheckpointManager(ref_dir, cfg, max_to_keep=6)
    port_mgr = CheckpointManager(port_dir, pcfg, max_to_keep=6)
    r = np.random.RandomState(0)
    for s in range(1, 7):
        moved = st.replace(
            step=jnp.int32(s),
            g_params=jax.tree.map(lambda p: p * np.float32(r.uniform(0.5, 2)) + np.float32(
                r.randn() * 1e-2), st.g_params),
            g_ema=jax.tree.map(lambda p: p * np.float32(r.uniform(0.5, 2)), st.g_params),
            d_params=jax.tree.map(lambda p: p + np.float32(s), st.d_params))
        ref_mgr.save(moved)
        port_mgr.save(_port_state(pcfg, moved))
    ref_mgr.close()
    for n in (5, 2):
        want = JaxCheckpointManager(ref_dir, cfg, max_to_keep=6).restore_averaged(
            jax_create_train_state(cfg, jax.random.key(1)), n)
        got = CheckpointManager(port_dir, None).restore_averaged(
            create_train_state(pcfg, 1), n)
        assert got.step == int(want.step) == 6
        for mine, theirs in ((got.generator.state_dict(), want.g_params),
                             (got.g_ema, want.g_ema)):
            ref_sd = generator_flax_to_state_dict(jax.tree.map(np.asarray, theirs), cfg)
            assert set(mine) == set(ref_sd)
            for k, v in ref_sd.items():
                assert mine[k].dtype == v.dtype
                np.testing.assert_allclose(mine[k].numpy(), v.numpy(), rtol=1e-6, atol=0)
        ref_d = jax.tree.leaves(want.d_params)
        assert sum(float(np.abs(np.asarray(x)).sum()) for x in ref_d) == pytest.approx(
            sum(float(v.abs().sum()) for v in got.critic.state_dict().values()), rel=1e-6)
    assert CheckpointManager(str(tmp_path / "empty"), None).restore_averaged(
        create_train_state(pcfg, 1), 5) is None


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return root, write_corpus(root)


def _grid_workdir(root, corpus_dir):
    cfg = jax_get_config("smoke")
    cfg.data.source, cfg.data.data_dir = "shards", corpus_dir
    vocab = JaxVocab.load(os.path.join(corpus_dir, "vocab.json"))
    cfg.model.vocab_size = len(vocab)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        f.write(cfg.to_json())
    vocab.save(os.path.join(root, "vocab.json"))
    return root


def test_evaluate_grid_matches_reference_on_the_same_draws(corpus, tmp_path, monkeypatch):
    """Both CLIs run with their samplers and weights replaced by the same
    draws: one (tokens, logp) per batch and temperature."""
    import sgg.cli.common as jax_common
    import sgg.cli.evaluate as jax_evaluate

    wd = _grid_workdir(str(tmp_path / "wd"), corpus[0])
    r = np.random.RandomState(5)
    n_images, B, K = 20, 8, 12
    temps = "1,0.7"
    calls = -(-n_images // B) * 2
    from sgg.data import TripleDataset as JaxTripleDataset
    from sgg.data import list_shards

    test_ds = JaxTripleDataset.from_shards(list_shards(os.path.join(corpus[0], "test")))
    draws = []
    for c in range(calls):
        lo = (c // 2) * B
        tok = np.zeros((B, K, 3), np.int32)
        for j in range(B):
            gt = test_ds.triples[min(lo + j, n_images - 1)]
            pool = np.concatenate([gt, r.randint(2, 2 + N_OBJ + N_PRED, (4, 3))])
            tok[j] = pool[r.randint(0, len(pool), K)]
        draws.append((tok, (-r.gamma(2.0, 2.0, (B, K))).astype(np.float32)))

    def fake_factory(to_out):
        def factory(cfg, **kw):
            assert kw["num_samples"] == K and kw["with_logp"]
            it = iter(draws)
            return lambda *a, **k: to_out(next(it))
        return factory

    argv = ["--workdir", wd, "--k", "1,5,20", "--num-samples", f"6,{K}", "--temperature", temps,
            "--rank", "freq,freq_logp,logp", "--predicate-adjust", "0,0.5",
            "--exclude-seen", "sweep", "--zero-shot", "--per-predicate", "--bootstrap", "100",
            "--batch-size", str(B), "--ema", "--seed", "3"]
    fake_state = types.SimpleNamespace(g_params={}, g_ema={}, enc_params=None, step=1)
    monkeypatch.setattr(jax_evaluate, "CheckpointManager",
                        lambda *a, **k: types.SimpleNamespace(restore=lambda s: fake_state))
    monkeypatch.setattr(jax_evaluate, "create_train_state", lambda *a, **k: None)
    monkeypatch.setattr(jax_evaluate, "make_sampler",
                        fake_factory(lambda d: (jnp.asarray(d[0]), jnp.asarray(d[1]))))
    monkeypatch.setattr(jax_common, "make_batch_features",
                        lambda cfg, ds, enc, quant=None: (lambda idx: ds.features[idx]))
    want_path, got_path = str(tmp_path / "want.json"), str(tmp_path / "got.json")
    assert jax_evaluate.main(argv + ["--json-out", want_path]) == 0
    monkeypatch.setattr(evaluate, "restore_weights", lambda *a: (1, {}, {}, None, None))
    monkeypatch.setattr(evaluate, "make_sampler", fake_factory(
        lambda d: (torch.from_numpy(d[0]), torch.from_numpy(d[1]))))
    assert evaluate.main(argv + ["--json-out", got_path, "--device", "cpu"]) == 0
    with open(want_path) as f:
        want = json.load(f)
    with open(got_path) as f:
        got = json.load(f)
    assert len(got["combos"]) == 2 * 2 * (2 + 2 + 4) == len(want["combos"])
    assert got["combos"] == want["combos"]
    assert {k: v for k, v in got.items() if k not in ("combos", "workdir")} == \
        {k: v for k, v in want.items() if k not in ("combos", "workdir")}
    assert any(c["recall"]["20"] > 0 for c in got["combos"])
    assert any(c["zero_shot_recall"]["20"] > 0 for c in got["combos"])


def _reference_probe_noise(cfg, step, n_batches, B, V):
    """EvalProbe's draws: fold_in(key(seed + 1), step), split per batch, then
    the sampler's split(key, K) into z and the decode's Gumbel noise."""
    rng = jax.random.fold_in(jax.random.key(cfg.train.seed + 1), step)
    out = []
    for _ in range(n_batches):
        rng, sub = jax.random.split(rng)
        zs, gs = [], []
        for key in jax.random.split(sub, cfg.train.eval_samples):
            kz, kg = jax.random.split(key)
            zs.append(np.array(jax.random.normal(kz, (B, cfg.model.noise_dim), cfg.model.dtype)))
            gs.append(np.array(decode_gumbel_noise(kg, B, V)))
        out.append((torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(gs))))
    return out


@pytest.mark.parametrize("ema", [False, True])
def test_probe_matches_reference(corpus, tmp_path, ema):
    cfg = jax_get_config("smoke")
    cfg.data.source, cfg.data.data_dir = "shards", corpus[0]
    cfg.model.vocab_size = len(corpus[1])
    cfg.train.eval_images, cfg.train.eval_samples, cfg.train.eval_k = 18, 3, 5
    cfg.train.ema_decay = 0.99 if ema else 0.0
    vocab = JaxVocab.load(os.path.join(corpus[0], "vocab.json"))
    st = jax_create_train_state(cfg, jax.random.key(0))
    pcfg = PortConfig.from_json(cfg.to_json())
    cfg.workdir, pcfg.workdir = str(tmp_path / "ref"), str(tmp_path / "port")
    os.makedirs(cfg.workdir)
    os.makedirs(pcfg.workdir)
    ref_probe = JaxEvalProbe(cfg, vocab)
    probe = EvalProbe(pcfg, corpus[1], "cpu")
    assert (probe.n_images, probe.batch) == (ref_probe.n_images, ref_probe.batch) == (18, 8)
    state = _port_state(pcfg, st)
    for step in (4, 8):
        want = ref_probe.run(st, step)
        noise = _reference_probe_noise(cfg, step, 3, 8, len(vocab))
        got = probe.run(state, step, noise=noise)
        assert got["eval_recall@5"] == want["eval_recall@5"]
        with open(os.path.join(cfg.workdir, "best_eval.json")) as f:
            best_want = json.load(f)
        with open(os.path.join(pcfg.workdir, "best_eval.json")) as f:
            assert json.load(f) == best_want
    assert probe.best == ref_probe.best


@pytest.fixture(scope="module")
def v4_workdir(corpus, tmp_path_factory):
    """pipeline_v4 at smoke widths on the CPU: balance, int8, rotating subsets
    (a 6 KB budget), the probe, the profile and six checkpoints."""
    wd = str(tmp_path_factory.mktemp("v4"))
    sets = dict(SMOKE, **{"data.data_dir": corpus[0], "train.batch_size": 8,
                          "train.n_critic": 2, "train.log_every": 2,
                          "train.checkpoint_every": 2, "train.eval_every": 6,
                          "train.eval_images": 12, "train.eval_samples": 4,
                          "data.device_resident_max_bytes": 6000,
                          "data.rotation_min_steps": 2})
    argv = ["--config", "pipeline_v4", "--device", "cpu", "--workdir", wd, "--steps", "12",
            "--profile", *_sets(sets)]
    assert train.main(argv) == 0
    return wd


def test_evaluate_cli_on_a_pipeline_v4_workdir(v4_workdir, capsys, tmp_path):
    out = str(tmp_path / "grid.json")
    assert evaluate.main(["--workdir", v4_workdir, "--device", "cpu", "--ema", "--avg-last", "5",
                          "--rank", "logp", "--k", "20,50,100", "--zero-shot",
                          "--per-predicate", "--num-samples", "8", "--json-out", out]) == 0
    printed = capsys.readouterr().out
    assert "averaged over 5 checkpoints (steps [4, 6, 8, 10, 12])" in printed
    assert "split=test images=20 samples/image=8 recall@20 = " in printed
    assert "zsR@20 = " in printed and "mR@100 = " in printed
    with open(out) as f:
        grid = json.load(f)
    assert not grid["partial"] and grid["ema"] and grid["avg_last"] == 5
    (combo,) = grid["combos"]
    assert combo["rank"] == "logp" and set(combo["recall"]) == {"20", "50", "100"}
    assert 0.0 <= combo["recall"]["100"] <= 1.0 and "mean_recall@100" in combo
    assert evaluate.main(["--workdir", v4_workdir, "--device", "cpu", "--decode", "fused",
                          "--rank", "freq", "--num-samples", "4"]) == 0
    assert "decode fused" in capsys.readouterr().out


@pytest.mark.parametrize("flags,message", [
    (["--decode", "fused", "--top-p", "0.9"], "--top-k/--top-p"),
    (["--decode", "fused", "--rank", "logp"], "log-probs"),
    (["--decode", "fused", "--temperature", "0.5,1"], "temperature 1.0"),
    (["--decode", "fused", "--top-k", "3"], "--top-k/--top-p"),
    (["--rank", "beam"], "unknown --rank"),
    (["--rank", "freq", "--predicate-adjust", "0.5"], "rank logp only"),
])
def test_evaluate_cli_refusals(v4_workdir, capsys, flags, message):
    assert evaluate.main(["--workdir", v4_workdir, "--device", "cpu", "--num-samples", "2",
                          *flags]) == 2
    assert message in capsys.readouterr().err


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch",
                       "vg_jpeg")


@pytest.mark.parametrize("source", ["synthetic", "vg"])
def test_pixels_in_probe_matches_reference(tmp_path, monkeypatch, source):
    """The pixels-in probe on a small VGG-19 config (32 px, float32): held-out
    images in memory (the synthetic source) or decoded from the fixture's
    JPEGs (the vg source), encoded with the state's encoder weights, the last
    of three batches padded; the same recall and best_eval.json as the
    reference's on its own draws, and each image's ranked triples identical."""
    import sgg.eval as jax_eval
    import sgg_torch.eval.sampler as port_sampler

    from sgg.cli.common import load_dataset as jax_load_dataset
    from sgg_torch.cli.common import load_dataset

    cfg = jax_get_config("vg_full")
    cfg.model.compute_dtype = "float32"
    cfg.model.hidden, cfg.model.embed_dim, cfg.model.attn_dim = 32, 16, 16
    cfg.model.noise_dim, cfg.model.critic_hidden = 8, 32
    cfg.data.image_size, cfg.data.regions, cfg.data.feat_dim = 32, 4, 512
    cfg.data.source = source
    cfg.data.data_dir, cfg.data.test_fraction = FIXTURE, 0.4
    cfg.data.num_synthetic_images = 12
    cfg.train.batch_size, cfg.train.eval_images, cfg.train.eval_samples = 4, 10, 3
    cfg.train.eval_k = 5
    vocab = jax_load_dataset(cfg, split="test")[1]
    cfg.model.vocab_size = len(vocab)
    pcfg = PortConfig.from_json(cfg.to_json())
    pvocab = load_dataset(pcfg, split="test")[1]
    cfg.workdir, pcfg.workdir = str(tmp_path / "ref"), str(tmp_path / "port")
    os.makedirs(cfg.workdir)
    os.makedirs(pcfg.workdir)
    # The port's seeded state, and the reference's sampler and encoder fed its
    # weights (a reference init compiles every initializer, tens of seconds).
    state = create_train_state(pcfg, 0, device="cpu")
    assert state.encoder is not None and state.g_ema is None
    st = types.SimpleNamespace(
        g_ema=None, g_params=generator_state_dict_to_flax(state.generator.state_dict()),
        enc_params=encoder_state_dict_to_flax(state.encoder.state_dict(), "vgg19"))
    ref_probe = JaxEvalProbe(cfg, vocab)
    probe = EvalProbe(pcfg, pvocab, "cpu")
    assert (probe.n_images, probe.batch) == (ref_probe.n_images, ref_probe.batch) == (10, 4)
    ranked = {"ref": [], "port": []}
    for mod, key in ((jax_eval, "ref"), (port_sampler, "port")):
        monkeypatch.setattr(mod, "rank_triples", lambda *a, _f=mod.rank_triples, _k=key, **k:
                            ranked[_k].append(_f(*a, **k)) or ranked[_k][-1])
    for step in (3, 6):
        want = ref_probe.run(st, step)
        got = probe.run(state, step, noise=_reference_probe_noise(cfg, step, 3, 4, len(vocab)))
        assert got["eval_recall@5"] == want["eval_recall@5"]
    assert len(ranked["port"]) == 20 and ranked["port"] == ranked["ref"]
    with open(os.path.join(cfg.workdir, "best_eval.json")) as f, \
            open(os.path.join(pcfg.workdir, "best_eval.json")) as g:
        assert json.load(g) == json.load(f)
