"""Flax ↔ port weight conversion on the repo's own checkpoints.

``tests/fixtures/ckpt_v1`` (a pinned-format smoke checkpoint) and the trained
``results/run_v3_bal0.7_ckpt`` (vg1k widths, V = 210, step 100k) are restored
through ``sgg.train.checkpoint``. Every generator leaf must round-trip
exactly, and the converted trained weights must give the flax generator's
tokens at full width (float32, a few rows; tokens identical, soft samples
within 1e-5).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.kernels.fused_decode import decode_gumbel_noise
from sgg.train.checkpoint import CheckpointManager, load_workdir
from sgg.train.state import create_train_state, make_models
from sgg_torch.config import Config as PortConfig
from sgg_torch.convert_flax import flax_to_state_dict, state_dict_to_flax
from sgg_torch.kernels import fused_decode as tfd
from sgg_torch.models import AttentionLSTMGenerator
from sgg_torch.train.checkpoint import load_generator, save_generator
from sgg_torch.train.checkpoint import load_workdir as port_load_workdir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "results", "run_v3_bal0.7_ckpt")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def fixture_state(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tests", "fixtures"))
    from make_ckpt_fixture import FIXTURE_DIR, fixture_config

    cfg = fixture_config()
    workdir = str(tmp_path_factory.mktemp("ckpt") / "ckpt_v1")
    shutil.copytree(FIXTURE_DIR, workdir)  # the committed fixture stays byte-pinned
    state = CheckpointManager(workdir, cfg).restore(create_train_state(cfg, jax.random.key(1)))
    assert int(state.step) == 11
    return cfg, state


@pytest.fixture(scope="module")
def trained_state(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("run_v3"))
    os.makedirs(os.path.join(workdir, "checkpoints"))
    os.symlink(os.path.join(TRAINED, "100000"), os.path.join(workdir, "checkpoints", "100000"))
    cfg, vocab = load_workdir(TRAINED)
    cfg.model.vocab_size = len(vocab)
    cfg.model.compute_dtype = "float32"  # parity in float32; bf16 is the card's check
    state = CheckpointManager(workdir, cfg).restore(create_train_state(cfg, jax.random.key(0)))
    assert int(state.step) == 100000
    return cfg, vocab, state


def test_fixture_generator_round_trips_every_leaf(fixture_state):
    _, state = fixture_state
    tree = jax.tree.map(np.asarray, state.g_params)
    back = state_dict_to_flax(flax_to_state_dict(tree))
    a, b = dict(_flat(tree)), dict(_flat(back))
    assert a.keys() == b.keys() and len(a) == 15
    for path in a:
        assert a[path].dtype == b[path].dtype, path
        np.testing.assert_array_equal(a[path], b[path], err_msg="/".join(path))


def test_fixture_loads_into_port_generator(fixture_state):
    cfg, state = fixture_state
    port_cfg = PortConfig.from_json(cfg.to_json())
    port = AttentionLSTMGenerator.from_config(port_cfg)
    port.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, state.g_params)))


def test_trained_generator_round_trips_and_matches_flax(trained_state):
    cfg, vocab, state = trained_state
    tree = jax.tree.map(np.asarray, state.g_params)
    sd = flax_to_state_dict(tree)
    back = dict(_flat(state_dict_to_flax(sd)))
    for path, leaf in _flat(tree):
        np.testing.assert_array_equal(leaf, back[path], err_msg="/".join(path))

    port_cfg = PortConfig.from_json(cfg.to_json())
    port = AttentionLSTMGenerator.from_config(port_cfg)
    port.load_state_dict(sd)
    gen, _ = make_models(cfg)
    B, R, F = 4, cfg.data.regions, cfg.data.feat_dim
    r = np.random.RandomState(0)
    feats = np.abs(r.randn(B, R, F)).astype(np.float32)
    z = r.randn(B, cfg.model.noise_dim).astype(np.float32)
    mask = vocab.step_mask()
    rng = jax.random.key(5)
    out = gen.apply({"params": state.g_params}, jnp.asarray(feats), jnp.asarray(z), rng,
                    tau=1.0, hard=True, step_mask=jnp.asarray(mask))
    g = torch.from_numpy(np.array(decode_gumbel_noise(rng, B, len(vocab))))
    tf, tz = torch.from_numpy(feats), torch.from_numpy(z)
    with torch.no_grad():
        got = port(tf, tz, g, hard=True, step_mask=torch.from_numpy(mask))
        y = tfd.decode_plain(tfd.decode_params_from_generator(sd), tf, tz, g,
                             mask_bias=tfd.step_mask_bias(mask))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(out["tokens"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(out["logits"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(y.argmax(-1).numpy(), np.asarray(out["tokens"]))


def test_converter_rejects_unknown_and_missing_leaves():
    tree = {"init_c": {"kernel": np.zeros((2, 3), np.float32)}}
    with pytest.raises(ValueError, match="missing"):
        flax_to_state_dict(tree)
    port = AttentionLSTMGenerator(vocab_size=5, feat_dim=4, hidden=4, embed_dim=2,
                                  attn_dim=2, noise_dim=2)
    full = state_dict_to_flax(port.state_dict())
    full["extra"] = {"kernel": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="unknown"):
        flax_to_state_dict(full)


def test_port_workdir_roundtrip(tmp_path):
    """save_generator/load_generator keep both trees bit-exact, and the port
    reads the trained run's config.json and vocab.json as the reference does."""
    port = AttentionLSTMGenerator(vocab_size=5, feat_dim=4, hidden=4, embed_dim=2,
                                  attn_dim=2, noise_dim=2)
    sd = port.state_dict()
    ema = {k: v * 0.5 for k, v in sd.items()}
    save_generator(str(tmp_path), sd, ema, step=7)
    ck = load_generator(str(tmp_path))
    assert ck["step"] == 7
    for k in sd:
        assert torch.equal(ck["g_params"][k], sd[k]) and torch.equal(ck["g_ema"][k], ema[k])
    assert load_generator(str(tmp_path / "missing")) is None

    cfg, vocab = port_load_workdir(TRAINED)
    ref_cfg, ref_vocab = load_workdir(TRAINED)
    assert cfg.to_json() == ref_cfg.to_json()
    assert cfg.model.dtype == torch.bfloat16 and len(vocab) == 210
    np.testing.assert_array_equal(vocab.step_mask(), ref_vocab.step_mask())


def test_workdir_records_decoder_and_refuses_the_other(tmp_path):
    """load_generator tells which decoder the weights are and, given the
    config's decoder, refuses the other one's."""
    from sgg_torch.models.transformer import TransformerTripleGenerator

    tr = TransformerTripleGenerator(vocab_size=5, feat_dim=4, hidden=8, noise_dim=2,
                                    num_heads=2, num_layers=1).state_dict()
    save_generator(str(tmp_path), tr, step=3)
    ck = load_generator(str(tmp_path), decoder="transformer")
    assert ck["decoder"] == "transformer" and ck["g_ema"] is None
    for k in tr:
        assert torch.equal(ck["g_params"][k], tr[k])
    with pytest.raises(ValueError, match="transformer"):
        load_generator(str(tmp_path), decoder="lstm")
    lstm = AttentionLSTMGenerator(vocab_size=5, feat_dim=4, hidden=4, embed_dim=2,
                                  attn_dim=2, noise_dim=2).state_dict()
    save_generator(str(tmp_path), lstm)
    assert load_generator(str(tmp_path), decoder="lstm")["decoder"] == "lstm"
