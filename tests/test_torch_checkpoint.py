"""The port's checkpoint restore across a change of structure, as
``sgg.train.checkpoint``'s (``tests/unit/test_checkpoint.py``).

- A round trip restores strictly, and prints nothing.
- The reference's four drift cases on port checkpoints: a precomputed run
  resumed as a VGG-19 run (the encoder keeps its initial values; strict mode
  raises), the reverse (the checkpoint's encoder is ignored), vocabulary
  growth and a checkpoint without EMA restored into an EMA state.
- Vocabulary growth leaf by leaf: the parameters that keep their initial
  values are those that the reference's ``merge_checkpoint`` keeps between
  its own train states of the same configs, mapped through
  ``sgg_torch.convert_flax``'s names; each Adam moment follows its
  parameter by name (restored where the parameter is, zero where it is kept).
- ``restore_averaged``: the latest checkpoint merges, an older one that
  drifted raises, as the reference's; ``restore_weights`` grafts a
  ``generator.pt`` of another vocabulary onto a fresh state, returns weights
  that fit as they are, and returns None for a field that the file lacks
  (no EMA) either way.
- A frozen-encoder ``vg_full`` run resumed through ``sgg_torch.cli.train``
  with ``train.train_encoder=true``: the fallback line, the encoder's
  optimizer from zero, the encoder trained on.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sgg.config import get_config as jax_get_config
from sgg.train.checkpoint import merge_checkpoint as jax_merge_checkpoint
from sgg.train.state import create_train_state as jax_create_train_state
from sgg_torch.cli import train as train_cli
from sgg_torch.config import get_config
from sgg_torch.convert_flax import _GENERATOR_MAP
from sgg_torch.train.checkpoint import (
    CheckpointManager,
    merge_checkpoint,
    restore_weights,
    save_generator,
)
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn

torch.set_num_threads(1)

FALLBACK = "[sgg_torch.checkpoint] strict restore failed (ValueError); falling back"


def _sets(encoder="precomputed", vocab=26, ema=0.0):
    return {"model.vocab_size": vocab, "model.encoder": encoder, "data.regions": 4,
            "data.feat_dim": 512, "data.image_size": 16, "train.ema_decay": ema}


def _cfg(**kw):
    return get_config("smoke").override([f"{k}={v}" for k, v in _sets(**kw).items()])


def _stepped(cfg, step):
    """A fresh state after one train step (so its Adam moments are not
    zero), its step set to ``step``."""
    st = create_train_state(cfg, seed=0)
    r = np.random.RandomState(0)
    nc, B, V = cfg.train.n_critic, cfg.train.batch_size, cfg.model.vocab_size
    batch = {"triples": torch.from_numpy(r.randint(2, V, (nc + 1, B, 3)))}
    if cfg.model.encoder == "precomputed":
        batch["features"] = torch.from_numpy(r.randn(nc + 1, B, 4, 512).astype(np.float32))
    else:
        batch["images"] = torch.from_numpy(r.randint(0, 256, (nc + 1, B, 16, 16, 3),
                                                     dtype=np.uint8))
    make_step_fn(cfg)(st, batch)
    st.step = step
    return st


def _save(wd, cfg, state):
    ck = CheckpointManager(str(wd), cfg)
    ck.save(state)
    return ck


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_round_trip_restores_strictly(tmp_path, capsys):
    cfg = _cfg(ema=0.99)
    st = _stepped(cfg, 3)
    _save(tmp_path, cfg, st)
    got = CheckpointManager(str(tmp_path), None).restore(create_train_state(cfg, seed=9),
                                                          lenient=False)
    assert got.step == 3 and got.g_tx.count == 1 and got.d_tx.count == cfg.train.n_critic
    _equal(got.generator.state_dict(), st.generator.state_dict())
    _equal(got.g_ema, st.g_ema)
    for a, b in zip(got.d_tx.mu + got.d_tx.nu, st.d_tx.mu + st.d_tx.nu):
        assert torch.equal(a, b)
    assert "[sgg_torch.checkpoint]" not in capsys.readouterr().err


def test_precomputed_run_resumes_as_an_end_to_end_run(tmp_path, capsys):
    old, new = _cfg(), _cfg(encoder="vgg19")
    st = _stepped(old, 7)
    _save(tmp_path, old, st)
    init = create_train_state(new, seed=1)
    enc0 = {k: v.clone() for k, v in init.encoder.state_dict().items()}
    got = CheckpointManager(str(tmp_path), None).restore(init)
    assert got is init and got.step == 7
    _equal(got.generator.state_dict(), st.generator.state_dict())
    _equal(got.critic.state_dict(), st.critic.state_dict())
    _equal(got.encoder.state_dict(), enc0)
    err = capsys.readouterr().err
    assert FALLBACK in err and "kept initialized: ['enc_params/conv1_1.kernel'" in err
    with pytest.raises(ValueError, match="missing .*enc_params/conv1_1.kernel"):
        CheckpointManager(str(tmp_path), None).restore(create_train_state(new, seed=1),
                                                       lenient=False)


def test_end_to_end_run_resumes_as_a_precomputed_run(tmp_path):
    old, new = _cfg(encoder="vgg19"), _cfg()
    st = _stepped(old, 5)
    ck = _save(tmp_path, old, st)
    init = create_train_state(new, seed=1)
    report = merge_checkpoint(ck._load(5), init, verbose=False)
    assert init.step == 5 and init.encoder is None and report["kept"] == []
    assert len(report["ignored"]) == 2 * 16 and all(
        p.startswith("enc_params/") for p in report["ignored"])
    _equal(init.critic.state_dict(), st.critic.state_dict())
    for a, b in zip(init.d_tx.mu, st.d_tx.mu):
        assert torch.equal(a, b)


def _reference_kept():
    """The parameters that the reference's merge keeps when a 26-token
    checkpoint restores into a 40-token state, as port paths."""
    def jcfg(vocab):
        c = jax_get_config("smoke")
        for k, v in _sets(vocab=vocab).items():
            section, field = k.split(".")
            setattr(getattr(c, section), field, v)
        return c

    old = jax_create_train_state(jcfg(26), jax.random.key(0))
    _, report = jax_merge_checkpoint({"g_params": old.g_params, "d_params": old.d_params},
                                     jax_create_train_state(jcfg(40), jax.random.key(1)),
                                     verbose=False)
    lstm = {"/".join(path): key for path, key, _ in _GENERATOR_MAP}
    out = set()
    for path in report["kept"]:
        tree, _, rest = path.partition("/")
        if tree == "g_params":
            out.add(f"g_params/{lstm[rest]}")
        elif tree == "d_params":
            out.add("d_params/" + rest.replace("/", "."))
    return out


def test_vocab_growth_keeps_what_the_reference_keeps_and_moments_follow(tmp_path):
    old, new = _cfg(), _cfg(vocab=40)
    st = _stepped(old, 9)
    ck = _save(tmp_path / "port", old, st)
    init = create_train_state(new, seed=1)
    fresh = {"g": {k: v.clone() for k, v in init.generator.state_dict().items()},
             "d": {k: v.clone() for k, v in init.critic.state_dict().items()}}
    report = merge_checkpoint(ck._load(9), init, verbose=False)
    kept = {p for p in report["kept"] if p.startswith(("g_params/", "d_params/"))}
    assert kept and kept == _reference_kept()
    assert report["ignored"] == [] and init.step == 9
    for tree, mod, tx, old_mod, old_tx in (
            ("g", init.generator, init.g_tx, st.generator, st.g_tx),
            ("d", init.critic, init.d_tx, st.critic, st.d_tx)):
        names = [n for n, _ in mod.named_parameters()]
        old_mu = dict(zip([n for n, _ in old_mod.named_parameters()], old_tx.mu))
        old_nu = dict(zip([n for n, _ in old_mod.named_parameters()], old_tx.nu))
        sd, old_sd = mod.state_dict(), old_mod.state_dict()
        assert tx.count == old_tx.count > 0 and all(m.any() for m in old_tx.mu[:2])
        for name, mu, nu in zip(names, tx.mu, tx.nu):
            if f"{tree}_params/{name}" in kept:
                assert torch.equal(sd[name], fresh[tree][name])
                assert not mu.any() and not nu.any()
                assert {f"{tree}_opt/mu/{name}", f"{tree}_opt/nu/{name}"} <= set(report["kept"])
            else:
                assert torch.equal(sd[name], old_sd[name])
                assert torch.equal(mu, old_mu[name])
                assert torch.equal(nu, old_nu[name])


def test_checkpoint_without_ema_restores_into_an_ema_state(tmp_path, capsys):
    old, new = _cfg(), _cfg(ema=0.99)
    st = _stepped(old, 5)
    assert st.g_ema is None
    _save(tmp_path, old, st)
    init = create_train_state(new, seed=3)
    ema0 = {k: v.clone() for k, v in init.g_ema.items()}
    got = CheckpointManager(str(tmp_path), None).restore(init)
    assert got.step == 5
    _equal(got.generator.state_dict(), st.generator.state_dict())
    _equal(got.g_ema, ema0)  # the generator's initial copy, not the checkpoint's weights
    assert FALLBACK in capsys.readouterr().err


def test_restore_averaged_merges_the_latest_and_refuses_a_drifted_older(tmp_path):
    old, new = _cfg(), _cfg(vocab=40)
    st = create_train_state(old, seed=0)
    ck = CheckpointManager(str(tmp_path), old)
    for s in (1, 2):
        st.step = s
        ck.save(st)
    got = ck.restore_averaged(create_train_state(new, seed=1), 1)
    assert got.step == 2 and got.generator.state_dict()["token_embedding"].shape[0] == 40
    with pytest.raises(ValueError, match="checkpoint 1 does not match"):
        ck.restore_averaged(create_train_state(new, seed=1), 2)
    with pytest.raises(ValueError, match="checkpoint 2 does not match"):
        ck.restore_averaged(create_train_state(new, seed=1), 1, lenient=False)


def test_restore_weights_grafts_a_generator_of_another_vocabulary(tmp_path, capsys):
    old, new = _cfg(), _cfg(vocab=40)
    st = create_train_state(old, seed=0)
    save_generator(str(tmp_path), st.generator.state_dict(), step=4)
    step, g, ema, enc, avg = restore_weights(str(tmp_path), new, 1, "cpu")
    assert step == 4 and ema is None and enc is None and avg is None
    assert g["token_embedding"].shape[0] == 40
    assert torch.equal(g["init_c.weight"], st.generator.state_dict()["init_c.weight"])
    assert FALLBACK in capsys.readouterr().err
    # Weights that fit come back as they are, without a line.
    got = restore_weights(str(tmp_path), old, 1, "cpu")
    _equal(got[1], st.generator.state_dict())
    assert "[sgg_torch.checkpoint]" not in capsys.readouterr().err
    # A field the file lacks stays None, grafted or not, so that generate's and
    # evaluate's refusals ('--ema: checkpoint has no EMA weights') still fire:
    # not the fresh state's initial EMA.
    for cfg, line in ((_cfg(ema=0.99), False), (_cfg(vocab=40, ema=0.99), True)):
        step, g, ema, enc, _ = restore_weights(str(tmp_path), cfg, 1, "cpu")
        assert step == 4 and ema is None and enc is None
        assert (FALLBACK in capsys.readouterr().err) is line


VG_FULL = {"data.source": "synthetic", "data.image_size": 32, "data.regions": 4,
           "data.feat_dim": 512, "train.batch_size": 2, "train.n_critic": 2,
           "model.compute_dtype": "float32", "data.num_synthetic_images": 8, "model.hidden": 16,
           "model.embed_dim": 8, "model.attn_dim": 8, "model.noise_dim": 4,
           "model.critic_hidden": 16, "train.log_every": 1, "train.checkpoint_every": 2}


def test_frozen_run_resumes_with_train_encoder_through_the_cli(tmp_path, capsys):
    wd = str(tmp_path / "wd")

    def run(steps, *extra):
        argv = ["--config", "vg_full", "--device", "cpu", "--workdir", wd, "--steps", str(steps)]
        for k, v in VG_FULL.items():
            argv += ["--set", f"{k}={v}"]
        for s in extra:
            argv += ["--set", s]
        return train_cli.main(argv)

    assert run(2) == 0
    frozen = torch.load(os.path.join(wd, "checkpoints", "2", "state.pt"), weights_only=True)
    assert frozen["enc_opt"] is None
    capsys.readouterr()
    assert run(4, "train.train_encoder=true") == 0
    out, err = capsys.readouterr()
    assert "resumed from step 2" in out and "done at step 4" in out
    assert FALLBACK in err and "'enc_opt/count'" in err
    sd = torch.load(os.path.join(wd, "checkpoints", "4", "state.pt"), weights_only=True)
    assert sd["enc_opt"]["count"] == 2 * 2  # from zero: n_critic updates a step, two steps
    moved = [k for k in frozen["enc_params"]
             if not torch.equal(frozen["enc_params"][k], sd["enc_params"][k])]
    assert len(moved) == len(frozen["enc_params"])
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines if "enc_gnorm" in r] == [3, 4]
