"""``sgg_torch.cli.train`` end to end on the CPU, on the ``smoke`` config.

Four steps write ``metrics.jsonl`` with the keys of the reference step's
metrics (read from ``sgg.train.step.make_step_fn`` by ``jax.eval_shape``) and
the logger's throughput; ``train.max_checkpoints`` prunes old checkpoints; a
second run resumes at the saved step; SIGTERM saves and exits, and the signal
handlers are put back; the host iterator's prefetch thread stops with the
run; ``sgg_torch.cli.generate`` samples the trained workdir; options that a
later slice brings are refused. ``pipeline_v4`` at smoke widths runs predicate
balance, the int8 store on rotating subsets, the held-out probe and
``--profile``. The two watchdogs, as the reference's: the host-RSS handover
(checkpoint and exit 75 at a checkpoint or a log boundary, then a relaunch
finishes; the reference's own two cases) and the stall watchdog (exit 86 from
its thread when a step hangs, in a subprocess; none with
``train.stall_exit_sec=0``).
"""

import json
import os
import signal
import subprocess
import sys
import threading

import jax
import pytest
import torch

from sgg.config import get_config as jax_get_config
from sgg.data import synthetic_dataset as jax_synthetic_dataset
from sgg.train.state import create_train_state as jax_create_train_state
from sgg.train.step import make_step_fn as jax_make_step_fn
from sgg_torch.cli import generate
from sgg_torch.cli import train
from sgg_torch.train.checkpoint import CheckpointManager, load_generator, load_workdir

torch.set_num_threads(1)

THROUGHPUT = {"images_per_sec", "images_per_sec_per_chip", "steps_per_sec"}


def _train(wd, *sets, steps=4):
    argv = ["--config", "smoke", "--device", "cpu", "--workdir", str(wd), "--steps", str(steps),
            "--set", "train.log_every=2"]
    for s in sets:
        argv += ["--set", s]
    return train.main(argv)


def _metrics(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _reference_metric_keys():
    cfg = jax_get_config("smoke")
    data = jax_synthetic_dataset(num_images=8, regions=cfg.data.regions,
                                 feat_dim=cfg.data.feat_dim, seed=0)
    cfg.model.vocab_size = len(data["vocab"])
    nc, B = cfg.train.n_critic, cfg.train.batch_size
    state = jax.eval_shape(lambda k: jax_create_train_state(cfg, k), jax.random.key(0))
    batch = {"features": jax.ShapeDtypeStruct((nc + 1, B, cfg.data.regions, cfg.data.feat_dim),
                                              "float32"),
             "triples": jax.ShapeDtypeStruct((nc + 1, B, 3), "int32")}
    _, metrics = jax.eval_shape(jax_make_step_fn(cfg, data["vocab"].step_mask()), state, batch)
    return set(metrics)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    wd = tmp_path_factory.mktemp("smoke_run")
    assert _train(wd, "train.checkpoint_every=1", "train.max_checkpoints=2") == 0
    return wd


def test_metrics_have_the_reference_keys(trained):
    lines = _metrics(trained)
    assert [r["step"] for r in lines] == [2, 4]
    keys = _reference_metric_keys()
    assert set(lines[0]) == keys | {"step"}
    assert set(lines[1]) == keys | {"step"} | THROUGHPUT
    assert lines[1]["images_per_sec"] > 0 and lines[1]["tau"] == 1.0


def test_checkpoints_are_pruned_and_read_back(trained):
    cfg, vocab = load_workdir(trained)
    assert cfg.name == "smoke" and cfg.model.vocab_size == len(vocab)
    mgr = CheckpointManager(trained, cfg, max_to_keep=2)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    saved = load_generator(trained, decoder="lstm")
    assert saved["step"] == 4 and saved["enc_params"] is None


def test_second_run_resumes_at_the_saved_step(trained, capsys):
    assert _train(trained, "train.checkpoint_every=1", "train.max_checkpoints=2", steps=6) == 0
    assert "resumed from step 4" in capsys.readouterr().out
    assert [r["step"] for r in _metrics(trained)] == [2, 4, 6]
    cfg, _ = load_workdir(trained)
    assert CheckpointManager(trained, cfg, max_to_keep=2).all_steps() == [5, 6]


def test_generate_samples_the_trained_workdir(trained, capsys):
    out = os.path.join(trained, "graphs.json")
    assert generate.main(["--workdir", str(trained), "--device", "cpu", "--num-samples", "3",
                          "--out", out]) == 0
    with open(out) as f:
        graphs = json.load(f)["scene_graphs"]
    assert len(graphs) == 64 and all(sum(t["count"] for t in g["triples"]) == 3 for g in graphs)


def test_sigterm_saves_and_restores_handlers(tmp_path, monkeypatch):
    make = train.make_step_fn
    before = signal.getsignal(signal.SIGTERM)

    def make_and_signal(cfg, step_mask=None):
        step = make(cfg, step_mask)

        def signalling_step(state, batch, *a, **kw):
            out = step(state, batch, *a, **kw)
            # Only with the CLI's handler in place: else SIGTERM would end the
            # test process, where a missing checkpoint fails the test.
            if state.step == 2 and signal.getsignal(signal.SIGTERM) is not before:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return signalling_step

    monkeypatch.setattr(train, "make_step_fn", make_and_signal)
    assert _train(tmp_path, "data.device_resident=false", steps=10) == 0
    assert signal.getsignal(signal.SIGTERM) is before
    cfg, _ = load_workdir(tmp_path)
    assert CheckpointManager(tmp_path, cfg).all_steps() == [2]
    assert not any(t.name == "sgg-torch-data-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_cuda_is_the_default_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--config", "smoke", "--workdir", str(tmp_path), "--steps", "1"])


@pytest.mark.parametrize("extra", [
    ["--set", "model.pp_microbatches=2"],
    ["--set", "train.train_encoder=true", "--set", "model.encoder=vgg19", "--set",
     "model.use_pallas=true"],
    ["--set", "model.moe_experts=4", "--set", "mesh.expert=2"], ["--set", "model.sp_mode=ring"],
    ["--set", "mesh.fsdp=true"],
    ["--set", "mesh.partition=gspmd"], ["--set", "mesh.seq=2"],
    ["--set", "mesh.model=2"]])
def test_unported_options_are_refused(tmp_path, capsys, extra):
    argv = ["--config", "smoke", "--device", "cpu", "--workdir", str(tmp_path), *extra]
    assert train.main(argv) == 2
    assert "not ported yet" in capsys.readouterr().err


def test_pipeline_v4_runs_balance_int8_rotation_probe_and_profile(tmp_path, capsys):
    from test_torch_evaluate import SMOKE, _sets, write_corpus

    corpus = str(tmp_path / "corpus")
    write_corpus(corpus)
    wd = tmp_path / "wd"
    sets = dict(SMOKE, **{"data.data_dir": corpus, "train.batch_size": 8, "train.n_critic": 2,
                          "train.log_every": 1, "train.checkpoint_every": 4,
                          "train.eval_every": 8, "train.eval_images": 12,
                          "train.eval_samples": 4, "data.device_resident_max_bytes": 6000,
                          "data.rotation_min_steps": 3})
    argv = ["--config", "pipeline_v4", "--device", "cpu", "--workdir", str(wd), "--steps", "16",
            "--profile", *_sets(sets)]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "predicate-balanced triple sampling (alpha=0.7)" in out
    assert "rotating device-resident subsets" in out and "int8+scale" in out
    assert "subset rotation: cycle 1 complete" in out and "subsets, at most 2 alive" in out
    assert out.count("eval step") == 2 and "profile trace ->" in out
    cfg, _ = load_workdir(wd)
    assert cfg.name == "pipeline_v4" and cfg.model.compute_dtype == "bfloat16"
    assert cfg.train.grad_accum == 2 and cfg.data.feature_store_int8
    lines = _metrics(wd)
    evals = [r for r in lines if "eval_recall@50" in r]
    assert [r["step"] for r in evals] == [8, 16]
    assert all(0.0 <= r["eval_recall@50"] <= 1.0 and r["eval_seconds"] > 0 for r in evals)
    with open(os.path.join(wd, "best_eval.json")) as f:
        best = json.load(f)
    assert best["ema"] and best["k"] == 50 and best["step"] in (8, 16)
    with open(os.path.join(wd, "profile", "top_ops.txt")) as f:
        table = f.read()
    assert table.startswith("steps 10-14 (5 steps)") and "top ops by" in table
    assert os.path.getsize(os.path.join(wd, "profile", "trace.json")) > 0
    assert CheckpointManager(wd, None, max_to_keep=6).all_steps() == [4, 8, 12, 16]


def _rss_args(wd, *sets):
    argv = ["--config", "smoke", "--device", "cpu", "--workdir", str(wd),
            "--set", "train.total_steps=20"]
    for s in sets:
        argv += ["--set", s]
    return argv


def test_host_rss_handover_at_a_checkpoint_boundary_and_resume(tmp_path, capsys):
    args = _rss_args(tmp_path, "train.checkpoint_every=5")
    before = signal.getsignal(signal.SIGTERM)
    assert train.main(args + ["--set", "train.host_rss_exit_gb=0.0001"]) == 75
    out = capsys.readouterr().out
    assert "checkpointed at step 5, exiting 75 for supervised relaunch" in out
    assert signal.getsignal(signal.SIGTERM) is before
    assert train.main(args) == 0
    assert "resumed from step 5" in capsys.readouterr().out
    cfg, _ = load_workdir(tmp_path)
    assert CheckpointManager(tmp_path, cfg).latest_step() == 20


def test_host_rss_handover_at_a_log_boundary(tmp_path, capsys):
    args = _rss_args(tmp_path, "train.log_every=3", "train.checkpoint_every=1000")
    assert train.main(args + ["--set", "train.host_rss_exit_gb=0.0001"]) == 75
    assert os.path.isdir(os.path.join(tmp_path, "checkpoints", "3"))  # the log step
    assert train.main(args) == 0
    assert "resumed from step 3" in capsys.readouterr().out


STALL_SCRIPT = """
import sys, time
import sgg_torch.cli.train as t

t.STALL_POLL_SEC = 0.1
make = t.make_step_fn

def hanging(cfg, step_mask=None):
    step = make(cfg, step_mask)

    def hang(state, batch, *a, **kw):
        if state.step == 1:
            time.sleep(120)
        return step(state, batch, *a, **kw)

    return hang

t.make_step_fn = hanging
sys.exit(t.main(sys.argv[1:]))
"""


def test_stall_watchdog_exits_86_when_a_step_hangs(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", STALL_SCRIPT, *_rss_args(tmp_path, "train.stall_exit_sec=1",
                                                        "train.log_every=1")],
        capture_output=True, text=True, timeout=120, env=env, cwd=root)
    assert proc.returncode == 86, proc.stdout + proc.stderr
    assert "STALL: no log readback for" in proc.stdout
    assert "exit 86 for supervised relaunch" in proc.stdout


@pytest.mark.parametrize("limit", [0.0, 900.0])
def test_stall_watchdog_runs_only_when_on(tmp_path, monkeypatch, limit):
    make = train.make_step_fn
    seen = []

    def watching(cfg, step_mask=None):
        step = make(cfg, step_mask)

        def look(state, batch, *a, **kw):
            seen.append(any(th.name == "sgg-torch-stall-watchdog" and th.is_alive()
                            for th in threading.enumerate()))
            return step(state, batch, *a, **kw)

        return look

    monkeypatch.setattr(train, "make_step_fn", watching)
    assert _train(tmp_path, f"train.stall_exit_sec={limit}", steps=2) == 0
    assert seen == [limit > 0] * 2
    assert not any(th.name == "sgg-torch-stall-watchdog" for th in threading.enumerate())


VG_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch",
                          "vg_jpeg")


@pytest.mark.parametrize("route", ["materialized", "host"])
def test_vg_full_trains_on_the_jpeg_fixture(tmp_path, capsys, route):
    """``--config vg_full`` at smoke widths (32 px, float32) on the committed
    JPEG fixture, 2 steps with the pixels-in probe at each: once decoded into
    the device-resident store, and once with a budget under the decoded
    corpus, on the host-prefetch route, decoding each step's images. The
    materialize and probe lines are the reference's
    (``sgg/cli/train.py:169-173``, ``sgg/data/images.py:89``,
    ``sgg/train/eval_probe.py:143-147``)."""
    sets = {"data.data_dir": VG_FIXTURE, "data.image_size": 32, "data.regions": 4,
            "data.feat_dim": 512, "model.compute_dtype": "float32", "model.hidden": 32,
            "model.embed_dim": 16, "model.attn_dim": 16, "model.noise_dim": 8,
            "model.critic_hidden": 32, "train.batch_size": 4, "train.n_critic": 2,
            "train.log_every": 1, "train.eval_every": 1, "train.eval_images": 3,
            "train.eval_samples": 2}
    if route == "host":
        sets["data.device_resident_max_bytes"] = 1000
    argv = ["--config", "vg_full", "--device", "cpu", "--workdir", str(tmp_path), "--steps",
            "2"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    n_train = 28  # the fixture's 31 kept images less round(0.1 x 31) held out
    materialize = (f"[sgg.train] materializing {n_train} images (0.0 GB uint8) for device "
                   "residency")
    assert (materialize in out) == (route == "materialized")
    assert (f"[sgg.data] materialize: {n_train}/{n_train} images decoded" in out) == (
        route == "materialized")
    if route == "materialized":
        assert "[sgg.train] device-resident dataset (0 MB on cpu)" in out
    else:
        assert "[sgg.train] host iterator with prefetch, decoding 12 JPEGs a step" in out
        assert "[sgg.train] host decode: " in out
    for step in (1, 2):
        assert f"[sgg.train] eval step {step}: recall@50 = " in out
    assert "(3 held-out images, " in out
    lines = _metrics(str(tmp_path))
    assert [r["step"] for r in lines if "d_loss" in r] == [1, 2]
    assert [r["step"] for r in lines if "eval_recall@50" in r] == [1, 2]
    with open(tmp_path / "best_eval.json") as f:
        assert json.load(f)["images"] == 3
