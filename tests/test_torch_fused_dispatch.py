"""``train.steps_per_dispatch``: the fused stepper and the train CLI's stride
against the reference, on the CPU, at smoke widths.

- :func:`dispatch_stride` prints what ``sgg.cli.train`` prints (stride,
  rounding and fallback lines) on the same configs: the device-resident store
  with N = 4 rounded by ``log_every``, rotation and the host iterator, both
  CLIs run; a resume step, the total steps, the eval cadence and
  ``--debug-nans`` (the port's own fallback) against the reference's rule as
  ``sgg/cli/train.py`` writes it.
- ``make_fused_device_stepper`` over two dispatches equals
  ``make_device_train_iterator`` and the step, bit for bit (on the CPU both
  run the same float32 ops), on float16 and int8 stores with predicate
  balance, the last step's metrics included; as the reference's
  ``tests/unit/test_device_pipeline.py`` pins its fused scan.
- The CLI with N = 2 leaves the checkpoint that N = 1 leaves (parameters,
  EMA, optimizer state) and logs the same losses; a resume at a dispatch
  boundary continues as N = 1 does; the profile window at a stride of 4.
- The Adam update against ``optax.chain(clip_by_global_norm, adam)`` with a
  cosine schedule and warmup (rtol 1e-6, atol 1e-9: float32 ops in another
  order), its lr table equal to the scalar schedule, and a checkpoint in the
  layout ``torch.optim.Adam`` wrote read back.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgg.cli.train as jax_train
from sgg_torch.cli import train
from sgg_torch.config import get_config
from sgg_torch.data import TripleDataset, synthetic_dataset
from sgg_torch.data.pipeline import make_device_train_iterator, make_fused_device_stepper
from sgg_torch.train import state as tstate
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn

torch.set_num_threads(1)

STRIDE_WORDS = ("steps_per_dispatch", "fused dispatch")
THROUGHPUT = {"images_per_sec", "images_per_sec_per_chip", "steps_per_sec"}


def _stride_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if any(w in ln for w in STRIDE_WORDS)]


@pytest.mark.parametrize("sets,want", [
    (["train.steps_per_dispatch=4", "train.log_every=2"],
     ["rounded to 2", "fused dispatch: 2 steps/program"]),
    (["train.steps_per_dispatch=4", "data.device_resident_max_bytes=20000"],
     ["falling back to per-step dispatch"]),
    (["train.steps_per_dispatch=4", "data.device_resident=false"],
     ["falling back to per-step dispatch"]),
], ids=["device", "rotation", "host"])
def test_both_clis_print_the_same_stride(tmp_path, capsys, sets, want):
    common = ["--config", "smoke", "--steps", "4", "--set", "train.stall_exit_sec=0"]
    for s in sets:
        common += ["--set", s]
    assert jax_train.main(common + ["--workdir", str(tmp_path / "ref"), "--platform",
                                    "cpu"]) == 0
    ref = _stride_lines(capsys.readouterr().out)
    assert train.main(common + ["--workdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = _stride_lines(capsys.readouterr().out)
    assert got == ref and len(got) == len(want)
    assert all(w in line for w, line in zip(want, got))


def _reference_rule(cfg, use_device_data: bool, resume_step: int) -> int:
    """``sgg/cli/train.py``'s stride, as written there."""
    stride = max(1, int(cfg.train.steps_per_dispatch))
    if stride > 1:
        if not use_device_data:
            stride = 1
        else:
            for v in (cfg.train.log_every, cfg.train.checkpoint_every,
                      cfg.train.eval_every or stride, cfg.train.total_steps,
                      int(resume_step) or stride):
                stride = math.gcd(stride, v)
    return stride


@pytest.mark.parametrize("sets,resume,debug_nans", [
    ({"train.steps_per_dispatch": 8, "train.log_every": 16}, 6, False),  # resume rounds
    ({"train.steps_per_dispatch": 8, "train.log_every": 16, "train.total_steps": 12}, 0,
     False),
    ({"train.steps_per_dispatch": 8, "train.log_every": 16, "train.eval_every": 4}, 0,
     False),
    ({"train.steps_per_dispatch": 8, "train.log_every": 8, "train.checkpoint_every": 8,
      "train.total_steps": 64}, 32, False),
    ({"train.steps_per_dispatch": 3, "train.log_every": 5}, 0, False),  # rounds to 1
    ({"train.steps_per_dispatch": 1}, 0, False),
    ({"train.steps_per_dispatch": 8, "train.log_every": 16}, 0, True),  # --debug-nans
])
def test_dispatch_stride_follows_the_reference_rule(sets, resume, debug_nans):
    cfg = get_config("smoke").override([f"{k}={v}" for k, v in sets.items()])
    stride, lines = train.dispatch_stride(cfg, "device", resume, debug_nans=debug_nans)
    n = cfg.train.steps_per_dispatch
    if debug_nans:
        assert stride == 1 and len(lines) == 1 and "--debug-nans" in lines[0]
        assert "falling back to per-step dispatch" in lines[0]
        return
    assert stride == _reference_rule(cfg, True, resume)
    rounded = [ln for ln in lines if "rounded to" in ln]
    assert rounded == ([f"[sgg.train] steps_per_dispatch rounded to {stride} (gcd of "
                        "log/checkpoint/eval cadences + resume step)"] if stride != n else [])
    fused = [ln for ln in lines if "fused dispatch" in ln]
    assert fused == ([f"[sgg.train] fused dispatch: {stride} steps/program"]
                     if stride > 1 else [])
    for route in ("rotating", "host"):
        assert train.dispatch_stride(cfg, route, resume)[0] == _reference_rule(cfg, False,
                                                                               resume)


def _smoke(sets=()):
    cfg = get_config("smoke").override(["train.ema_decay=0.9", "train.grad_clip=1.0",
                                        "train.lr_schedule=cosine", "train.warmup_steps=2",
                                        "train.tau_anneal=0.05", *sets])
    data = synthetic_dataset(num_images=24, regions=cfg.data.regions,
                             feat_dim=cfg.data.feat_dim, seed=3, dtype=np.float16)
    cfg.model.vocab_size = len(data["vocab"])
    ds = TripleDataset(features=data["features"], triples=data["triples"])
    ds.set_predicate_balance(0.7)
    return cfg, ds, data["vocab"]


def _state_tensors(state) -> dict:
    out = {"step": torch.tensor(state.step)}
    for name, mod in (("g", state.generator), ("d", state.critic)):
        out.update({f"{name}.{k}": v for k, v in mod.state_dict().items()})
    out.update({f"ema.{k}": v for k, v in state.g_ema.items()})
    for name, tx in (("g_tx", state.g_tx), ("d_tx", state.d_tx)):
        out[f"{name}.count"] = torch.tensor(tx.count)
        out.update({f"{name}.mu{i}": m for i, m in enumerate(tx.mu)})
        out.update({f"{name}.nu{i}": m for i, m in enumerate(tx.nu)})
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["float16", "int8"])
def test_fused_stepper_equals_the_iterator_and_step(int8):
    cfg, ds, vocab = _smoke()
    t = cfg.train
    eager, fused = (create_train_state(cfg, 0) for _ in range(2))
    step_e, step_f = (make_step_fn(cfg, step_mask=vocab.step_mask()) for _ in range(2))
    it = make_device_train_iterator(ds, t.batch_size, t.n_critic, seed=5, device="cpu",
                                    int8_store=int8)
    for _ in range(4):
        want = step_e(eager, next(it))
    stepper = make_fused_device_stepper(ds, step_f, t.batch_size, t.n_critic, n_steps=2,
                                        seed=5, device="cpu", int8_store=int8)
    stepper(fused, 0)
    got = stepper(fused, 2)  # the second dispatch continues the stream
    assert stepper.graph is None and fused.step == 4 and eager.step == 4
    a, b = _state_tensors(eager), _state_tensors(fused)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert float(got["tau"]) < 1.0  # the annealed temperature of step 3


def _cli(wd, n, steps, *extra):
    argv = ["--config", "smoke", "--device", "cpu", "--workdir", str(wd), "--steps",
            str(steps), "--set", "train.log_every=2", "--set", "train.checkpoint_every=2",
            "--set", "train.ema_decay=0.9", "--set", "train.tau_anneal=0.05", "--set",
            f"train.steps_per_dispatch={n}", *extra]
    return train.main(argv)


def _losses(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(ln).items() if k not in THROUGHPUT} for ln in f]


def _checkpoint(wd, step):
    return torch.load(os.path.join(wd, "checkpoints", str(step), "state.pt"),
                      weights_only=True)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_cli_with_two_steps_per_dispatch_leaves_the_same_run(tmp_path, capsys):
    assert _cli(tmp_path / "one", 1, 4) == 0
    assert _cli(tmp_path / "two", 2, 4) == 0
    out = capsys.readouterr().out
    assert "fused dispatch: 2 steps/program" in out
    assert _same(_checkpoint(tmp_path / "one", 4), _checkpoint(tmp_path / "two", 4))
    assert _same(_checkpoint(tmp_path / "one", 2), _checkpoint(tmp_path / "two", 2))
    assert _losses(tmp_path / "one") == _losses(tmp_path / "two")
    assert [r["step"] for r in _losses(tmp_path / "two")] == [2, 4]


def test_resume_at_a_dispatch_boundary(tmp_path, capsys):
    for wd, n in ((tmp_path / "one", 1), (tmp_path / "four", 4)):
        assert _cli(wd, n, 4) == 0
        capsys.readouterr()
        assert _cli(wd, n, 8) == 0
        out = capsys.readouterr().out
        assert "resumed from step 4" in out
        if n > 1:  # gcd(4, log 2, checkpoint 2, total 8, resume 4) = 2
            assert "steps_per_dispatch rounded to 2" in out
            assert "fused dispatch: 2 steps/program" in out
    assert _same(_checkpoint(tmp_path / "one", 8), _checkpoint(tmp_path / "four", 8))
    assert _losses(tmp_path / "one") == _losses(tmp_path / "four")


def test_profile_window_at_a_stride_of_four(tmp_path, capsys):
    assert train.main(["--config", "smoke", "--device", "cpu", "--workdir", str(tmp_path),
                       "--steps", "20", "--profile", "--set", "train.log_every=4", "--set",
                       "train.checkpoint_every=20", "--set", "train.steps_per_dispatch=4"]) == 0
    assert "fused dispatch: 4 steps/program" in capsys.readouterr().out
    with open(os.path.join(tmp_path, "profile", "top_ops.txt")) as f:
        table = f.read()
    # Opens at the first boundary at or after step 10 (12), closes at the
    # first at or after 15 (16).
    assert table.startswith("steps 12-15 (4 steps)")


def test_adam_matches_optax_with_a_schedule_and_clipping():
    cfg = get_config("smoke").override(["train.grad_clip=1.0", "train.lr_schedule=cosine",
                                        "train.warmup_steps=2", "train.total_steps=4",
                                        "train.lr_final_frac=0.1"])
    mod = torch.nn.Linear(4, 3)
    params = [p.detach().numpy().copy() for p in mod.parameters()]
    tx = tstate.Adam(mod, 1e-3, cfg, 2)
    sched = tstate.lr_schedule_fn(cfg, 1e-3, 2)
    otx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(lambda c: sched(int(c)), b1=0.5, b2=0.9))
    ostate = otx.init([jnp.asarray(p) for p in params])
    r = np.random.RandomState(1)
    for _ in range(12):  # past the schedule's horizon (8 updates)
        grads = [r.randn(*p.shape).astype(np.float32) for p in params]
        upd, ostate = otx.update([jnp.asarray(g) for g in grads], ostate)
        params = [p + np.asarray(u) for p, u in zip(params, upd)]
        tx.update([torch.from_numpy(g) for g in grads])
        for p, w in zip(mod.parameters(), params):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6, atol=1e-9)
    assert tx.count == 12
    counts = np.arange(sched.horizon + 5)
    table = sched(counts)
    assert table.dtype == np.float32
    assert [float(x) for x in table] == [sched(int(c)) for c in counts]


def test_adam_reads_the_layout_torch_adam_wrote():
    cfg = get_config("smoke")
    mod = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    old = torch.optim.Adam(mod.parameters(), lr=1e-3, betas=(0.5, 0.9), eps=1e-8)
    r = np.random.RandomState(2)
    for _ in range(3):
        for p in mod.parameters():
            p.grad = torch.from_numpy(r.randn(*p.shape).astype(np.float32))
        old.step()
    sd = {"count": 3, "adam": old.state_dict()}
    tx = tstate.Adam(mod, 1e-3, cfg, 1)
    tx.load_state_dict(torch.load(_roundtrip(sd), weights_only=True))
    assert tx.count == 3
    for i, p in enumerate(mod.parameters()):
        assert torch.equal(tx.mu[i], old.state[p]["exp_avg"])
        assert torch.equal(tx.nu[i], old.state[p]["exp_avg_sq"])
    tx.update([torch.ones_like(p) for p in mod.parameters()])  # continues from them
    assert tx.count == 4


def _roundtrip(obj):
    import io

    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return buf
