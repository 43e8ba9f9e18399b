"""Encoder pretraining (``sgg_torch.train.pretrain``, ``sgg_torch.cli.pretrain``)
against ``sgg.train.pretrain`` and ``sgg.cli.pretrain`` on the CPU, on the
committed VG-shaped JPEG fixture (``tests/fixtures_torch/vg_jpeg``, grounded,
with boxes).

- ``multi_hot_labels``, ``feature_grid`` and ``cell_labels`` exactly;
- one and two pretrain steps against the reference's jitted step from the
  same weights, given its own batch indices
  (``jax.random.randint(fold_in(key(seed), step), (B,), 0, n)``): VGG-19 at
  32 px with the spatial task on, and a small MoE ViT ((64, 2, 4), 4
  experts, 64 px) with it off, float32. Metrics of the chained steps within
  1e-5 relative plus 1e-6; parameters within ``tests/test_torch_train.py``'s
  Adam bound after each port step against the reference's step from the
  port's parameters before it, and after the chained steps (VGG-19: after
  the first). VGG-19 at random init on raw pixels (±128) is chaotic: the
  7e-6 of its elements Adam moves the other way at step 1 (rounding-noise
  gradients in both) perturb step 2 so that 1.03 % of the elements leave
  the bound chained, against 2e-6 from the port's own step-1 parameters;
- ``evaluate_presence``'s report within 1e-5 (the port on its kernel route,
  the plain versions here);
- ``encoder_params.npz``: the keys, shapes and dtypes the reference's
  ``save_params_npz`` writes for the same weights;
- both pretrain CLIs at 64 px (a small MoE ViT, one step): the same counts,
  vocab size and spatial lines, the same ``vocab.json`` bytes and
  ``pretrain_meta.json`` keys; the
  reference's ``preprocess --encoder-ckpt`` on the port's out-dir writes the
  port's features within 1e-4 x max;
- the port's CLI: ``--spatial on`` without boxes is rc 1, a stall exits 86
  (in a subprocess), and a run cut after its resume file resumes to the
  params of an unbroken run, bit for bit.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgg.cli.preprocess as jax_preprocess
import sgg.cli.pretrain as jax_pretrain_cli
from sgg.data.vocab import Vocab as JaxVocab
from sgg.train import pretrain as jp
from sgg_torch.cli import preprocess
from sgg_torch.cli import pretrain as pretrain_cli
from sgg_torch.convert_flax import (
    encoder_flax_to_state_dict,
    encoder_state_dict_to_flax,
    load_params_npz,
)
from sgg_torch.data import list_shards, read_feature_shard, synthetic_vg_json
from sgg_torch.data import vg
from sgg_torch.data.extract import load_batch
from sgg_torch.train import pretrain as pp

from test_torch_train import _assert_params_close
from test_torch_jpeg import reference_native  # noqa: F401  (sgg's JPEG loader, private)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures_torch", "vg_jpeg")
IMAGES = os.path.join(FIXTURE, "images")
LR = 1e-4


@functools.cache
def _corpus():
    """(vocab, ids, triples per id, boxes per id) of the fixture."""
    with open(os.path.join(FIXTURE, "relationships.json")) as f:
        rel = json.load(f)
    images = vg.parse_relationships(rel)
    vocab = vg.build_vocab_from_relationships(images)
    ids, enc = vg.filter_and_encode(images, vocab)
    return vocab, ids, enc, vg.parse_entity_boxes(rel)


def test_labels_match_reference():
    vocab, ids, enc, boxes = _corpus()
    jvocab = JaxVocab.from_json(vocab.to_json())
    np.testing.assert_array_equal(pp.multi_hot_labels(enc, len(vocab)),
                                  jp.multi_hot_labels(enc, len(vocab)))
    for name, size in (("vgg19", 224), ("resnet50", 224), ("vit_b16", 64), ("vgg19", 100)):
        assert pp.feature_grid(name, size) == jp.feature_grid(name, size)
    ents = [boxes[i] for i in ids]
    ents[0] = ents[0] + [("no such object", (0, 0, 500, 375))]
    for grid, wh in ((14, (500, 375)), (4, (500, 375)), (7, (640, 480))):
        got = pp.cell_labels(ents, vocab, grid, wh)
        assert got.dtype == np.int32 and got.shape == (len(ids), grid * grid)
        np.testing.assert_array_equal(got, jp.cell_labels(ents, jvocab, grid, wh))
        assert (got > 0).any() and (got == 0).any()


CASES = {
    "vgg19_spatial": dict(encoder="vgg19", size=32, spatial=True),
    "vit_moe": dict(encoder="vit_b16", size=64, spatial=False, moe_experts=4,
                    vit_dims=(64, 2, 4)),
}
B, N, SEED, STEPS = 4, 12, 3, 2


def _store(size, grid):
    vocab, ids, enc, boxes = _corpus()
    paths = [os.path.join(IMAGES, f"{i}.jpg") for i in ids[:N]]
    images = load_batch(paths, size)
    labels = pp.multi_hot_labels(enc[:N], len(vocab))
    cells = pp.cell_labels([boxes[i] for i in ids[:N]], vocab, grid, (500, 375))
    return images, labels, cells, vocab


def _flax_params(model):
    """The port model's weights as the reference PresenceModel's params, in
    copies (JAX on the CPU may alias a numpy buffer, and the port's step
    updates its parameters in place while the reference's step may still
    be reading them)."""
    head = model.head.proj
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)), {
        "encoder": encoder_state_dict_to_flax(model.encoder.state_dict(),
                                              model.encoder_name)["params"],
        "head": {"proj": {"kernel": head.kernel.detach().numpy(),
                          "bias": head.bias.detach().numpy()}}})


def _port_params(params):
    sd = {f"encoder.{k}": v for k, v in encoder_flax_to_state_dict(params["encoder"]).items()}
    sd["head.proj.kernel"] = torch.from_numpy(np.array(params["head"]["proj"]["kernel"]))
    sd["head.proj.bias"] = torch.from_numpy(np.array(params["head"]["proj"]["bias"]))
    return sd


@functools.cache
def _run_case(name):
    c = CASES[name]
    kw = dict(moe_experts=c.get("moe_experts", 0), vit_dims=c.get("vit_dims", (768, 12, 12)))
    grid = pp.feature_grid(c["encoder"], c["size"])
    images, labels, cells, vocab = _store(c["size"], grid)
    model, opt = pp.make_pretrain_state(c["encoder"], len(vocab), image_size=c["size"], lr=LR,
                                        seed=0, **kw)
    step = pp.make_pretrain_step(model, opt, B, seed=SEED, spatial=c["spatial"])
    jmodel = jp.PresenceModel(encoder_name=c["encoder"], num_classes=len(vocab),
                              image_size=c["size"], **kw)
    params = _flax_params(model)
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    jstep = jp.make_pretrain_step(jmodel, tx, B, seed=SEED, spatial=c["spatial"])
    ji, jl, jc = jnp.asarray(images), jnp.asarray(labels), jnp.asarray(cells)
    ti, tl, tc = (torch.from_numpy(np.array(a)) for a in (images, labels, cells))
    steps = []
    for s in range(STEPS):
        idx = np.asarray(jax.random.randint(jax.random.fold_in(jax.random.key(SEED), s),
                                            (B,), 0, N))
        store = (ji, jl, jc) if c["spatial"] else (ji, jl)
        # The reference's step from the port's parameters (its own optimizer
        # state), then its chained step from its own.
        from_port = jstep(_flax_params(model), opt_state, *store, N, s)[0]
        params, opt_state, jm = jstep(params, opt_state, *store, N, s)
        pm = step(ti, tl, tc if c["spatial"] else None, step_idx=s, idx=torch.from_numpy(idx))
        steps.append({"jm": {k: float(v) for k, v in jm.items()},
                      "pm": {k: float(v) for k, v in pm.items()},
                      "ref": _port_params(params), "from_port": _port_params(from_port),
                      "port": {k: v.clone() for k, v in model.state_dict().items()}})
    return {"steps": steps, "model": model, "jmodel": jmodel, "params": params,
            "store": (images, labels, cells), "spatial": c["spatial"],
            "chained": c["encoder"] != "vgg19"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_reference(name):
    run = _run_case(name)
    for i, s in enumerate(run["steps"], start=1):
        want = {"presence_recall", "loss"} | ({"cell_acc"} if run["spatial"] else set())
        assert set(s["pm"]) == set(s["jm"]) == want
        for k, v in s["jm"].items():
            np.testing.assert_allclose(s["pm"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        assert set(s["port"]) == set(s["ref"])
        _assert_params_close(s["port"], s["from_port"], LR, 1)
        if i == 1 or run["chained"]:
            _assert_params_close(s["port"], s["ref"], LR, i)


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_presence_matches_reference(name):
    run = _run_case(name)
    images, labels, cells = run["store"]
    model = run["model"]
    model.load_state_dict(run["steps"][-1]["ref"])  # the reference's weights after its steps
    want = jp.evaluate_presence(run["jmodel"], run["params"], images, labels, batch_size=5,
                                cells=cells)
    got = pp.evaluate_presence(model, images, labels, batch_size=5, cells=cells)
    assert set(got) == set(want) == {"loss", "presence_recall", "precision_at_k", "cell_acc"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    assert model.use_pallas == pp.train_route(model.encoder_name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_params_npz_layout_matches_reference(name, tmp_path, monkeypatch):
    run = _run_case(name)
    # The layout, not the compression (the port's file is uncompressed).
    monkeypatch.setattr(np, "savez_compressed", np.savez)
    pp.save_params_npz(str(tmp_path / "port.npz"), pp.encoder_params_tree(run["model"]))
    jp.save_params_npz(str(tmp_path / "ref.npz"),
                       jax.tree.map(np.asarray, run["params"]["encoder"]))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    back = load_params_npz(str(tmp_path / "port.npz"))
    assert jax.tree.structure(back) == jax.tree.structure(jp.load_params_npz(
        str(tmp_path / "ref.npz")))


CLI_ARGS = ["--vg-dir", FIXTURE, "--image-dir", IMAGES, "--image-size", "64",
            "--batch-size", "4", "--steps", "1", "--log-every", "1", "--dtype", "float32",
            "--encoder", "vit_b16", "--vit-dims", "32,1,2", "--moe-experts", "2"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both pretrain CLIs on the fixture at 64 px → (out-dirs, printed)."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("pretrain")
    out = {}
    for name, main, extra in (("ref", jax_pretrain_cli.main, []),
                              ("port", pretrain_cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--out-dir", str(root / name), *CLI_ARGS, *extra]) == 0
        out[name] = (root / name, buf.getvalue())
    return out


def _lines(printed, *starts):
    return [ln for ln in printed.splitlines() if ln.startswith(starts)]


def test_both_clis_print_and_write_alike(cli_runs):
    (ref_dir, ref_out), (port_dir, port_out) = cli_runs["ref"], cli_runs["port"]
    starts = ("[sgg.pretrain] 29 train / 3 held-out images, vocab=79, encoder=vit_b16",
              "[sgg.pretrain] spatial task ON: 4x4 cells, ")
    assert len(_lines(port_out, *starts)) == 2
    assert _lines(port_out, *starts) == _lines(ref_out, *starts)
    assert len(_lines(port_out, "[sgg.pretrain] step ")) == 1
    assert (port_dir / "vocab.json").read_bytes() == (ref_dir / "vocab.json").read_bytes()
    meta = [json.loads((d / "pretrain_meta.json").read_text()) for d in (port_dir, ref_dir)]
    assert meta[0].keys() == meta[1].keys() and meta[0]["held_out"].keys() == \
        meta[1]["held_out"].keys()
    assert {k: v for k, v in meta[0].items() if k != "held_out"} == \
        {k: v for k, v in meta[1].items() if k != "held_out"}
    assert not (port_dir / pretrain_cli.RESUME).exists()


def test_reference_preprocess_reads_the_port_checkpoint(cli_runs, tmp_path):
    port_dir = cli_runs["port"][0]
    args = ["--vg-dir", FIXTURE, "--image-dir", IMAGES, "--encoder", "vgg19",
            "--encoder-ckpt", str(port_dir), "--max-images", "6", "--batch-size", "4",
            "--test-fraction", "0.34"]  # pretrain_meta.json names the MoE ViT
    assert jax_preprocess.main(["--out-dir", str(tmp_path / "ref"), *args]) == 0
    assert preprocess.main(["--out-dir", str(tmp_path / "port"), *args, "--device", "cpu"]) == 0
    for sub in ("", "test"):
        mine, theirs = (list_shards(str(tmp_path / d / sub)) for d in ("port", "ref"))
        assert mine and len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            sa, sb = read_feature_shard(a), read_feature_shard(b)
            np.testing.assert_array_equal(sa["image_ids"], sb["image_ids"])
            assert sa["features"].shape[1:] == (16, 32)
            np.testing.assert_allclose(sa["features"], sb["features"], rtol=0,
                                       atol=1e-4 * np.abs(sb["features"]).max())


def test_cli_refuses_spatial_without_boxes(tmp_path, capsys):
    d = tmp_path / "vg"
    d.mkdir()
    (d / "relationships.json").write_text(json.dumps(synthetic_vg_json(8)))
    assert pretrain_cli.main(["--vg-dir", str(d), "--image-dir", str(d), "--out-dir",
                              str(tmp_path / "out"), "--spatial", "on", "--device",
                              "cpu"]) == 1
    assert "--spatial on but no entity boxes" in capsys.readouterr().err


def test_cli_resumes_to_an_unbroken_run(tmp_path, monkeypatch):
    args = ["--vg-dir", FIXTURE, "--image-dir", IMAGES, "--image-size", "32",
            "--batch-size", "2", "--steps", "4", "--log-every", "1", "--dtype", "float32",
            "--checkpoint-every", "2", "--device", "cpu", "--max-images", "8",
            "--encoder", "vit_b16", "--vit-dims", "32,1,2"]
    assert pretrain_cli.main(["--out-dir", str(tmp_path / "whole"), *args]) == 0
    make = pp.make_pretrain_step

    def cut_at_3(*a, **k):
        step = make(*a, **k)

        def run(*sa, step_idx=0, **sk):
            if step_idx == 3:
                raise KeyboardInterrupt("cut")
            return step(*sa, step_idx=step_idx, **sk)

        return run

    monkeypatch.setattr(pp, "make_pretrain_step", cut_at_3)
    with pytest.raises(KeyboardInterrupt):
        pretrain_cli.main(["--out-dir", str(tmp_path / "cut"), *args])
    assert (tmp_path / "cut" / pretrain_cli.RESUME).exists()
    monkeypatch.setattr(pp, "make_pretrain_step", make)
    assert pretrain_cli.main(["--out-dir", str(tmp_path / "cut"), *args]) == 0
    assert not (tmp_path / "cut" / pretrain_cli.RESUME).exists()
    with np.load(tmp_path / "whole" / "encoder_params.npz") as a, \
            np.load(tmp_path / "cut" / "encoder_params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


STALL_SCRIPT = """
import sys, time
import sgg_torch.cli.train as train_cli
import sgg_torch.train.pretrain as pp
from sgg_torch.cli import pretrain

train_cli.STALL_POLL_SEC = 0.05

def hanging(*a, **k):
    def step(*sa, **sk):
        time.sleep(60)
    return step

pp.make_pretrain_step = hanging
pretrain.main(["--vg-dir", sys.argv[1], "--image-dir", sys.argv[1] + "/images", "--out-dir",
               sys.argv[2], "--image-size", "32", "--batch-size", "2", "--steps", "2",
               "--stall-exit-sec", "1", "--device", "cpu", "--max-images", "4"])
print("returned")
"""


def test_cli_stall_exits_86(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", STALL_SCRIPT, FIXTURE, str(tmp_path / "out")],
                          capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 86, proc.stdout + proc.stderr
    assert "[sgg.pretrain] STALL: no log readback for" in proc.stdout
    assert "returned" not in proc.stdout
