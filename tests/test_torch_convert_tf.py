"""``sgg_torch.convert`` and ``sgg_torch.cli.convert`` against ``sgg``'s.

- The reader: a ``tf.compat.v1.train.Saver`` checkpoint (the reference's own
  test writes one, ``tests/integration/test_tf_checkpoint.py``) holding the
  generator's and the critic's reference-named variables, an int64
  ``global_step``, a float16 and a bfloat16 variable: the port's
  ``read_tf_checkpoint``, which imports no TensorFlow, gives
  ``sgg.convert.read_tf_checkpoint``'s names, dtypes and bytes (bfloat16
  widened to float32, exactly), from the prefix and from the directory. A
  flipped byte in the data file, a string variable, a partitioned variable,
  a missing shard and a compressed block are refused by name. The port's
  writer is read back by TensorFlow; CRC32C against a bytewise one.
- Placement: ``convert_from_arrays`` and ``match_report`` on
  ``tests/unit/test_convert.py``'s cases give the reference's trees,
  unmatched lists, reports and errors.
- The CLI: both ``convert`` CLIs on the committed fixture
  (``tests/fixtures_torch/tf1_ckpt``, written by TensorFlow here): the port's
  workdir, carried through ``sgg_torch.convert_flax``, equals the reference's
  orbax workdir leaf for leaf (generator and critic), and
  ``sgg_torch.cli.generate`` on it gives the reference CLI's graphs for the
  reference's noise; ``--dry-run``, ``--npz``, ``--skip-discriminator`` and
  a generator-only ``.npz`` print the reference's lines and exit codes.
- The fixture's bundle equals its ``.npz`` through both readers.

TensorFlow is imported here only, once (about 15 s).
"""

import json
import os
import shutil
import struct
import sys

import jax
import numpy as np
import pytest
import torch

from sgg import convert as ref_convert
from sgg.cli import convert as ref_cli
from sgg.cli import generate as ref_generate
from sgg.config import get_config as ref_get_config
from sgg.train.checkpoint import CheckpointManager as RefCheckpointManager
from sgg.train.checkpoint import load_workdir as ref_load_workdir
from sgg.train.state import create_train_state as ref_create_train_state
from sgg_torch import convert
from sgg_torch.cli import convert as port_cli
from sgg_torch.cli import generate as port_generate
from sgg_torch.convert_flax import critic_state_dict_to_flax, generator_state_dict_to_flax
from test_torch_generate import _reference_noise

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures_torch", "tf1_ckpt")
sys.path.insert(0, FIXTURE)
from make_fixture import SETS, reference_names  # noqa: E402

SET_ARGS = [a for s in SETS for a in ("--set", s)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


def _ref_trees(cfg=None):
    cfg = cfg or ref_get_config("smoke").override(SETS)
    cfg.model.vocab_size = 14
    st = ref_create_train_state(cfg, jax.random.key(0))
    return jax.tree.map(np.asarray, st.g_params), jax.tree.map(np.asarray, st.d_params)


# ------------------------------------------------------------ the reader

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Checkpoints written by TensorFlow's Saver: ``main`` (G and D names,
    global_step, float16, bfloat16), ``string`` and ``partitioned``; and
    the reference reader's result on ``main``."""
    import tensorflow as tf

    d = tmp_path_factory.mktemp("tf1")
    g, dd = _ref_trees()
    r = np.random.RandomState(3)
    arrays = reference_names(g, dd, r)
    arrays["global_step"] = np.int64(7)
    arrays["extra/half"] = r.randn(2, 3).astype(np.float16)

    def save(name, build):
        tf.compat.v1.reset_default_graph()
        with tf.compat.v1.Session() as sess:
            build()
            sess.run(tf.compat.v1.global_variables_initializer())
            tf.compat.v1.train.Saver().save(sess, str(d / name / "model.ckpt"))
        return str(d / name / "model.ckpt")

    def main_vars():
        for n, a in arrays.items():
            tf.compat.v1.get_variable(n, initializer=a)
        tf.compat.v1.get_variable("extra/bf16", initializer=tf.constant(r.randn(4, 3),
                                                                        dtype=tf.bfloat16))

    def string_vars():
        tf.compat.v1.get_variable("w", initializer=np.ones(3, np.float32))
        tf.Variable(["a", "bc"], name="names")

    def partitioned_vars():
        tf.compat.v1.get_variable("w", initializer=np.ones(3, np.float32))
        tf.compat.v1.get_variable("part", shape=(8, 4),
                                  partitioner=tf.compat.v1.fixed_size_partitioner(2))

    paths = {"main": save("main", main_vars), "string": save("string", string_vars),
             "partitioned": save("partitioned", partitioned_vars)}
    return paths, ref_convert.read_tf_checkpoint(paths["main"]), tf


def test_reader_matches_the_reference_reader(saved):
    paths, ref, _ = saved
    assert "tensorflow" in sys.modules  # the reference's reader needs it; the port's not
    for where in (paths["main"], os.path.dirname(paths["main"])):
        got = convert.read_tf_checkpoint(where)
        assert sorted(got) == sorted(ref)
        for name, a in ref.items():
            b = got[name]
            if name == "extra/bf16":  # numpy has no bfloat16: widened, exactly
                assert b.dtype == np.float32 and np.array_equal(b, a.astype(np.float32))
            else:
                assert (b.dtype, b.shape) == (a.dtype, a.shape) and b.tobytes() == a.tobytes()


def _flip(path):
    with open(path, "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 0x10]))


def _compress(prefix):
    """Mark the index's first block compressed, with its checksum made good."""
    with open(prefix + ".index", "rb") as f:
        buf = bytearray(f.read())
    # The writer puts the data block first and the metaindex right after its
    # 5-byte trailer (the compression byte, then the checksum).
    meta_off = convert._varint(buf[len(buf) - 48:], 0)[0]
    buf[meta_off - 5] = 1
    buf[meta_off - 4:meta_off] = struct.pack(
        "<I", convert.mask_crc(convert.crc32c(bytes(buf[:meta_off - 4]))))
    with open(prefix + ".index", "wb") as f:
        f.write(buf)


@pytest.mark.parametrize("case,match", [
    ("flipped byte", "variable 'discriminator/embedding/weights': checksum mismatch"),
    ("string", "variable 'names' is a string tensor"),
    ("partitioned", "variable 'part' is partitioned"),
    ("missing shard", "shard .*data-00000-of-00001 is missing"),
    ("compressed block", "is compressed"),
])
def test_reader_refuses_by_name(saved, tmp_path, case, match):
    paths, _, _ = saved
    if case in ("string", "partitioned"):
        prefix = paths[case]
    else:
        prefix = str(tmp_path / "model.ckpt")
        src = paths["main"]
        for ext in (".index", ".data-00000-of-00001"):
            shutil.copy(src + ext, prefix + ext)
        if case == "flipped byte":
            _flip(prefix + ".data-00000-of-00001")
        elif case == "missing shard":
            os.remove(prefix + ".data-00000-of-00001")
        else:
            convert.write_tf_checkpoint(prefix, {"w": np.ones(3, np.float32)})
            _compress(prefix)
    with pytest.raises((ValueError, FileNotFoundError), match=match):
        convert.read_tf_checkpoint(prefix)


def test_writer_is_read_by_tensorflow_and_crc32c(saved, tmp_path):
    _, ref, tf = saved
    arrays = {n: a for n, a in ref.items() if n != "extra/bf16"}
    arrays["flags"] = np.array([True, False, True])
    arrays["bytes"] = np.arange(-4, 4, dtype=np.int8)
    prefix = str(tmp_path / "port" / "model.ckpt")
    convert.write_tf_checkpoint(prefix, arrays)
    reader = tf.train.load_checkpoint(prefix)
    assert sorted(reader.get_variable_to_shape_map()) == sorted(arrays)
    for name, a in arrays.items():
        b = reader.get_tensor(name)
        assert b.dtype == np.asarray(a).dtype and b.tobytes() == np.asarray(a).tobytes(), name
    got = convert.read_tf_checkpoint(prefix)
    assert all(got[n].tobytes() == np.asarray(a).tobytes() for n, a in arrays.items())

    def bytewise(b):
        c = 0xFFFFFFFF
        for x in b:
            c ^= x
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        return c ^ 0xFFFFFFFF

    assert convert.crc32c(b"123456789") == 0xE3069283
    r = np.random.RandomState(0)
    for n in (0, 1, 63, 64, 65, 4097, 70001):
        data = r.randint(0, 256, n).astype(np.uint8)
        assert convert.crc32c(data) == convert.crc32c(data.tobytes()) == bytewise(data.tobytes())
    for c in (0, 1, 0xE3069283, 0xFFFFFFFF):
        assert convert.unmask_crc(convert.mask_crc(c)) == c


# ------------------------------------------------------------ placement

def _cases():
    g, d = _ref_trees()
    r = np.random.RandomState(7)
    gv = reference_names(g, None, r)
    both = reference_names(g, d, np.random.RandomState(11))
    return g, d, gv, both


PLACEMENT = ["generator", "discriminator", "combined", "shape mismatch", "missing strict",
             "missing lenient", "ambiguous", "absent path"]


@pytest.mark.parametrize("case", PLACEMENT)
def test_placement_matches_the_reference(case):
    g, d, gv, both = _cases()
    G, D = convert.DEFAULT_GENERATOR_MAPPING, convert.DEFAULT_DISCRIMINATOR_MAPPING
    rG, rD = ref_convert.DEFAULT_GENERATOR_MAPPING, ref_convert.DEFAULT_DISCRIMINATOR_MAPPING
    kw, rkw = {}, {}
    if case == "generator":
        args = (gv, g)
    elif case == "discriminator":
        args = (both, d)
        kw = dict(mapping=D, exclude=convert.DISCRIMINATOR_EXCLUDE)
        rkw = dict(mapping=rD, exclude=ref_convert.DISCRIMINATOR_EXCLUDE)
    elif case == "combined":
        args = (both, g)
        kw = dict(exclude=convert.GENERATOR_EXCLUDE)
        rkw = dict(exclude=ref_convert.GENERATOR_EXCLUDE)
    elif case == "shape mismatch":
        gv["generator/embedding/weights"] = np.zeros((14, 9), np.float32)
        args = (gv, g)
    elif case.startswith("missing"):
        del gv["generator/deep_out/weights"]
        args = (gv, g)
        kw = rkw = dict(strict=case == "missing strict")
    elif case == "ambiguous":
        args = (both, g)  # no exclude: "discriminator/embedding" also matches
    else:  # a mapped path that this tree lacks is skipped
        g = {k: v for k, v in g.items() if k != "deep_out"}
        args = (gv, g)
    try:
        want = ref_convert.convert_from_arrays(*args, **(rkw or kw))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            convert.convert_from_arrays(*args, **kw)
        assert str(got.value) == str(e)
        return
    tree, unmatched = convert.convert_from_arrays(*args, **kw)
    assert unmatched == want[1]
    _assert_trees_equal(tree, jax.tree.map(np.asarray, want[0]))


def test_match_report_matches_the_reference():
    g, d, _, both = _cases()
    both["global_step"] = np.int64(7)
    del both["discriminator/head/biases"]
    rep = convert.match_report(both, {
        "generator": (g, convert.DEFAULT_GENERATOR_MAPPING, convert.GENERATOR_EXCLUDE),
        "discriminator": (d, convert.DEFAULT_DISCRIMINATOR_MAPPING,
                          convert.DISCRIMINATOR_EXCLUDE),
        "both": (g, convert.DEFAULT_GENERATOR_MAPPING, None)})
    want = ref_convert.match_report(both, {
        "generator": (g, ref_convert.DEFAULT_GENERATOR_MAPPING, ref_convert.GENERATOR_EXCLUDE),
        "discriminator": (d, ref_convert.DEFAULT_DISCRIMINATOR_MAPPING,
                          ref_convert.DISCRIMINATOR_EXCLUDE),
        "both": (g, ref_convert.DEFAULT_GENERATOR_MAPPING, None)})
    assert rep == want
    assert rep["unused_vars"] == ["global_step"] and rep["ambiguous"]
    assert rep["unmatched_params"] == ["discriminator/head/bias"]


# --------------------------------------------------------------- the CLI

def _both_clis(tmp_path, capsys, source, *extra):
    """(rc, stdout, stderr, workdir) of the reference CLI, then the port's."""
    out = []
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        wd = str(tmp_path / name)
        argv = ["--config", "smoke", *SET_ARGS, *source, "--vocab",
                os.path.join(FIXTURE, "vocab.json"), *extra]
        if "--dry-run" not in extra:
            argv += ["--workdir", wd]
        if cli is port_cli:
            argv += ["--device", "cpu"]
        rc = cli.main(argv)
        printed = capsys.readouterr()
        out.append((rc, printed.out, printed.err, wd))
    return out


def _port_trees(wd):
    sd = torch.load(os.path.join(wd, "checkpoints", "0", "state.pt"), weights_only=True)
    return generator_state_dict_to_flax(sd["g_params"]), critic_state_dict_to_flax(sd["d_params"])


def _ref_restored(wd):
    cfg, _ = ref_load_workdir(wd)
    st = RefCheckpointManager(wd, cfg).restore(ref_create_train_state(cfg, jax.random.key(5)))
    return jax.tree.map(np.asarray, st.g_params), jax.tree.map(np.asarray, st.d_params)


def test_cli_workdir_and_generate_match_the_reference(tmp_path, capsys, monkeypatch):
    (rrc, rout, _, rwd), (prc, pout, perr, pwd) = _both_clis(
        tmp_path, capsys, ["--tf-ckpt", os.path.join(FIXTURE, "model.ckpt")])
    assert rrc == prc == 0, perr
    assert pout.splitlines()[0] == rout.splitlines()[0] == "[sgg.convert] 37 reference variables"
    rg, rd = _ref_restored(rwd)
    pg, pd = _port_trees(pwd)
    _assert_trees_equal(pg, rg)
    _assert_trees_equal(pd, rd)
    with open(os.path.join(pwd, "config.json")) as f:
        assert json.load(f)["model"]["vocab_size"] == 14

    # generate on both workdirs; the port fed the reference CLI's draws (its
    # key split once to warm up, then once for the one batch)
    rgraphs, pgraphs = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    flags = ["--num-samples", "3", "--num-images", "4", "--batch-size", "4", "--seed", "0"]
    assert ref_generate.main(["--workdir", rwd, "--out", rgraphs, *flags]) == 0
    key = jax.random.split(jax.random.split(jax.random.key(0))[0])[1]
    cfg, _ = ref_load_workdir(rwd)
    real = port_generate.make_indexed_sampler

    def factory(*a, **k):
        sampler = real(*a, **k)
        return lambda g, feats, idx, generator: sampler(
            g, feats, idx, noise=_reference_noise(cfg, key, len(idx), 14))

    monkeypatch.setattr(port_generate, "make_indexed_sampler", factory)
    assert port_generate.main(["--workdir", pwd, "--out", pgraphs, "--device", "cpu",
                               *flags]) == 0
    with open(rgraphs) as f, open(pgraphs) as g:
        want, got = json.load(f), json.load(g)
    assert got == want and sum(len(x["triples"]) for x in got["scene_graphs"]) > 4


@pytest.mark.parametrize("variant", ["dry run", "dry run unmatched", "npz",
                                     "skip discriminator", "generator-only npz"])
def test_cli_variants_match_the_reference(tmp_path, capsys, variant):
    with np.load(os.path.join(FIXTURE, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    npz = str(tmp_path / "ref.npz")
    extra = []
    if variant == "dry run unmatched":
        del arrays["generator/deep_out/weights"]
    if variant == "generator-only npz":
        arrays = {k: v for k, v in arrays.items() if k.startswith("generator/")}
    if variant.startswith("dry run"):
        extra = ["--dry-run"]
    if variant == "skip discriminator":
        extra = ["--skip-discriminator"]
    np.savez(npz, **arrays)
    (rrc, rout, rerr, rwd), (prc, pout, perr, pwd) = _both_clis(tmp_path, capsys,
                                                                ["--npz", npz], *extra)
    assert prc == rrc == (1 if variant == "dry run unmatched" else 0), perr
    lines = lambda s: [ln for ln in s.splitlines() if not ln.startswith("[sgg.convert] wrote")]  # noqa: E731
    assert lines(pout) == lines(rout)
    if variant.startswith("dry run"):
        assert "dry run:" in pout and not os.path.exists(pwd)
        assert ("UNMATCHED generator/deep_out/kernel" in pout) == (variant != "dry run")
        return
    rg, rd = _ref_restored(rwd)
    pg, pd = _port_trees(pwd)
    _assert_trees_equal(pg, rg)
    if variant == "npz":
        _assert_trees_equal(pd, rd)
    else:  # the critic keeps the port's own initialization
        from sgg_torch.config import get_config
        from sgg_torch.train.state import create_train_state

        cfg = get_config("smoke").override(SETS)
        cfg.model.vocab_size = 14
        _assert_trees_equal(pd, critic_state_dict_to_flax(
            create_train_state(cfg, cfg.train.seed).critic.state_dict()))
    if variant == "generator-only npz":
        assert "no discriminator variables found — converting generator only" in pout


def test_fixture_bundle_equals_its_npz(saved):
    _, _, tf = saved
    with np.load(os.path.join(FIXTURE, "arrays.npz")) as z:
        want = {k: z[k] for k in z.files}
    got = convert.read_tf_checkpoint(FIXTURE)
    assert sorted(got) == sorted(want)
    reader = tf.train.load_checkpoint(os.path.join(FIXTURE, "model.ckpt"))
    for name, a in want.items():
        assert got[name].dtype == a.dtype and got[name].tobytes() == a.tobytes(), name
        b = reader.get_tensor(name)
        assert np.array_equal(b.astype(a.dtype), a) and b.shape == a.shape, name
