"""Feature extraction (``sgg_torch.data.extract``) and ``preprocess --encoder
vgg19`` against ``sgg.data.extract`` and ``sgg.cli.preprocess`` on the CPU:
VGG-19 at 64 px with the repo's trained weights
(``results/enc_pretrain_v3_r4/encoder_params.npz``) in float32 on the
committed VG-shaped JPEG fixture. ``extract_features`` and
``extract_to_shards`` give the reference's features within 1e-4 x max, the
same ids and triples, and the same shard count and sizes with a ragged last
batch and a ragged last shard. Both preprocess CLIs, with ``--encoder-ckpt``
(a directory with ``pretrain_meta.json``) and with ``--vgg-weights`` (a
``.npy`` dict), write the same shards within that tolerance and the same
``vocab.json`` byte for byte. The stall watchdog exits 86 in a subprocess
whose encoder hangs (poll constant shortened).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sgg.cli.preprocess as jax_preprocess
from sgg.data import extract as jax_extract
from sgg.train.pretrain import load_params_npz as jax_load_params_npz
from sgg_torch.cli import preprocess
from sgg_torch.convert_flax import encoder_flax_to_state_dict, load_params_npz
from sgg_torch.data import extract, list_shards, read_feature_shard
from test_torch_jpeg import reference_native  # noqa: F401  (sgg's JPEG loader, private)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures_torch", "vg_jpeg")
IMAGES = os.path.join(FIXTURE, "images")
TRAINED_VGG = os.path.join(REPO, "results", "enc_pretrain_v3_r4", "encoder_params.npz")
SIZE = 64


def _close(got, want):
    """Within 1e-4 x max in float32; float16 shards also within one float16
    ulp of the stored value (a value near a rounding boundary of the cast
    may round the other way)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.astype(np.float32), want.astype(np.float32)
    tol = 1e-4 * np.abs(w).max()
    if want.dtype == np.float16:
        tol = tol + np.spacing(np.abs(want)).astype(np.float32)
    assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()


@pytest.fixture(scope="module")
def weights():
    """(reference params, port state_dict) of the trained VGG-19."""
    return {"params": jax_load_params_npz(TRAINED_VGG)}, encoder_flax_to_state_dict(
        load_params_npz(TRAINED_VGG))


def _paths(n):
    return [os.path.join(IMAGES, f"{1000 + i}.jpg") for i in range(n)]


def test_extract_features_matches_reference(weights):
    paths = _paths(6)
    want = jax_extract.extract_features("vgg19", paths, encoder_params=weights[0],
                                        batch_size=4, image_size=SIZE)
    got = extract.extract_features("vgg19", paths, encoder_params=weights[1], batch_size=4,
                                   image_size=SIZE, device="cpu")
    assert got.shape == (6, 16, 512)
    _close(got, want)


@pytest.mark.parametrize("feat_dtype", [np.float32, np.float16])
def test_extract_to_shards_matches_reference(weights, tmp_path, feat_dtype, capsys):
    """10 images, batches of 4 (the last ragged), shards of 3 (the last ragged)."""
    paths = _paths(10)
    ids = list(range(1000, 1010))
    r = np.random.RandomState(0)
    triples = [r.randint(0, 9, (1 + i % 3, 3)).astype(np.int32) for i in range(10)]
    kw = dict(shard_size=3, batch_size=4, image_size=SIZE, feat_dtype=feat_dtype, log_every=1)
    want = jax_extract.extract_to_shards("vgg19", ids, paths, triples, str(tmp_path / "ref"),
                                         encoder_params=weights[0], **kw)
    got = extract.extract_to_shards("vgg19", ids, paths, triples, str(tmp_path / "port"),
                                    encoder_params=weights[1], device="cpu", **kw)
    assert got["num_shards"] == want["num_shards"] == 4 and got["num_images"] == 10
    assert set(got) == set(want)
    assert 0 <= got["decode_wait_frac"] <= 1 and got["images_per_sec"] > 0
    mine, theirs = list_shards(str(tmp_path / "port")), list_shards(str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs]
    sizes = []
    for a, b in zip(mine, theirs):
        sa, sb = read_feature_shard(a), read_feature_shard(b)
        np.testing.assert_array_equal(sa["image_ids"], sb["image_ids"])
        np.testing.assert_array_equal(sa["triples"], sb["triples"])
        _close(sa["features"], sb["features"])
        sizes.append(len(sa["image_ids"]))
    assert sizes == [3, 3, 3, 1]
    assert "[extract] 4/10 images" in capsys.readouterr().out


@pytest.fixture(scope="module")
def cli_weights(tmp_path_factory):
    """A pretrain-style directory (encoder_params.npz + pretrain_meta.json at
    64 px) and a ``.npy`` weight dict of the same trained VGG-19."""
    d = tmp_path_factory.mktemp("weights")
    ckpt = d / "ckpt"
    ckpt.mkdir()
    os.symlink(TRAINED_VGG, ckpt / "encoder_params.npz")
    (ckpt / "pretrain_meta.json").write_text(json.dumps(
        {"encoder": "vgg19", "image_size": SIZE, "vit_dims": [768, 12, 12],
         "moe_experts": 0, "moe_top_k": 2}))
    raw = np.load(TRAINED_VGG)
    names = sorted({k.split("/")[0] for k in raw.files})
    npy = str(d / "vgg19.npy")
    np.save(npy, {n: [raw[f"{n}/kernel"], raw[f"{n}/bias"]] for n in names},
            allow_pickle=True)
    return str(ckpt), npy


@pytest.mark.parametrize("how", ["encoder-ckpt", "vgg-weights"])
def test_preprocess_vgg19_matches_reference(cli_weights, tmp_path, how):
    ckpt, npy = cli_weights
    args = ["--vg-dir", FIXTURE, "--image-dir", IMAGES, "--encoder", "vgg19",
            "--max-images", "12", "--shard-size", "4", "--batch-size", "5",
            "--feat-dtype", "float16", "--seed", "1"]
    if how == "encoder-ckpt":
        args += ["--encoder-ckpt", ckpt]
    else:  # the .npy route runs at the reference's 224 px: 2 train and 1 test image
        args = [a if a != "12" else "3" for a in args] + ["--vgg-weights", npy,
                                                          "--test-fraction", "0.34"]
    assert jax_preprocess.main(["--out-dir", str(tmp_path / "ref"), *args]) == 0
    assert preprocess.main(["--out-dir", str(tmp_path / "port"), *args,
                            "--device", "cpu"]) == 0
    with open(tmp_path / "port" / "vocab.json", "rb") as f, \
            open(tmp_path / "ref" / "vocab.json", "rb") as g:
        assert f.read() == g.read()
    for sub in ("", "test"):
        mine = list_shards(str(tmp_path / "port" / sub))
        theirs = list_shards(str(tmp_path / "ref" / sub))
        assert mine and [os.path.basename(p) for p in mine] == \
            [os.path.basename(p) for p in theirs]
        for a, b in zip(mine, theirs):
            sa, sb = read_feature_shard(a), read_feature_shard(b)
            np.testing.assert_array_equal(sa["image_ids"], sb["image_ids"])
            np.testing.assert_array_equal(sa["triples"], sb["triples"])
            _close(sa["features"], sb["features"])


def test_preprocess_vgg19_refuses_an_moe_checkpoint(tmp_path):
    """An MoE checkpoint, refused before MoE was ported, now extracts: both
    preprocess CLIs read ``moe_experts`` and ``moe_top_k`` (1 here) from
    ``pretrain_meta.json`` and write the same shards from a small MoE ViT."""
    from sgg_torch.convert_flax import encoder_state_dict_to_flax
    from sgg_torch.models.encoders import make_encoder
    from sgg_torch.train.pretrain import save_params_npz

    ckpt = tmp_path / "moe"
    ckpt.mkdir()
    torch.manual_seed(5)
    enc = make_encoder("vit_b16", image_size=SIZE, vit_dims=(32, 1, 2), moe_experts=4,
                       moe_top_k=1)
    save_params_npz(str(ckpt / "encoder_params.npz"),
                    encoder_state_dict_to_flax(enc.state_dict(), "vit_b16")["params"])
    (ckpt / "pretrain_meta.json").write_text(json.dumps(
        {"encoder": "vit_b16", "image_size": SIZE, "vit_dims": [32, 1, 2],
         "moe_experts": 4, "moe_top_k": 1}))
    args = ["--vg-dir", FIXTURE, "--image-dir", IMAGES, "--encoder-ckpt", str(ckpt),
            "--max-images", "6", "--batch-size", "4", "--test-fraction", "0.34"]
    assert jax_preprocess.main(["--out-dir", str(tmp_path / "ref"), *args]) == 0
    assert preprocess.main(["--out-dir", str(tmp_path / "port"), *args,
                            "--device", "cpu"]) == 0
    for sub in ("", "test"):
        mine = list_shards(str(tmp_path / "port" / sub))
        theirs = list_shards(str(tmp_path / "ref" / sub))
        assert mine and len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            sa, sb = read_feature_shard(a), read_feature_shard(b)
            np.testing.assert_array_equal(sa["image_ids"], sb["image_ids"])
            assert sa["features"].shape[1:] == (16, 32)
            _close(sa["features"], sb["features"])


STALL_SCRIPT = """
import sys, time
import numpy as np
from sgg_torch.data import extract

extract.STALL_POLL_SEC = 0.05

def hanging(*a, **k):
    def apply(images):
        time.sleep(60)
    return apply

extract.make_extractor = hanging
paths = [f"{sys.argv[1]}/{1000 + i}.jpg" for i in range(4)]
extract.extract_to_shards("vgg19", list(range(4)), paths, [np.zeros((1, 3), np.int32)] * 4,
                          sys.argv[2], batch_size=2, image_size=16, stall_exit_sec=0.3,
                          device="cpu")
print("returned")
"""


def test_extract_stall_watchdog_exits_86(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", STALL_SCRIPT, IMAGES, str(tmp_path / "out")],
                          capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 86, proc.stdout + proc.stderr
    assert "[extract] STALL: no batch readback for" in proc.stdout
    assert "returned" not in proc.stdout
