"""The port's generate path against the reference: the K-sample fused
sampler given the same noise, triple ranking and scene-graph assembly,
recall@k, the data layer, and ``sgg_torch.cli.generate`` end to end on the
CPU. Tokens, rankings and recall values must be identical. The
generator-forward sampler (``--decode xla``) on the attention-LSTM. The
pixels-in paths (a ``resnet50`` config at 32 px, a ``vit_b16`` config at
64 px with the transformer decoder): the same synthetic images, features
within 1e-4 x max|ref| (float32 sums in another order over 53 layers) and
identical tokens from them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.cli.common import load_dataset as jax_load_dataset
from sgg.cli.common import make_batch_features as jax_make_batch_features
from sgg.config import get_config as jax_get_config
from sgg.data import TripleDataset as JaxTripleDataset
from sgg.data import synthetic_dataset as jax_synthetic_dataset
from sgg.eval import assemble_scene_graphs as jax_assemble
from sgg.eval import corpus_recall as jax_corpus_recall
from sgg.eval import rank_triples as jax_rank_triples
from sgg.eval.sampler import make_fused_sampler as jax_make_fused_sampler
from sgg.eval.sampler import make_indexed_sampler as jax_make_indexed_sampler
from sgg.eval.sampler import make_sampler as jax_make_sampler
from sgg.kernels.fused_decode import decode_gumbel_noise
from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.train.state import create_train_state, make_models
from sgg.utils.gumbel import sample_gumbel as jax_sample_gumbel
from sgg_torch.cli import generate
from sgg_torch.config import Config as PortConfig
from sgg_torch.config import get_config
from sgg_torch.convert_flax import (
    encoder_flax_to_state_dict,
    flax_to_state_dict,
    generator_flax_to_state_dict,
)
from sgg_torch.data import TripleDataset, list_shards, synthetic_dataset, write_feature_shard
from sgg_torch.eval.recall import corpus_recall, recall_at_k
from sgg_torch.eval.sampler import (
    assemble_scene_graphs,
    make_fused_sampler,
    make_indexed_sampler,
    make_sampler,
    rank_triples,
)
from sgg_torch.train.checkpoint import save_generator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_config("smoke")
    cfg.model.vocab_size = 40
    gen, _ = make_models(cfg)
    r = np.random.RandomState(0)
    B, R, F = 6, cfg.data.regions, cfg.data.feat_dim
    feats = r.randn(B, R, F).astype(np.float32)
    z = r.randn(B, cfg.model.noise_dim).astype(np.float32)
    gvars = gen.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(z), jax.random.key(1))
    mask = np.zeros((3, 40), bool)
    mask[0, :20] = mask[2, :20] = True
    mask[1, 20:] = True
    return cfg, gvars["params"], feats, mask


def _reference_noise(cfg, rng, B, V):
    """The reference sampler's draws: split(rng, K), then per draw
    split(key) into z and the decode's Gumbel noise."""
    zs, gs = [], []
    for key in jax.random.split(rng, K):
        kz, kg = jax.random.split(key)
        zs.append(np.array(jax.random.normal(kz, (B, cfg.model.noise_dim), cfg.model.dtype)))
        gs.append(np.array(decode_gumbel_noise(kg, B, V)))
    return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(gs))


@pytest.mark.parametrize("masked", [False, True])
def test_fused_sampler_matches_reference(setup, masked):
    cfg, g_params, feats, mask = setup
    step_mask = mask if masked else None
    rng = jax.random.key(7)
    ref = jax_make_fused_sampler(cfg, step_mask=step_mask, num_samples=K)(
        g_params, jnp.asarray(feats), rng)
    port_cfg = PortConfig.from_json(cfg.to_json())
    sd = flax_to_state_dict(jax.tree.map(np.asarray, g_params))
    noise = _reference_noise(cfg, rng, feats.shape[0], 40)
    got = make_fused_sampler(port_cfg, step_mask=step_mask, num_samples=K)(
        sd, torch.from_numpy(feats), noise=noise)
    assert got.dtype == torch.int32 and got.shape == (feats.shape[0], K, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_indexed_fused_sampler_matches_reference(setup):
    cfg, g_params, feats, mask = setup
    rng = jax.random.key(11)
    idx = np.array([4, 1, 5, 0], np.int32)
    ref = jax_make_fused_sampler(cfg, step_mask=mask, num_samples=K, indexed=True)(
        g_params, jnp.asarray(feats), jnp.asarray(idx), rng)
    port_cfg = PortConfig.from_json(cfg.to_json())
    sd = flax_to_state_dict(jax.tree.map(np.asarray, g_params))
    got = make_fused_sampler(port_cfg, step_mask=mask, num_samples=K, indexed=True)(
        sd, torch.from_numpy(feats), idx, noise=_reference_noise(cfg, rng, len(idx), 40))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("indexed", [False, True])
def test_xla_sampler_matches_reference_lstm(setup, indexed):
    """The generator-forward sampler on the attention-LSTM decoder, given the
    reference's draws (its per-step Gumbel splits)."""
    cfg, g_params, feats, mask = setup
    rng = jax.random.key(13)
    port_cfg = PortConfig.from_json(cfg.to_json())
    sd = flax_to_state_dict(jax.tree.map(np.asarray, g_params))
    if indexed:
        idx = np.array([5, 2, 0], np.int32)
        ref = jax_make_indexed_sampler(cfg, step_mask=mask, num_samples=K)(
            g_params, jnp.asarray(feats), jnp.asarray(idx), rng)
        got = make_indexed_sampler(port_cfg, step_mask=mask, num_samples=K)(
            sd, torch.from_numpy(feats), idx, noise=_reference_noise(cfg, rng, len(idx), 40))
    else:
        ref = jax_make_sampler(cfg, step_mask=mask, num_samples=K)(
            g_params, jnp.asarray(feats), rng)
        got = make_sampler(port_cfg, step_mask=mask, num_samples=K)(
            sd, torch.from_numpy(feats), noise=_reference_noise(cfg, rng, feats.shape[0], 40))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampler_draws_its_own_noise_from_generator(setup):
    cfg, g_params, feats, mask = setup
    port_cfg = PortConfig.from_json(cfg.to_json())
    sd = flax_to_state_dict(jax.tree.map(np.asarray, g_params))
    sampler = make_fused_sampler(port_cfg, step_mask=mask, num_samples=5)
    a = sampler(sd, torch.from_numpy(feats), torch.Generator().manual_seed(3))
    b = sampler(sd, torch.from_numpy(feats), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (feats.shape[0], 5, 3)
    toks = a.reshape(-1, 3).numpy()
    assert (toks[:, 0] < 20).all() and (toks[:, 1] >= 20).all() and (toks[:, 2] < 20).all()
    with pytest.raises(ValueError):
        make_fused_sampler(port_cfg, tau=0.5)


def _tokens(seed=0, B=5):
    r = np.random.RandomState(seed)
    return r.randint(0, 4, size=(B, 12, 3)).astype(np.int32)  # many repeats


def test_rank_and_assemble_match_reference():
    from sgg.data.vocab import Vocab as JaxVocab

    vocab_path = os.path.join(REPO, "results", "run_v3_bal0.7_ckpt", "vocab.json")
    from sgg_torch.data import Vocab

    tokens = _tokens()
    for row in tokens:
        assert rank_triples(row) == jax_rank_triples(row)
    ids = np.arange(100, 105)
    got = assemble_scene_graphs(tokens, Vocab.load(vocab_path), ids)
    want = jax_assemble(tokens, JaxVocab.load(vocab_path), ids)
    assert got == want
    with pytest.raises(ValueError):
        rank_triples(tokens[0], rank="logp")


def test_recall_matches_reference():
    gen = [list(map(tuple, t)) for t in _tokens(1)]
    gt = [list(map(tuple, t[:4])) for t in _tokens(2)]
    for k in (1, 3, 50):
        assert corpus_recall(gen, gt, k=k) == jax_corpus_recall(gen, gt, k=k)
    assert recall_at_k([(1, 2, 3)], [(1, 2, 3), (4, 5, 6)], k=1) == 0.5


def test_data_layer_matches_reference(tmp_path):
    """Shards written by either package read back identically in the other;
    synthetic data and configs are the reference's."""
    a, b = synthetic_dataset(num_images=6, regions=3, feat_dim=4, seed=2), \
        jax_synthetic_dataset(num_images=6, regions=3, feat_dim=4, seed=2)
    np.testing.assert_array_equal(a["features"], b["features"])
    np.testing.assert_array_equal(a["triples"], b["triples"])
    assert a["vocab"].tokens == b["vocab"].tokens
    triples = [t[: i % 3] for i, t in enumerate(a["triples"])]  # image 0 and 3 empty
    write_feature_shard(str(tmp_path / "shard-00000-of-00001.npz"),
                        np.arange(6), a["features"], triples)
    shards = list_shards(str(tmp_path))
    port_ds, ref_ds = TripleDataset.from_shards(shards), JaxTripleDataset.from_shards(shards)
    assert len(port_ds) == len(ref_ds) == 4
    np.testing.assert_array_equal(port_ds.features, ref_ds.features)
    for x, y in zip(port_ds.triples, ref_ds.triples):
        np.testing.assert_array_equal(x, y)
    for name in ("smoke", "vg1k", "resnet50", "vit_b16"):
        assert get_config(name).to_json() == jax_get_config(name).to_json()
    over = ["train.batch_size=3", "model.compute_dtype=bfloat16", "train.hard=false"]
    assert get_config("smoke").override(over).to_json() == \
        jax_get_config("smoke").override(over).to_json()


@pytest.fixture(scope="module")
def smoke_workdir(tmp_path_factory):
    """A port workdir for the smoke config on synthetic data, its generator
    weights converted from a reference train state."""
    cfg = jax_get_config("smoke")
    data = jax_synthetic_dataset(num_images=4, regions=1, feat_dim=1, seed=cfg.train.seed)
    cfg.model.vocab_size = len(data["vocab"])
    cfg.data.num_synthetic_images = 20
    cfg.train.ema_decay = 0.99
    wd = str(tmp_path_factory.mktemp("smoke_wd"))
    with open(os.path.join(wd, "config.json"), "w") as f:
        f.write(cfg.to_json())
    data["vocab"].save(os.path.join(wd, "vocab.json"))
    state = create_train_state(cfg, jax.random.key(0))
    save_generator(wd, flax_to_state_dict(jax.tree.map(np.asarray, state.g_params)),
                   flax_to_state_dict(jax.tree.map(np.asarray, state.g_ema)), step=0)
    return wd, data["vocab"]


@pytest.mark.parametrize("ema", [False, True])
def test_generate_cli_on_cpu(smoke_workdir, capsys, ema):
    wd, vocab = smoke_workdir
    out = os.path.join(wd, f"graphs_{ema}.json")
    argv = ["--workdir", wd, "--out", out, "--num-samples", "4", "--batch-size", "8",
            "--recall-k", "50", "--device", "cpu"] + (["--ema"] if ema else [])
    assert generate.main(argv) == 0
    printed = capsys.readouterr().out
    assert "[sgg.generate] 20 images, 80 triples" in printed
    assert "[sgg.generate] recall@50 = " in printed
    with open(out) as f:
        result = json.load(f)
    assert result["num_images"] == 20 and len(result["scene_graphs"]) == 20
    for i, g in enumerate(result["scene_graphs"]):
        assert g["image_id"] == i
        assert sum(t["count"] for t in g["triples"]) == 4
        for t in g["triples"]:
            assert vocab.is_object[vocab.id(t["subject"])]
            assert vocab.is_predicate[vocab.id(t["predicate"])]


def test_generate_cli_needs_cuda_or_cpu_flag(smoke_workdir, monkeypatch):
    wd, _ = smoke_workdir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        generate.main(["--workdir", wd, "--num-samples", "2"])


@pytest.mark.parametrize("flags,message", [
    pytest.param(["--quant", "int8"], "no encoder to quantize", id="flags0-not ported yet"),
    (["--decode", "fused", "--top-p", "0.9"], "--top-k/--top-p"),
    (["--decode", "fused", "--rank", "logp"], "log-probs"),
    (["--decode", "fused", "--temperature", "0.5"], "temperature 1.0")])
def test_generate_cli_refuses_unported_options(smoke_workdir, capsys, flags, message):
    """What the fused kernel cannot do (as in the reference), and ``--quant
    int8`` on a precomputed-feature workdir, which has no encoder to
    quantize."""
    wd, _ = smoke_workdir
    assert generate.main(["--workdir", wd, "--device", "cpu", *flags]) == 2
    assert message in capsys.readouterr().err


def test_generate_cli_decode_xla_and_fused_agree(smoke_workdir, capsys):
    """--decode xla (the default) and --decode fused draw the same noise from
    the same seed, so on the CPU they write the same scene graphs."""
    wd, _ = smoke_workdir
    graphs = {}
    for decode in ("xla", "fused"):
        out = os.path.join(wd, f"graphs_{decode}.json")
        assert generate.main(["--workdir", wd, "--out", out, "--num-samples", "4",
                              "--batch-size", "8", "--device", "cpu", "--decode", decode]) == 0
        with open(out) as f:
            graphs[decode] = json.load(f)
    assert "[sgg.generate] 20 images, 80 triples" in capsys.readouterr().out
    assert graphs["xla"] == graphs["fused"]


def test_port_imports_no_jax_and_no_sgg():
    code = (
        "import sys\n"
        "import sgg_torch, sgg_torch.cli.generate, sgg_torch.convert_flax\n"
        "import sgg_torch.models, sgg_torch.kernels.fused_decode\n"
        "import sgg_torch.kernels.conv, sgg_torch.kernels.conv_direct\n"
        "import sgg_torch.kernels.matmul, sgg_torch.data.images\n"
        "import sgg_torch.models.encoders, sgg_torch.models.resnet, sgg_torch.models.vgg\n"
        "import sgg_torch.models.vit, sgg_torch.models.transformer, sgg_torch.train.state\n"
        "import sgg_torch.kernels.flash_attention, sgg_torch.eval.sampler\n"
        "import sgg_torch.cli.train, sgg_torch.cli.common, sgg_torch.kernels.flash_attention_bwd\n"
        "import sgg_torch.models.discriminator, sgg_torch.train.losses, sgg_torch.train.step\n"
        "import sgg_torch.train.metrics, sgg_torch.train.checkpoint, sgg_torch.data.pipeline\n"
        "import sgg_torch.cli.evaluate, sgg_torch.train.eval_probe, sgg_torch.utils.profiling\n"
        "import sgg_torch.serve, sgg_torch.api, sgg_torch.cli.serve\n"
        "import sgg_torch.cli.preprocess, sgg_torch.data.vg, sgg_torch.utils.debug\n"
        "import sgg_torch.native, sgg_torch.native.loader, sgg_torch.data.extract\n"
        "import sgg_torch.data.images\n"
        "import sgg_torch.models.moe, sgg_torch.train.pretrain, sgg_torch.cli.pretrain\n"
        "import sgg_torch.cli.synth_corpus, sgg_torch.data.synthetic\n"
        "import sgg_torch.export, sgg_torch.cli.export, sgg_torch.kernels.quant\n"
        "import sgg_torch.dist, sgg_torch.dist.mesh, sgg_torch.dist.multihost\n"
        "import sgg_torch.convert, sgg_torch.cli.convert, sgg_torch.data.grain_pipeline\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()) as help_text:\n"
        "    try:\n"
        "        sgg_torch.cli.convert.main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "assert '--tf-ckpt' in help_text.getvalue()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'sgg', 'PIL', 'tensorflow', 'grain'))\n"
        "assert not bad, bad\n"
        "from sgg_torch.kernels import build\n"
        "assert not build.load_library.cache_info().currsize  # nothing built at import\n"
        "from sgg_torch.native import loader\n"
        "assert loader._lib is None and loader._error is None  # the loader neither\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _resnet50_cfg():
    """The named ``resnet50`` config cut to 32 px (one region) and small
    decoder widths, in float32 for a tight comparison."""
    cfg = jax_get_config("resnet50")
    cfg.data.image_size = 32
    cfg.data.regions = 1
    cfg.data.num_synthetic_images = 5
    cfg.model.compute_dtype = "float32"
    cfg.model.hidden, cfg.model.embed_dim, cfg.model.attn_dim = 32, 16, 16
    cfg.model.noise_dim = 8
    return cfg


@pytest.fixture(scope="module")
def pixels_setup():
    """A ``resnet50``-config workdir: reference encoder (random BN
    statistics) and generator weights, converted to the port."""
    cfg = _resnet50_cfg()
    ds, vocab = jax_load_dataset(cfg)
    cfg.model.vocab_size = len(vocab)
    init = jax.jit(jax_make_encoder("resnet50").init)
    p = init(jax.random.key(0), jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]
    r = np.random.RandomState(4)
    p = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            (0.5 + r.rand(*v.shape)) if path[-1].key == "bn_var"
            else (0.1 * r.randn(*v.shape)) if path[-1].key in ("bn_mean", "bn_bias")
            else v, np.float32),
        p)
    enc_params = {"params": p}
    gen, _ = make_models(cfg)
    gvars = gen.init(jax.random.key(1), jnp.zeros((2, 1, 2048)),
                     jnp.zeros((2, cfg.model.noise_dim)), jax.random.key(2))
    return cfg, ds, vocab, enc_params, gvars["params"]


def test_pixels_in_features_and_tokens_match_reference(pixels_setup):
    cfg, ds, vocab, enc_params, g_params = pixels_setup
    port_cfg = PortConfig.from_json(cfg.to_json())
    port_ds, _ = generate.load_dataset(port_cfg)
    np.testing.assert_array_equal(port_ds.images, ds.images)
    for a, b in zip(port_ds.triples, ds.triples):
        np.testing.assert_array_equal(a, b)
    idx = np.array([4, 0, 2])
    want = jax_make_batch_features(cfg, ds, enc_params)(idx)
    got = generate.make_batch_features(port_cfg, port_ds, encoder_flax_to_state_dict(enc_params),
                                       torch.device("cpu"))(idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 1, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())

    rng = jax.random.key(5)
    ref = jax_make_fused_sampler(cfg, step_mask=vocab.step_mask(), num_samples=K)(
        g_params, jnp.asarray(want), rng)
    tok = make_fused_sampler(port_cfg, step_mask=vocab.step_mask(), num_samples=K)(
        flax_to_state_dict(jax.tree.map(np.asarray, g_params)), got,
        noise=_reference_noise(cfg, rng, len(idx), cfg.model.vocab_size))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def pixels_workdir(pixels_setup, tmp_path_factory):
    cfg, _, vocab, enc_params, g_params = pixels_setup
    wd = str(tmp_path_factory.mktemp("resnet50_wd"))
    with open(os.path.join(wd, "config.json"), "w") as f:
        f.write(cfg.to_json())
    vocab.save(os.path.join(wd, "vocab.json"))
    sd = flax_to_state_dict(jax.tree.map(np.asarray, g_params))
    save_generator(wd, sd, step=3, enc_params=encoder_flax_to_state_dict(enc_params))
    return wd, vocab, sd


def test_generate_cli_pixels_in_on_cpu(pixels_workdir, capsys):
    """5 images in batches of 2: the short last batch is padded to 2."""
    wd, vocab, _ = pixels_workdir
    out = os.path.join(wd, "graphs.json")
    argv = ["--workdir", wd, "--out", out, "--num-samples", "3", "--batch-size", "2",
            "--recall-k", "5", "--device", "cpu"]
    assert generate.main(argv) == 0
    printed = capsys.readouterr().out
    assert "[sgg.generate] 5 images, 15 triples" in printed and "recall@5 = " in printed
    with open(out) as f:
        result = json.load(f)
    assert [g["image_id"] for g in result["scene_graphs"]] == list(range(5))
    for g in result["scene_graphs"]:
        assert sum(t["count"] for t in g["triples"]) == 3
        for t in g["triples"]:
            assert vocab.is_object[vocab.id(t["subject"])]
            assert vocab.is_predicate[vocab.id(t["predicate"])]


def test_generate_cli_refuses_pixels_workdir_without_encoder(pixels_workdir, tmp_path, capsys):
    wd, vocab, sd = pixels_workdir
    for name in ("config.json", "vocab.json"):
        with open(os.path.join(wd, name)) as src, open(tmp_path / name, "w") as dst:
            dst.write(src.read())
    save_generator(str(tmp_path), sd)
    assert generate.main(["--workdir", str(tmp_path), "--device", "cpu"]) == 1
    assert "no encoder weights" in capsys.readouterr().err


def _vit_cfg(dtype="float32"):
    """The named ``vit_b16`` config cut to 64 px (16 patches),
    ``vit_dims=(64, 2, 4)`` and small decoder widths."""
    cfg = jax_get_config("vit_b16")
    cfg.data.image_size = 64
    cfg.data.regions = 16
    cfg.data.feat_dim = 64
    cfg.data.num_synthetic_images = 5
    cfg.model.vit_dim, cfg.model.vit_layers, cfg.model.vit_heads = 64, 2, 4
    cfg.model.hidden, cfg.model.num_heads, cfg.model.num_layers = 32, 4, 2
    cfg.model.noise_dim = 8
    cfg.model.compute_dtype = dtype
    return cfg


@pytest.fixture(scope="module")
def vit_setup():
    """A ``vit_b16``-config dataset with reference encoder and transformer
    generator weights."""
    cfg = _vit_cfg()
    ds, vocab = jax_load_dataset(cfg)
    cfg.model.vocab_size = len(vocab)
    enc = jax_make_encoder("vit_b16", image_size=64, vit_dims=cfg.model.vit_dims)
    enc_params = jax.jit(enc.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    gen, _ = make_models(cfg)
    gvars = gen.init(jax.random.key(1), jnp.zeros((2, 16, 64)),
                     jnp.zeros((2, cfg.model.noise_dim)), jax.random.key(2))
    return cfg, ds, vocab, jax.tree.map(np.asarray, enc_params), gvars["params"]


def test_vit_features_and_tokens_match_reference(vit_setup):
    """The port's generate builds the ViT on the flash route (its plain
    version on the CPU), the reference's on the unfused route: features
    within 1e-4 x max, and identical tokens from them."""
    cfg, ds, vocab, enc_params, g_params = vit_setup
    port_cfg = PortConfig.from_json(cfg.to_json())
    port_ds, _ = generate.load_dataset(port_cfg)
    np.testing.assert_array_equal(port_ds.images, ds.images)
    idx = np.array([4, 0, 2])
    want = jax_make_batch_features(cfg, ds, enc_params)(idx)
    got = generate.make_batch_features(port_cfg, port_ds, encoder_flax_to_state_dict(enc_params),
                                       torch.device("cpu"))(idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 16, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())

    rng = jax.random.key(5)
    ref = jax_make_sampler(cfg, step_mask=vocab.step_mask(), num_samples=K)(
        g_params, jnp.asarray(want), rng)
    zs, gs = [], []
    for key in jax.random.split(rng, K):
        kz, kg = jax.random.split(key)
        zs.append(np.array(jax.random.normal(kz, (len(idx), cfg.model.noise_dim))))
        gs.append(np.array(jax_sample_gumbel(kg, (len(idx), 3, cfg.model.vocab_size))))
    tok = make_sampler(port_cfg, step_mask=vocab.step_mask(), num_samples=K)(
        generator_flax_to_state_dict(g_params, port_cfg), got,
        noise=(torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(gs))))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def vit_workdir(vit_setup, tmp_path_factory):
    """The same weights under the config's own compute dtype, bfloat16."""
    _, _, vocab, enc_params, g_params = vit_setup
    cfg = _vit_cfg("bfloat16")
    cfg.model.vocab_size = len(vocab)
    wd = str(tmp_path_factory.mktemp("vit_wd"))
    with open(os.path.join(wd, "config.json"), "w") as f:
        f.write(cfg.to_json())
    vocab.save(os.path.join(wd, "vocab.json"))
    sd = generator_flax_to_state_dict(g_params, PortConfig.from_json(cfg.to_json()))
    save_generator(wd, sd, step=2, enc_params=encoder_flax_to_state_dict(enc_params))
    return wd, vocab


def test_generate_cli_vit_on_cpu(vit_workdir, capsys):
    """5 images in batches of 2 through the default --decode xla."""
    wd, vocab = vit_workdir
    out = os.path.join(wd, "graphs.json")
    argv = ["--workdir", wd, "--out", out, "--num-samples", "3", "--batch-size", "2",
            "--recall-k", "5", "--device", "cpu"]
    assert generate.main(argv) == 0
    printed = capsys.readouterr().out
    assert "[sgg.generate] 5 images, 15 triples" in printed and "recall@5 = " in printed
    with open(out) as f:
        result = json.load(f)
    assert [g["image_id"] for g in result["scene_graphs"]] == list(range(5))
    for g in result["scene_graphs"]:
        assert sum(t["count"] for t in g["triples"]) == 3
        for t in g["triples"]:
            assert vocab.is_object[vocab.id(t["subject"])]
            assert vocab.is_predicate[vocab.id(t["predicate"])]


def test_generate_cli_refuses_fused_decode_for_transformer(vit_workdir, capsys):
    wd, _ = vit_workdir
    assert generate.main(["--workdir", wd, "--device", "cpu", "--decode", "fused"]) == 2
    assert "attention-LSTM decoder only" in capsys.readouterr().err
