"""The port's exported sampler artifact (``sgg_torch.export``,
``sgg_torch.cli.export``, ``sgg_torch.serve.ArtifactEngine``) on the CPU, at
smoke widths, K = 2, in three ``torch.export`` traces:

- ``cli.export --batch-size 0 --check`` on a port workdir whose generator is a
  seeded port one (converted to flax for the reference's export): exit 0; the
  artifact reloaded gives the live sampler's tokens bit for bit for the same
  noise at two batch sizes (the symbolic batch), legal under the step mask; its
  meta is self-contained (vocab, shapes, the noise inputs, the step); its
  weights are the program's lifted parameters;
- fed the noise that the reference's sampler draws from key k (the
  ``decode_gumbel_noise`` key-split pattern), it gives the tokens of the
  reference's own ``load_artifact(...)(x, key_data(k))``;
- ``ArtifactEngine`` gives the graphs of an ``InferenceEngine`` on the same
  weights and seed (both draw in ``make_sampler``'s order), serves a
  features request over HTTP and refuses an images request and a
  per-request temperature (400);
- pixels in: a small ViT encoder with ``quant`` '' and 'int8' inside the
  program, against the live pipeline (the library route, quantized alike),
  bit for bit;
- the refusals: the reference's ``.sgx``, ``tpu``.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax

from sgg.export import export_sampler as jax_export_sampler
from sgg.export import load_artifact as jax_load_artifact
from sgg_torch import export, serve
from sgg_torch.cli import export as export_cli
from sgg_torch.config import Config as PortConfig
from sgg_torch.config import get_config
from sgg_torch.convert_flax import generator_state_dict_to_flax
from sgg_torch.eval.sampler import draw_noise, make_sampler
from sgg_torch.models.encoders import make_encoder, make_image_encoder
from sgg_torch.train.checkpoint import save_generator
from sgg_torch.train.state import make_generator
from test_torch_serve import Served, _cfg, _feats, _post, _reference_noise, _vocab_pair

torch.set_num_threads(1)

K = 2


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(reference cfg, reference vocab, the generator's flax params, port
    cfg, port vocab, port weights, artifact path, the CLI's exit code) for a
    smoke workdir at step 7 with a seeded port generator, exported with a
    symbolic batch and checked."""
    wd = str(tmp_path_factory.mktemp("export_wd"))
    jvocab, pvocab = _vocab_pair(wd)
    cfg = _cfg("lstm", len(jvocab))
    pcfg = PortConfig.from_json(cfg.to_json())
    pcfg.workdir = wd
    torch.manual_seed(5)
    weights = serve.ServeWeights(7, make_generator(pcfg).state_dict(), None)
    with open(os.path.join(wd, "config.json"), "w") as f:
        f.write(pcfg.to_json())
    save_generator(wd, weights.g_params, step=7)
    out = os.path.join(wd, "model.pt2")
    argv = ["--workdir", wd, "--out", out, "--batch-size", "0", "--num-samples", str(K),
            "--check", "--device", "cpu", "--seed", "4"]
    return types.SimpleNamespace(cfg=cfg, jvocab=jvocab,
                                 g_params=generator_state_dict_to_flax(weights.g_params),
                                 pcfg=pcfg, pvocab=pvocab, weights=weights, path=out,
                                 rc=export_cli.main(argv))


@pytest.fixture(scope="module")
def engine(exported):
    """An ArtifactEngine over the artifact (B 3, seed 3): its load is the
    module's round trip."""
    return serve.ArtifactEngine(exported.path, device="cpu", seed=3, batch_size=3)


def test_cli_export_check_exits_0_with_self_contained_meta(exported, engine, capsys):
    assert exported.rc == 0
    meta = engine.meta
    assert meta["artifact_version"] == export.ARTIFACT_VERSION and meta["step"] == 7
    assert meta["input"] == "features" and meta["batch_size"] == 0 and meta["num_samples"] == K
    assert meta["vocab_tokens"] == list(exported.pvocab.tokens)
    assert meta["vocab_is_predicate"] == [bool(b) for b in exported.pvocab.is_predicate]
    Z, V = exported.pcfg.model.noise_dim, len(exported.pvocab)
    assert meta["noise"] == {"z": [K, "batch", Z], "z_dtype": "float32",
                             "gumbel": [K, "batch", 3, V], "gumbel_dtype": "float32"}
    assert meta["platforms"] == ["cpu", "cuda"] and meta["temperature"] == 1.0
    ep = engine._call.exported  # the program's weights are inputs, not constants
    params = [s.target for s in ep.graph_signature.input_specs
              if s.kind == torch.export.graph_signature.InputKind.PARAMETER]
    assert sorted(params) == sorted(f"generator.{k}" for k in exported.weights.g_params)
    for k, v in exported.weights.g_params.items():
        assert torch.equal(ep.state_dict[f"generator.{k}"], v)


def test_round_trip_any_batch_bit_identical_and_legal(exported, engine):
    live = make_sampler(exported.pcfg, step_mask=exported.pvocab.step_mask(), num_samples=K)
    vocab = exported.pvocab
    for n, seed in ((2, 1), (5, 2)):
        x = torch.from_numpy(_feats(n, seed))
        noise = export.artifact_noise(engine.meta, n, torch.Generator().manual_seed(seed))
        got = engine._call(x, *noise)
        assert got.dtype == torch.int32 and tuple(got.shape) == (n, K, 3)
        assert torch.equal(got, live(exported.weights.g_params, x, noise=noise))
        # The same draws as make_sampler takes from the generator itself.
        assert torch.equal(got, live(exported.weights.g_params, x,
                                     torch.Generator().manual_seed(seed)))
        t = got.numpy().reshape(-1, 3)
        assert all(vocab.is_object[s] and vocab.is_predicate[p] and vocab.is_object[o]
                   for s, p, o in t)
    triples = export.decode_tokens(got, engine.meta)
    assert len(triples) == 5 and triples[0][0][1] == vocab.tokens[int(got[0, 0, 1])]


def test_reference_noise_gives_reference_artifact_tokens(exported, engine, tmp_path):
    cfg = exported.cfg
    path = str(tmp_path / "model.sgx")
    from sgg.export import save_artifact as jax_save_artifact

    jax_save_artifact(path, *jax_export_sampler(cfg, exported.jvocab, exported.g_params,
                                                batch_size=3, num_samples=K,
                                                platforms=("cpu",)))
    call, _ = jax_load_artifact(path)
    x = _feats(3, 6)
    for k in (11,):
        key = jax.random.key(k)
        want = np.asarray(call(x, np.asarray(jax.random.key_data(key))))
        got = engine._call(torch.from_numpy(x), *_reference_noise(cfg, key, 3, K))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="reference's artifact"):
        export.load_artifact(path)


def test_artifact_engine_serves_features_and_refuses_images(exported, engine):
    """Graphs equal a workdir engine's on the same weights and seed; over
    HTTP a features request is answered, an images request and a temperature
    are 400s."""
    eng = engine
    eng._generator.manual_seed(5)
    ref = serve.InferenceEngine(PortConfig.from_json(exported.pcfg.to_json()), exported.pvocab,
                                exported.weights, device="cpu", batch_size=3, num_samples=K,
                                seed=5, rank="freq")
    feats = _feats(4, 9)  # a chunk of 3 and one padded
    assert eng.generate(feats) == ref.generate(feats)
    assert eng.step == 7 and eng.feature_shape == (9, 16)
    s = Served(serve, eng)
    try:
        status, body = _post(s.url, {"features": _feats(2, 3).tolist()})
        assert status == 200 and len(body["scene_graphs"]) == 2
        status, body = _post(s.url, {"images": np.zeros((1, 8, 8, 3), np.uint8).tolist()})
        assert status == 400 and "precomputed features" in body["error"]
        status, body = _post(s.url, {"features": _feats(1).tolist(), "temperature": 0.5})
        assert status == 400 and "temperature" in body["error"]
    finally:
        s.close()


def _vit_cfg(vocab_size):
    cfg = get_config("vit_b16")
    cfg.data.image_size, cfg.data.regions, cfg.data.feat_dim = 32, 4, 64
    cfg.model.vit_dim, cfg.model.vit_layers, cfg.model.vit_heads = 64, 2, 4
    cfg.model.hidden, cfg.model.num_heads, cfg.model.num_layers = 32, 4, 2
    cfg.model.noise_dim, cfg.model.compute_dtype = 8, "float32"
    cfg.model.decoder, cfg.model.attn_dim, cfg.model.embed_dim = "lstm", 16, 16
    cfg.model.use_pallas = False
    cfg.model.vocab_size = vocab_size
    return cfg


@pytest.mark.parametrize("quant", ["", "int8"])
def test_pixels_in_artifact_matches_live_pipeline(exported, quant):
    vocab = exported.pvocab
    cfg = _vit_cfg(len(vocab))
    torch.manual_seed(6)
    g = make_generator(cfg).state_dict()
    enc = make_encoder("vit_b16", image_size=32, vit_dims=cfg.model.vit_dims).state_dict()
    ep, meta = export.export_sampler(cfg, vocab, g, enc_params=enc, quant=quant, batch_size=2,
                                     num_samples=K, platforms=("cpu",))
    assert meta["input"] == "images" and meta["quant"] == quant and meta["image_size"] == 32
    imgs = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (2, 32, 32, 3))
                            .astype(np.uint8))
    noise = draw_noise(torch.Generator().manual_seed(8), K, 2, 8, len(vocab), torch.float32,
                       "cpu")
    with torch.no_grad():
        got = ep.module()(imgs, *noise)
    feats = make_image_encoder(cfg, enc, torch.device("cpu"), quant=quant)(imgs)
    want = make_sampler(cfg, step_mask=vocab.step_mask(), num_samples=K)(g, feats, noise=noise)
    assert torch.equal(got, want)


def test_refusals(tmp_path, capsys):
    sgx = str(tmp_path / "ref.sgx")
    np.savez(sgx, __module__=np.zeros(4, np.uint8), meta=np.asarray(json.dumps({})))
    os.replace(sgx + ".npz", sgx)
    with pytest.raises(ValueError, match="cannot read"):
        export.load_artifact(sgx)
    for bad in (("tpu",), ("cpu", "rocm"), ()):
        with pytest.raises(ValueError):
            export.check_platforms(bad)
    assert export_cli.main(["--workdir", str(tmp_path), "--platforms", "cpu,tpu",
                            "--device", "cpu"]) == 2
    assert "sgg.cli.export" in capsys.readouterr().err
