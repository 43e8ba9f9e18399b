"""The port's serving tier (``sgg_torch.serve``, ``sgg_torch.api``,
``sgg_torch.cli.serve``) against ``sgg.serve`` and ``sgg.api`` on the CPU, at
smoke widths (R 9, F 16): the binary request format and ``ServeStats``
(identical); the engine's graphs on the reference's own draws for both
decoders, ranks ``freq`` and ``logp``, default and per-row temperatures, a
padded and a chunked request (identical, ``log_prob`` within 1e-5); the
pixels-in engine on a small resnet50 (features within 1e-4 x max in f32,
identical graphs); the batcher's routing against the reference's with a stub
engine; the HTTP surface; the CLI's refusals and one ``--device cpu`` run in a
subprocess; ``SceneGraphGenerator`` (identical). Every server, batcher and
subprocess is closed in ``finally``, and every wait has a timeout.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sgg.api as jax_api
import sgg.serve as jax_serve
from sgg.config import get_config as jax_get_config
from sgg.data.vocab import Vocab as JaxVocab
from sgg.kernels.fused_decode import decode_gumbel_noise
from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.train.state import make_models
from sgg.utils.gumbel import sample_gumbel as jax_sample_gumbel
from sgg_torch import api, serve
from sgg_torch.cli import serve as serve_cli
from sgg_torch.config import Config as PortConfig
from sgg_torch.convert_flax import encoder_flax_to_state_dict, generator_flax_to_state_dict
from sgg_torch.data import Vocab
from sgg_torch.train.checkpoint import CheckpointManager
from sgg_torch.train.state import create_train_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
LOGP_TOL = 1e-5
TIMEOUT = 60


def _vocab_pair(tmp_dir):
    vocab = JaxVocab.build(Counter({f"obj{i}": 100 - i for i in range(12)}),
                           Counter({f"pred{i}": 100 - i for i in range(8)}))
    path = os.path.join(tmp_dir, "vocab.json")
    vocab.save(path)
    return JaxVocab.load(path), Vocab.load(path)


def _cfg(decoder, V):
    cfg = jax_get_config("smoke")
    cfg.model.vocab_size = V
    if decoder == "transformer":
        cfg.model.decoder = "transformer"
        cfg.model.num_layers, cfg.model.num_heads = 2, 4
    return cfg


def _gumbel(cfg, key, n):
    """The decoder's Gumbel noise from its key: per-step splits for the
    attention-LSTM, one [n, 3, V] draw for the slot decoder."""
    V = cfg.model.vocab_size
    if cfg.model.decoder == "lstm":
        return np.array(decode_gumbel_noise(key, n, V))
    return np.array(jax_sample_gumbel(key, (n, 3, V), jnp.float32))


def _reference_noise(cfg, rng, n, k):
    """The reference sampler's draws from ``rng``: K keys, each split into
    the z key and the Gumbel key."""
    zs, gs = [], []
    for key in jax.random.split(rng, k):
        kz, kg = jax.random.split(key)
        zs.append(np.array(jax.random.normal(kz, (n, cfg.model.noise_dim), cfg.model.dtype)))
        gs.append(_gumbel(cfg, kg, n))
    return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(gs))


def feed_reference_draws(obj, cfg, seed, k):
    """Replace ``obj``'s sampler by one that takes, on each call, the draws
    of the reference's next ``self._rng`` split, as ``sgg.serve`` and
    ``sgg.api`` make them from ``jax.random.key(seed)``."""
    inner = obj._sampler
    state = {"rng": jax.random.key(seed)}

    def sampler(g_params, feats, generator=None, temp=None):
        state["rng"], sub = jax.random.split(state["rng"])
        return inner(g_params, feats, noise=_reference_noise(cfg, sub, feats.shape[0], k),
                     temp=temp)

    obj._sampler = sampler


def _feats(n, seed=0, R=9, F=16):
    return np.random.RandomState(seed).randn(n, R, F).astype(np.float32)


def assert_graphs_match(got, want):
    """Identical graphs; each triple's ``logp`` (rank freq_logp/logp) within
    LOGP_TOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert len(g["triples"]) == len(w["triples"])
        for a, b in zip(g["triples"], w["triples"]):
            assert set(a) == set(b)
            assert {k: v for k, v in a.items() if k != "logp"} == \
                {k: v for k, v in b.items() if k != "logp"}
            if "logp" in b:
                assert abs(a["logp"] - b["logp"]) <= LOGP_TOL


# ------------------------------------------------------------ binary, stats

def test_binary_format_round_trip_matches_reference():
    feats = _feats(3, seed=1)
    engine = types.SimpleNamespace(feature_shape=(9, 16),
                                   cfg=types.SimpleNamespace(data=types.SimpleNamespace(image_size=8)))
    imgs = np.random.RandomState(2).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    for arr, mode in ((feats, "features"), (feats.astype(np.float16), "features"),
                      (imgs, "images")):
        body = serve.encode_binary_request(arr)
        assert body == jax_serve.encode_binary_request(arr)
        got_mode, got = serve.parse_binary_request(body, engine)
        assert got_mode == mode and got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("body", [
    b"NOPE" + b"\x00" * 20, b"SGGB", b"SGGB\x07\x00\x00\x00\x01\x00\x00\x00",
    b"SGGB\x01\x09\x00\x00\x01\x00\x00\x00",
    b"SGGB\x01\x00\x00\x00\x03\x00\x00\x00" + b"\x00" * (2 * 9 * 16 * 4),
    b"SGGB\x01\x02\x00\x00\x01\x00\x00\x00" + b"\x00" * 7,
], ids=["magic", "short", "version", "kind", "truncated", "images"])
def test_binary_malformed_inputs_raise_as_reference(body):
    engine = types.SimpleNamespace(feature_shape=(9, 16),
                                   cfg=types.SimpleNamespace(data=types.SimpleNamespace(image_size=8)))
    with pytest.raises(ValueError) as want:
        jax_serve.parse_binary_request(body, engine)
    with pytest.raises(ValueError) as got:
        serve.parse_binary_request(body, engine)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_serve.encode_binary_request(np.zeros((2, 3), np.float64))
    with pytest.raises(ValueError, match="no binary kind") as got:
        serve.encode_binary_request(np.zeros((2, 3), np.float64))
    assert str(got.value) == str(want.value)


def test_serve_stats_snapshot_matches_reference():
    mine, theirs = serve.ServeStats(), jax_serve.ServeStats()
    r = np.random.RandomState(3)
    for i in range(1500):  # past the ring buffer's 1024
        fill, lat = int(r.randint(1, 9)), float(r.gamma(2.0, 0.01))
        mine.record_batch(fill, lat)
        theirs.record_batch(fill, lat)
        if i % 7 == 0:
            for s in (mine, theirs):
                s.requests += 1
                s.items += fill
                s.errors += i % 2
    for B in (1, 32):
        assert mine.snapshot(B) == theirs.snapshot(B)
    assert serve.ServeStats().snapshot(4) == jax_serve.ServeStats().snapshot(4)


# ------------------------------------------------------------ engine parity

def _generator_params(cfg, seed):
    gen, _ = make_models(cfg)
    R, F = cfg.data.regions, cfg.data.feat_dim
    p = jax.jit(gen.init)(jax.random.key(seed), jnp.zeros((2, R, F)),
                          jnp.zeros((2, cfg.model.noise_dim)), jax.random.key(seed + 1))["params"]
    return jax.tree.map(np.asarray, p)


@functools.cache
def _setup(decoder):
    """(reference cfg, reference vocab, port vocab, reference state, port
    weights) of a smoke-width generator with an EMA."""
    jvocab, pvocab = _vocab_pair(tempfile.mkdtemp(prefix="sgg_serve_vocab_"))
    cfg = _cfg(decoder, len(jvocab))
    params = _generator_params(cfg, 0)
    ema = jax.tree.map(lambda p: p * np.float32(0.9) + np.float32(0.01), params)
    weights = serve.ServeWeights(7, generator_flax_to_state_dict(params, cfg),
                                 generator_flax_to_state_dict(ema, cfg))
    state = types.SimpleNamespace(step=7, g_params=params, g_ema=ema, enc_params=None)
    return cfg, jvocab, pvocab, state, weights


@pytest.fixture(scope="module", params=["lstm", "transformer"])
def decoder_setup(request):
    return _setup(request.param)


def _engines(setup, B, rank, temperature=None, seed=3):
    cfg, jvocab, pvocab, state, weights = setup
    kw = dict(batch_size=B, num_samples=K, rank=rank, temperature=temperature, seed=seed,
              ema=True)
    ref = jax_serve.InferenceEngine(cfg, jvocab, state, **kw)
    port = serve.InferenceEngine(PortConfig.from_json(cfg.to_json()), pvocab, weights,
                                 device="cpu", **kw)
    feed_reference_draws(port, cfg, seed, K)
    assert ref.warmup() > 0 and port.warmup() > 0  # each consumes one split
    return ref, port


@pytest.mark.parametrize("rank", ["freq", "logp"])
def test_engine_graphs_match_reference(decoder_setup, rank):
    """B = 3: a padded request (n = 2), a chunked one (n = 5), the default
    temperature and the engine's own (1.3); per-row temperatures on the
    attention-LSTM (the reference's slot decoder takes a [B] temperature
    only at B = 1, below)."""
    cfg = decoder_setup[0]
    ref, port = _engines(decoder_setup, 3, rank, temperature=1.3)
    temps = np.array([0.5, 2.0, 1.0, 0.7, 1.5], np.float32)
    calls = [(_feats(2, 1), None), (_feats(5, 2), None)]
    if cfg.model.decoder == "lstm":
        calls += [(_feats(5, 3), temps), (_feats(2, 4), temps[:2])]
    for feats, t in calls:
        want_tok, want_lp = ref._sample_tokens(feats, t)
        got_tok, got_lp = port._sample_tokens(torch.from_numpy(feats), t)
        np.testing.assert_array_equal(got_tok, np.asarray(want_tok))
        if rank == "freq":
            assert got_lp is None and want_lp is None
        else:
            assert got_lp.dtype == np.float32 and got_lp.shape == (len(feats), K)
            np.testing.assert_allclose(got_lp, np.asarray(want_lp), rtol=0, atol=LOGP_TOL)
        assert_graphs_match(port.generate(feats, t), ref.generate(feats, t))


def test_engine_per_row_temperatures_transformer_at_batch_one():
    ref, port = _engines(_setup("transformer"), 1, "logp")
    feats, temps = _feats(3, 5), np.array([0.5, 2.0, 1.0], np.float32)
    assert_graphs_match(port.generate(feats, temps), ref.generate(feats, temps))


def test_engine_refusals_and_shapes(decoder_setup):
    cfg, _, pvocab, _, weights = decoder_setup
    pcfg = PortConfig.from_json(cfg.to_json())
    eng = serve.InferenceEngine(pcfg, pvocab, weights, device="cpu", batch_size=2,
                                num_samples=2)
    for bad in (np.zeros((2, 9, 17), np.float32), np.zeros((0, 9, 16), np.float32)):
        with pytest.raises(ValueError, match="expected features"):
            eng.generate(bad)
    with pytest.raises(ValueError, match="temps must be"):
        eng.generate(_feats(2), np.ones(3, np.float32))
    with pytest.raises(ValueError, match="precomputed"):
        eng.generate_from_images(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="EMA"):
        serve.InferenceEngine(pcfg, pvocab, weights._replace(g_ema=None), device="cpu",
                              ema=True)
    with pytest.raises(ValueError, match="no encoder to quantize"):
        serve.InferenceEngine(pcfg, pvocab, weights, device="cpu", quant="int8")


def test_engine_needs_cuda_or_cpu(decoder_setup, monkeypatch):
    cfg, _, pvocab, _, weights = decoder_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.InferenceEngine(PortConfig.from_json(cfg.to_json()), pvocab, weights)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.SceneGraphGenerator(PortConfig.from_json(cfg.to_json()), pvocab, weights)


# ------------------------------------------------------------ pixels in

def _resnet50_cfg(V):
    """The named ``resnet50`` config cut to 32 px (one region) and small
    decoder widths, in float32."""
    cfg = jax_get_config("resnet50")
    cfg.data.image_size = 32
    cfg.data.regions = 1
    cfg.model.compute_dtype = "float32"
    cfg.model.hidden, cfg.model.embed_dim, cfg.model.attn_dim = 32, 16, 16
    cfg.model.noise_dim = 8
    cfg.model.vocab_size = V
    return cfg


def test_pixels_in_engine_matches_reference(tmp_path):
    jvocab, pvocab = _vocab_pair(str(tmp_path))
    cfg = _resnet50_cfg(len(jvocab))
    init = jax.jit(jax_make_encoder("resnet50").init)
    p = init(jax.random.key(0), jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]
    r = np.random.RandomState(4)
    p = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            (0.5 + r.rand(*v.shape)) if path[-1].key == "bn_var"
            else (0.1 * r.randn(*v.shape)) if path[-1].key in ("bn_mean", "bn_bias")
            else v, np.float32),
        p)
    enc = {"params": p}
    g = _generator_params(cfg, 1)
    state = types.SimpleNamespace(step=2, g_params=g, g_ema=None, enc_params=enc)
    weights = serve.ServeWeights(2, generator_flax_to_state_dict(g, cfg), None,
                                 encoder_flax_to_state_dict(enc))
    kw = dict(batch_size=2, num_samples=3, rank="logp", seed=4)
    ref = jax_serve.InferenceEngine(cfg, jvocab, state, **kw)
    port = serve.InferenceEngine(PortConfig.from_json(cfg.to_json()), pvocab, weights,
                                 device="cpu", **kw)
    feed_reference_draws(port, cfg, 4, 3)
    ref.warmup()
    port.warmup()
    imgs = np.random.RandomState(6).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(ref.encode_images(imgs))
    got = port.encode_images(imgs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 1, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert_graphs_match(port.generate_from_images(imgs), ref.generate_from_images(imgs))
    for bad in (imgs[:, :16], imgs[:0]):
        with pytest.raises(ValueError, match="expected images"):
            port.generate_from_images(bad)


# ------------------------------------------------------------ batcher

class StubEngine:
    """Answers each row with its own input: row i's graph names the value at
    feats[i, 0, 0] and the temperature the row was sampled at."""

    batch_size = 3
    feature_shape = (2, 2)
    _default_temp = 1.0
    supports_request_temperature = True

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail
        self._lock = threading.Lock()

    def generate(self, feats, temps=None):
        with self._lock:
            self.calls.append((len(feats), None if temps is None else list(temps)))
        if self.fail:
            raise RuntimeError("engine failed")
        t = [None] * len(feats) if temps is None else [float(x) for x in temps]
        return [{"row": float(f[0, 0]), "temp": tt} for f, tt in zip(feats, t)]


def _items(values):
    return np.asarray(values, np.float32)[:, None, None] * np.ones((1, 2, 2), np.float32)


def _concurrent(batcher, requests):
    """Submit each (feats, temperature) from its own thread; → results."""
    results = [None] * len(requests)

    def call(i):
        f, t = requests[i]
        try:
            results[i] = batcher.submit(f, timeout=TIMEOUT, temperature=t)
        except Exception as e:  # noqa: BLE001 — the test reads it
            results[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIMEOUT)
        assert not th.is_alive()
    return results


@pytest.mark.parametrize("package", [serve, jax_serve], ids=["port", "reference"])
def test_batcher_routes_rows_coalesces_and_closes(package):
    eng = StubEngine()
    stats = package.ServeStats()
    b = package.DynamicBatcher(eng, max_wait_ms=200.0, stats=stats)
    try:
        reqs = [(_items([i]), t) for i, t in enumerate([0.3, None, 2.0, None])]
        res = _concurrent(b, reqs)
        for i, (r, t) in enumerate(zip(res, [0.3, None, 2.0, None])):
            assert r[0]["row"] == float(i)  # each row's own answer
            # A row with no temperature gets the default in a mixed batch.
            assert r[0]["temp"] in ((None, 1.0) if t is None else (float(np.float32(t)),))
        assert len(eng.calls) <= 3
        # Different temperatures share one dispatch, as a per-row vector.
        assert any(n > 1 and t is not None and len(set(t)) > 1 for n, t in eng.calls)
        eng.calls.clear()
        assert b.submit(_items(range(10, 17)), timeout=TIMEOUT) == \
            [{"row": float(v), "temp": None} for v in range(10, 17)]  # spans batches
        assert len(eng.calls) >= 3 and max(n for n, _ in eng.calls) <= 3
        snap = stats.snapshot(3)
        assert snap["requests"] == 5 and snap["items"] == 11 and snap["errors"] == 0
        with pytest.raises(ValueError, match="temperature must be > 0"):
            b.submit(_items([1]), temperature=-1.0)
        with pytest.raises(ValueError, match="expected features"):
            b.submit(np.zeros((1, 2, 3), np.float32))
    finally:
        b.close()
    assert not b._worker.is_alive()


@pytest.mark.parametrize("package", [serve, jax_serve], ids=["port", "reference"])
def test_batcher_engine_error_reaches_every_future(package):
    eng = StubEngine(fail=True)
    b = package.DynamicBatcher(eng, max_wait_ms=100.0)
    try:
        res = _concurrent(b, [(_items([i, i + 1]), None) for i in range(3)])
        assert all(isinstance(r, RuntimeError) and "engine failed" in str(r) for r in res)
        assert b.stats.snapshot(3)["errors"] == len(eng.calls) >= 2
    finally:
        b.close()
    assert not b._worker.is_alive()


# ------------------------------------------------------------ HTTP

class Served:
    """A batcher and an HTTP server on 127.0.0.1 in a daemon thread; close()
    stops all three."""

    def __init__(self, package, engine, **kw):
        self.batcher = package.DynamicBatcher(engine, max_wait_ms=1.0,
                                              stats=kw.pop("stats", None))
        try:
            self.server = package.make_http_server(self.batcher, host="127.0.0.1", port=0,
                                                   **kw)
        except BaseException:
            self.batcher.close()
            raise
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive() and not self.batcher._worker.is_alive()


def _request(url, data=None, ctype="application/json"):
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            body = r.read()
            status, headers = r.status, r.headers
    except urllib.error.HTTPError as e:
        body, status, headers = e.read(), e.code, e.headers
    if headers["Content-Type"] == "application/json":
        body = json.loads(body)
    return status, body


def _post(url, payload):
    return _request(url + "/v1/generate", json.dumps(payload).encode())


def _post_bin(url, arr):
    return _request(url + "/v1/generate", serve.encode_binary_request(arr),
                    "application/octet-stream")


@pytest.fixture(scope="module")
def http_engine():
    """An lstm smoke engine (rank logp, B 4, K 4) whose every dispatch takes
    the same draws, so equal features give equal graphs."""
    cfg, _, pvocab, _, weights = _setup("lstm")
    eng = serve.InferenceEngine(PortConfig.from_json(cfg.to_json()), pvocab,
                                weights._replace(step=5), device="cpu", batch_size=4,
                                num_samples=K, rank="logp")
    noise = _reference_noise(cfg, jax.random.key(9), 4, K)
    inner = eng._sampler
    eng._sampler = lambda g, f, generator=None, temp=None: inner(g, f, noise=noise, temp=temp)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def http_server(http_engine):
    s = Served(serve, http_engine)
    try:
        yield s.url
    finally:
        s.close()


def test_http_healthz_generate_and_stats(http_server, http_engine):
    status, body = _request(http_server + "/healthz")
    assert status == 200 and body == {"ok": True, "step": 5, "encoder": "precomputed",
                                      "vocab_size": len(http_engine.vocab), "num_samples": K}
    _, before = _request(http_server + "/stats")
    status, body = _post(http_server, {"features": _feats(3, 3).tolist()})
    assert status == 200 and len(body["scene_graphs"]) == 3 and body["latency_ms"] > 0
    for g in body["scene_graphs"]:
        assert sum(t["count"] for t in g["triples"]) == K
        lps = [t["logp"] for t in g["triples"]]
        assert lps == sorted(lps, reverse=True)
    status, body = _post(http_server, {"features": _feats(2, 8).tolist(), "temperature": 0.5})
    assert status == 200 and len(body["scene_graphs"]) == 2
    status, stats = _request(http_server + "/stats")
    assert status == 200
    assert stats["items"] - before["items"] == 5 and stats["requests"] - before["requests"] == 2
    assert stats["batch_size"] == 4 and stats["errors"] == 0


def test_http_metrics_text_matches_reference():
    """The same counters → the same /metrics text from both servers."""
    texts = []
    for package in (serve, jax_serve):
        stats = package.ServeStats()
        for fill, lat in ((3, 0.012), (1, 0.004), (3, 0.020)):
            stats.record_batch(fill, lat)
        stats.requests, stats.items, stats.errors = 4, 7, 1
        eng = StubEngine()
        eng.step, eng.cfg, eng.vocab, eng.num_samples = 0, None, [], 1
        s = Served(package, eng, stats=stats)
        try:
            status, text = _request(s.url + "/metrics")
            _, js = _request(s.url + "/stats")
        finally:
            s.close()
        assert status == 200 and isinstance(text, bytes)
        texts.append(text.decode())
        line = [ln for ln in texts[-1].splitlines() if ln.startswith("sgg_items_total")][0]
        assert int(line.split()[1]) == js["items"] == 7
    assert texts[0] == texts[1]
    assert 'sgg_batch_latency_ms{quantile="0.95"} 20.0' in texts[0]


def test_http_binary_equals_json(http_server):
    feats = _feats(3, 11)
    _, want = _post(http_server, {"features": feats.tolist()})
    status, got = _post_bin(http_server, feats)
    assert status == 200 and got["scene_graphs"] == want["scene_graphs"]
    f16 = feats.astype(np.float16)
    _, want = _post(http_server, {"features": f16.astype(np.float32).tolist()})
    status, got = _post_bin(http_server, f16)
    assert status == 200 and got["scene_graphs"] == want["scene_graphs"]


def test_http_bad_requests(http_server):
    assert _post(http_server, {"nope": 1}) == \
        (400, {"error": "need 'features', 'images' or 'paths'"})
    status, body = _post(http_server, {"features": [[[1.0, 2.0]]]})
    assert status == 400 and "expected features" in body["error"]
    status, body = _post(http_server, {"paths": ["a.jpg"]})
    assert status == 400 and "precomputed features" in body["error"]
    status, body = _request(http_server + "/v1/generate", b"{not json")
    assert status == 400
    status, body = _request(http_server + "/v1/generate", b"NOPE" + b"\x00" * 20,
                            "application/octet-stream")
    assert status == 400 and "magic" in body["error"]
    assert _request(http_server + "/unknown")[0] == 404
    assert _request(http_server + "/unknown", b"{}")[0] == 404


def test_http_images_route_refused_on_precomputed_config(http_server):
    status, body = _post(http_server, {"images": np.zeros((1, 8, 8, 3), np.uint8).tolist()})
    assert status == 400 and "precomputed" in body["error"]
    status, body = _post_bin(http_server, np.zeros((1, 224, 224, 3), np.uint8))
    assert status == 400 and "precomputed" in body["error"]


def test_http_body_size_cap(http_engine):
    s = Served(serve, http_engine, max_body_bytes=1024)
    try:
        status, body = _post(s.url, {"features": _feats(2).tolist()})
        assert status == 413 and "cap" in body["error"]
        status, body = _post_bin(s.url, _feats(1).astype(np.float16))  # 300 bytes
        assert status == 200 and len(body["scene_graphs"]) == 1
    finally:
        s.close()


# ------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def serve_workdir(tmp_path_factory):
    """A port training workdir (smoke widths, EMA tracked) with checkpoints
    at steps 10 and 11."""
    wd = str(tmp_path_factory.mktemp("serve_wd"))
    _, vocab = _vocab_pair(wd)
    cfg = PortConfig.from_json(_cfg("lstm", len(vocab)).to_json())
    cfg.train.ema_decay = 0.9
    state = create_train_state(cfg, 3)
    mgr = CheckpointManager(wd, cfg)
    for step in (10, 11):
        state.step = step
        mgr.save(state)
    return wd


@pytest.mark.parametrize("argv,message", [
    ([], "exactly one of --workdir / --artifact"),
    (["--workdir", "WD", "--artifact", "m.sgx"], "exactly one of --workdir / --artifact"),
    (["--artifact", "m.sgx", "--rank", "logp"], "--rank freq_logp/logp needs --workdir"),
    (["--artifact", "m.sgx", "--dp", "2"], "--dp needs --workdir"),
    (["--workdir", "WD", "--quant", "int8"], "no encoder to quantize"),
], ids=["neither", "both", "artifact", "dp", "quant"])
def test_serve_cli_refusals(serve_workdir, capsys, argv, message):
    """Exit code 2: one of --workdir/--artifact; an artifact bakes its
    sampling, weights and quantization (also --top-k, --ema and --quant with
    --artifact); --dp needs a workdir (an artifact is one device's program;
    tests/test_torch_dist.py holds --dp itself); a precomputed workdir has no
    encoder to quantize."""
    argv = [serve_workdir if a == "WD" else a for a in argv]
    assert serve_cli.main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert message in err
    if argv[:1] == ["--artifact"]:
        for extra in (["--top-k", "5"], ["--ema"], ["--avg-last", "3"], ["--quant", "int8"]):
            assert serve_cli.main(["--artifact", "m.sgx", *extra, "--device", "cpu"]) == 2
        assert "--quant needs --workdir" in capsys.readouterr().err


def test_serve_cli_needs_cuda_or_cpu_flag(serve_workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_cli.main(["--workdir", serve_workdir])


def test_serve_cli_subprocess_answers_and_exits_on_sigterm(serve_workdir, tmp_path):
    log_path = str(tmp_path / "serve.log")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sgg_torch.cli.serve", "--workdir", serve_workdir,
             "--ema", "--avg-last", "5", "--port", "0", "--device", "cpu",
             "--batch-size", "2", "--num-samples", "3"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        deadline, url = time.monotonic() + 120, None
        while url is None and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.1)
            with open(log_path) as f:
                ready = [ln for ln in f if "ready on http://" in ln]
            if ready:
                url = ready[0].split("ready on ")[1].split()[0]
        assert url is not None, open(log_path).read()
        status, body = _request(url + "/healthz")
        assert status == 200 and body["ok"] and body["step"] == 11
        status, body = _post_bin(url, _feats(3).astype(np.float16))
        assert status == 200 and len(body["scene_graphs"]) == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        with open(log_path) as f:
            assert "draining and shutting down" in f.read()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)


# ------------------------------------------------------------ api

@pytest.mark.parametrize("decoder,rank", [("lstm", "freq"), ("transformer", "logp")])
def test_scene_graph_generator_matches_reference(decoder, rank):
    cfg, jvocab, pvocab, state, weights = _setup(decoder)
    ref = jax_api.SceneGraphGenerator(cfg, jvocab, state, num_samples=K, seed=2,
                                      temperature=1.2, rank=rank)
    port = api.SceneGraphGenerator(PortConfig.from_json(cfg.to_json()), pvocab, weights,
                                   num_samples=K, seed=2, temperature=1.2, rank=rank,
                                   device="cpu")
    feed_reference_draws(port, cfg, 2, K)
    for feats, t in ((_feats(3, 1), None), (_feats(2, 2), 0.6)):
        assert port.generate_from_features(feats, t) == ref.generate_from_features(feats, t)
    with pytest.raises(ValueError, match="precomputed"):
        port.generate_from_images(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="precomputed"):
        port.generate_from_paths(["a.jpg"])


def test_scene_graph_generator_from_workdir(serve_workdir):
    g = api.SceneGraphGenerator.from_workdir(serve_workdir, num_samples=3, rank="logp",
                                             device="cpu")
    assert g.step == 11
    graphs = g.generate_from_features(_feats(2))
    assert len(graphs) == 2 and all(1 <= len(x["triples"]) <= 3 for x in graphs)
    with pytest.raises(FileNotFoundError):
        api.SceneGraphGenerator.from_workdir(os.path.dirname(serve_workdir), device="cpu")


FIXTURE_JPEGS = [os.path.join(REPO, "tests", "fixtures_torch", "vg_jpeg", "images",
                              f"{1000 + i}.jpg") for i in range(3)]


def test_paths_requests_equal_images_requests(tmp_path):
    """A pixels-in engine (resnet50 at 32 px) whose every dispatch takes the
    same draws: a ``paths`` request over HTTP and
    ``SceneGraphGenerator.generate_from_paths`` give the graphs of an
    ``images`` request of the same JPEGs decoded by ``load_batch``; a missing
    file is a 400."""
    from sgg_torch.data.extract import load_batch
    from sgg_torch.models.encoders import make_encoder

    _, pvocab = _vocab_pair(str(tmp_path))
    jcfg = _resnet50_cfg(len(pvocab))
    cfg = PortConfig.from_json(jcfg.to_json())
    torch.manual_seed(0)
    enc = make_encoder("resnet50").state_dict()
    weights = serve.ServeWeights(
        2, generator_flax_to_state_dict(_generator_params(jcfg, 1), jcfg), None, enc)
    noise = _reference_noise(jcfg, jax.random.key(5), 4, K)
    eng = serve.InferenceEngine(cfg, pvocab, weights, device="cpu", batch_size=4,
                                num_samples=K, rank="logp")
    inner = eng._sampler
    eng._sampler = lambda g, f, generator=None, temp=None: inner(g, f, noise=noise, temp=temp)
    imgs = load_batch(FIXTURE_JPEGS, 32)
    want = eng.generate_from_images(imgs)
    assert len(want) == 3 and all(g_["triples"] for g_ in want)
    s = Served(serve, eng)
    try:
        status, body = _post(s.url, {"paths": FIXTURE_JPEGS})
        assert status == 200 and body["scene_graphs"] == want
        status, body = _post(s.url, {"images": imgs.tolist()})
        assert status == 200 and body["scene_graphs"] == want
        status, body = _post(s.url, {"paths": [FIXTURE_JPEGS[0], str(tmp_path / "no.jpg")]})
        assert status == 400 and "no.jpg" in body["error"]
    finally:
        s.close()
    gen = api.SceneGraphGenerator(cfg, pvocab, weights, num_samples=K, rank="logp",
                                  device="cpu")
    inner_g = gen._sampler
    noise3 = _reference_noise(jcfg, jax.random.key(6), 3, K)
    gen._sampler = lambda g, f, generator=None, temp=None: inner_g(g, f, noise=noise3,
                                                                  temp=temp)
    assert gen.generate_from_paths(FIXTURE_JPEGS) == gen.generate_from_images(imgs)
