"""Inference serving tier: a dynamic-batching scene-graph server, from
``sgg/serve.py``.

The engine serves a trained port workdir at a fixed ``batch_size``: requests
are padded with zero rows up to it (a short chunk's temperature vector with
the default temperature), or cut into chunks of it, so every dispatch has one
shape and the noise of a row does not depend on how a request was split.
``warmup`` drives one padded batch through every kernel and the sampler
before the server accepts traffic. The batcher coalesces concurrent feature
requests into one dispatch (up to ``batch_size`` images, or ``max_wait_ms``
after the first queued one). The front end is the stdlib's
``ThreadingHTTPServer``.

Endpoints (JSON over HTTP):
  POST /v1/generate   {"features": [[[...]]]}  → {"scene_graphs": [...]}
                      or {"images": [[[[u8]]]]} or {"paths": ["a.jpg", ...]}
                      (JPEGs the server reads, decoded by the native loader at
                      ``data.image_size``) on pixels-in configs.
  GET  /healthz       {"ok": true, "step": N, ...}
  GET  /stats         batching and latency counters (JSON).
  GET  /metrics       the same counters in Prometheus text exposition.

Binary requests (``Content-Type: application/octet-stream``): a 12-byte
header (magic ``SGGB``, version u8, kind u8: 0 = float32 features, 1 =
float16 features, 2 = uint8 images, 2 pad bytes, count u32 LE), then the raw
C-order little-endian array; shapes are implied by the engine's config.
``encode_binary_request`` is the client's packer. Responses are JSON.

Threads: the batcher's worker and the server's handler threads call the
engine. One engine lock covers every dispatch to the device (the noise draw,
the sampler and the encoder), so the kernels' first build, their launch
plans and counters and the sampler's lazy weight load are never entered by
two threads at once. The engine runs on CUDA unless it is given
``device='cpu'``.

Two engines: :class:`InferenceEngine` over a trained workdir (``quant='int8'``
serves the encoder's int8 PTQ), and :class:`ArtifactEngine` over an exported
sampler (``sgg_torch.export``), which needs no workdir and no model code and
launches none of the hand-written kernels. ``InferenceEngine(mesh=...)``
serves data parallel: each batch's rows over a single-process mesh's devices
(``serve --dp N``).

Usage: ``python -m sgg_torch.cli.serve --workdir W --port 8500`` (or
``--artifact model.pt2``).
"""

from __future__ import annotations

import json
import queue
import struct
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple

import numpy as np
import torch

from sgg_torch.cli.common import resolve_device
from sgg_torch.config import Config
from sgg_torch.data.extract import load_batch
from sgg_torch.data.vocab import Vocab
from sgg_torch.eval.sampler import assemble_scene_graphs, make_dp_sampler, make_sampler
from sgg_torch.models.encoders import make_image_encoder
from sgg_torch.train.checkpoint import load_workdir, restore_weights

BINARY_MAGIC = b"SGGB"
BINARY_VERSION = 1
# kind byte → (request mode, wire dtype)
_BINARY_KINDS = {
    0: ("features", np.float32),
    1: ("features", np.float16),
    2: ("images", np.uint8),
}


def encode_binary_request(arr: np.ndarray) -> bytes:
    """Client-side packer for the octet-stream request format.

    float32/float16 [n,R,F] feature blocks and uint8 [n,S,S,3] image blocks
    are accepted; the kind byte is inferred from dtype+rank. The server
    validates the trailing dims against its own config (the header carries
    only the count — fixed 12 bytes, no shape negotiation).
    """
    arr = np.ascontiguousarray(arr)
    for kind, (mode, dtype) in _BINARY_KINDS.items():
        ndim = 3 if mode == "features" else 4
        if arr.dtype == dtype and arr.ndim == ndim:
            header = (BINARY_MAGIC + bytes([BINARY_VERSION, kind, 0, 0])
                      + struct.pack("<I", arr.shape[0]))
            return header + arr.tobytes()
    raise ValueError(
        f"no binary kind for dtype={arr.dtype} ndim={arr.ndim}; supported: "
        "float32/float16 [n,R,F] features, uint8 [n,S,S,3] images"
    )


def parse_binary_request(body: bytes, engine) -> tuple[str, np.ndarray]:
    """Server-side parse: bytes → ('features'|'images', array). Zero-copy
    (``np.frombuffer`` over the request body). Raises ValueError on any
    malformed input — the HTTP handler maps that to a 400."""
    if len(body) < 12 or body[:4] != BINARY_MAGIC:
        raise ValueError("bad binary request: missing SGGB magic")
    version, kind = body[4], body[5]
    if version != BINARY_VERSION:
        raise ValueError(f"unsupported binary version {version}")
    if kind not in _BINARY_KINDS:
        raise ValueError(f"unknown binary kind {kind}")
    mode, dtype = _BINARY_KINDS[kind]
    (n,) = struct.unpack("<I", body[8:12])
    if mode == "features":
        r, f = engine.feature_shape
        shape = (n, r, f)
    else:
        s = engine.cfg.data.image_size
        shape = (n, s, s, 3)
    expect = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if len(body) - 12 != expect:
        raise ValueError(
            f"binary payload is {len(body) - 12} bytes; {mode} x{n} at the "
            f"server's shape {shape[1:]} needs {expect}"
        )
    return mode, np.frombuffer(body, dtype, offset=12).reshape(shape)


@dataclass
class ServeStats:
    """Cheap counters + a latency ring buffer (lock-guarded)."""

    requests: int = 0
    items: int = 0
    batches: int = 0
    batch_fill_sum: int = 0
    errors: int = 0
    _lat_ms: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record_batch(self, fill: int, latency_s: float) -> None:
        with self._lock:
            self.batches += 1
            self.batch_fill_sum += fill
            self._lat_ms.append(latency_s * 1e3)
            if len(self._lat_ms) > 1024:  # ring buffer, O(1) memory
                self._lat_ms = self._lat_ms[-512:]

    def snapshot(self, batch_size: int) -> dict:
        with self._lock:
            lats = sorted(self._lat_ms)
            pct = lambda p: (  # noqa: E731 — tiny local helper
                lats[min(len(lats) - 1, int(p * len(lats)))] if lats else 0.0
            )
            return {
                "requests": self.requests,
                "items": self.items,
                "batches": self.batches,
                "errors": self.errors,
                "avg_batch_fill": (
                    self.batch_fill_sum / self.batches if self.batches else 0.0
                ),
                "batch_size": batch_size,
                "batch_latency_ms": {
                    "p50": round(pct(0.50), 2),
                    "p95": round(pct(0.95), 2),
                    "p99": round(pct(0.99), 2),
                },
            }


class ServeWeights(NamedTuple):
    """What an engine serves from a workdir: the step, the generator's
    state_dict and its EMA (or None), and the encoder's (None for
    precomputed features)."""

    step: int
    g_params: dict
    g_ema: dict | None = None
    enc_params: dict | None = None


def read_workdir_weights(workdir: str, avg_last: int = 0):
    """(cfg, vocab, ServeWeights) of a port workdir: ``generator.pt``, or
    with ``avg_last`` > 1 the generator's (and its EMA's) mean over the last
    N retained checkpoints. Raises FileNotFoundError without weights."""
    cfg, vocab = load_workdir(workdir)
    cfg.model.vocab_size = len(vocab)
    restored = restore_weights(workdir, cfg, avg_last, torch.device("cpu"))
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {workdir}")
    step, g_params, g_ema, enc_params, _ = restored
    return cfg, vocab, ServeWeights(int(step), g_params, g_ema, enc_params)


class InferenceEngine:
    """The generator-forward sampler at a fixed batch over a trained
    workdir's weights, on one device, or with ``mesh`` (a single-process
    ``sgg_torch.dist.make_mesh``) each batch's rows split over the mesh's
    devices (``make_dp_sampler``: the same tokens as one device's, given the
    same noise; the batch must divide; the encoder and the noise stay on the
    mesh's first device).

    Thread-safe: one lock covers every dispatch to the device — each chunk's
    upload, encoder and sampler (whose noise comes from the engine's
    ``torch.Generator``); the host reads the results back outside it.
    """

    def __init__(self, cfg: Config, vocab: Vocab, weights: ServeWeights, *,
                 device="cuda", batch_size: int = 32, num_samples: int = 50,
                 temperature: float | None = None, seed: int = 0,
                 quant: str | None = None, ema: bool = False, rank: str = "freq",
                 top_k: int = 0, top_p: float | None = None, mesh=None):
        if quant == "int8" and cfg.model.encoder == "precomputed":
            raise ValueError("quant 'int8' quantizes the encoder; model.encoder is "
                             "'precomputed' (no encoder to quantize)")
        if quant is not None:  # override of cfg.model.quant
            cfg.model.quant = "" if quant == "none" else quant
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.cfg = cfg
        self.vocab = vocab
        self.batch_size = int(batch_size)
        self.num_samples = int(num_samples)
        self.rank = rank
        # The default temperature; requests may override it per row, and the
        # [B] temperature vector is always passed.
        self._default_temp = 1.0 if temperature is None else float(temperature)
        self.supports_request_temperature = True
        self._with_logp = rank != "freq"
        self.step = int(weights.step)
        g_params = weights.g_params
        if ema:
            if weights.g_ema is None:
                raise ValueError(
                    "ema=True but the checkpoint has no EMA weights "
                    "(train with train.ema_decay > 0)"
                )
            g_params = weights.g_ema
        # On the device once; the sampler loads this same dict once.
        self._g_params = {k: v.to(self.device) for k, v in g_params.items()}
        opts = dict(step_mask=vocab.step_mask(), num_samples=self.num_samples, tau=temperature,
                    with_logp=self._with_logp, top_k=top_k, top_p=top_p)
        if mesh is not None:
            if self.batch_size % mesh.data:
                raise ValueError(f"batch_size {self.batch_size} not divisible by the mesh's "
                                 f"data axis ({mesh.data})")
            self._sampler = make_dp_sampler(cfg, mesh, **opts)
        else:
            self._sampler = make_sampler(cfg, **opts)
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._lock = threading.Lock()
        self._encode = None
        if cfg.model.encoder != "precomputed":
            if weights.enc_params is None:
                raise ValueError(f"encoder {cfg.model.encoder!r}: the checkpoint has no "
                                 "encoder weights (enc_params)")
            self._encode = make_image_encoder(cfg, weights.enc_params, self.device)

    @classmethod
    def from_workdir(cls, workdir: str, avg_last: int = 0, **kw) -> "InferenceEngine":
        """``avg_last`` > 1 serves the mean of the last N retained
        checkpoints' generator weights (with ``ema=True``, of their EMA)."""
        cfg, vocab, weights = read_workdir_weights(workdir, avg_last)
        return cls(cfg, vocab, weights, **kw)

    @property
    def feature_shape(self) -> tuple[int, int]:
        return (self.cfg.data.regions, self.cfg.data.feat_dim)

    def warmup(self) -> float:
        """Drive one padded batch through the encoder and the sampler (the
        kernels' build and first launch included); returns wall seconds."""
        t0 = time.perf_counter()
        if self._encode is not None:
            s = self.cfg.data.image_size
            self.encode_images(np.zeros((self.batch_size, s, s, 3), np.uint8))
        r, f = self.feature_shape
        self._sample_tokens(torch.zeros(self.batch_size, r, f))
        return time.perf_counter() - t0

    # ------------------------------------------------------------- internals
    def _sample_tokens(
        self, feats: torch.Tensor, temps: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """[n,R,F] (+ optional float[n] per-row temperatures) →
        (int32[n,K,3], float32[n,K] logp | None), in chunks of the batch,
        the last padded with zero rows and the default temperature."""
        n = feats.shape[0]
        B = self.batch_size
        if temps is None:
            temps = np.full(n, self._default_temp, np.float32)
        else:
            temps = np.asarray(temps, np.float32)
            if temps.shape != (n,):
                raise ValueError(f"temps must be float[{n}], got {temps.shape}")
        dtype = self.cfg.model.dtype
        out, out_lp = [], []
        for lo in range(0, n, B):
            tvec = temps[lo:lo + B]
            pad = B - len(tvec)
            if pad:
                tvec = np.concatenate([tvec, np.full(pad, self._default_temp, np.float32)])
            with self._lock:
                chunk = feats[lo:lo + B].to(self.device, dtype)
                if pad:
                    chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
                res = self._sampler(self._g_params, chunk, self._generator,
                                    temp=torch.from_numpy(tvec).to(self.device))
            # The read-back (the sync) runs outside the lock.
            if self._with_logp:
                tokens, lp = (x.cpu().numpy() for x in res)
                out_lp.append(lp[: B - pad])
            else:
                tokens = res.cpu().numpy()
            out.append(tokens[: B - pad])
        tokens = np.concatenate(out) if len(out) > 1 else out[0]
        if not self._with_logp:
            return tokens, None
        return tokens, np.concatenate(out_lp) if len(out_lp) > 1 else out_lp[0]

    def encode_images(self, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 [n,S,S,3] → features [n,R,F] in the compute dtype on the
        engine's device, in chunks of the batch, the last padded with zero
        images."""
        if self._encode is None:
            raise ValueError(
                "this run used precomputed features; POST 'features' instead"
            )
        s = self.cfg.data.image_size
        if images_u8.ndim != 4 or images_u8.shape[1:] != (s, s, 3) or not len(images_u8):
            raise ValueError(f"expected images [n, {s}, {s}, 3], got {images_u8.shape}")
        n = images_u8.shape[0]
        B = self.batch_size
        out = []
        for lo in range(0, n, B):
            chunk = torch.from_numpy(np.array(images_u8[lo:lo + B]))  # writable copy
            pad = B - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
            with self._lock:
                out.append(self._encode(chunk.to(self.device))[: B - pad])
        return torch.cat(out) if len(out) > 1 else out[0]

    # ------------------------------------------------------------- public
    def generate(self, feats, temps: np.ndarray | None = None) -> list[dict]:
        """[n,R,F] features (a float array, or a tensor as ``encode_images``
        gives) → n scene-graph dicts (triples in ``rank`` order). ``temps``
        float[n]: optional per-row sampling temperatures (None = the engine
        default)."""
        if not isinstance(feats, torch.Tensor):
            feats = torch.from_numpy(np.array(feats, np.float32))  # writable copy
        if feats.ndim != 3 or tuple(feats.shape[1:]) != self.feature_shape or not len(feats):
            raise ValueError(
                f"expected features [n, {self.feature_shape[0]}, "
                f"{self.feature_shape[1]}], got {tuple(feats.shape)}"
            )
        tokens, logp = self._sample_tokens(feats, temps)
        graphs, _ = assemble_scene_graphs(
            tokens, self.vocab, np.arange(len(tokens)),
            logp=logp, rank=self.rank,
        )
        for g in graphs:
            g.pop("image_id", None)
        return graphs

    def generate_from_images(self, images_u8: np.ndarray,
                             temps: np.ndarray | None = None) -> list[dict]:
        return self.generate(
            self.encode_images(np.asarray(images_u8, np.uint8)), temps
        )

    def decode_paths(self, paths) -> np.ndarray:
        """JPEG paths → uint8 [n, S, S, 3] at ``data.image_size`` (the native
        loader); a precomputed-feature engine refuses them."""
        if self._encode is None:
            raise ValueError("this run used precomputed features; POST 'features' instead")
        if isinstance(paths, str) or not len(paths):
            raise ValueError("'paths' must be a non-empty list of image paths")
        return load_batch([str(p) for p in paths], self.cfg.data.image_size)


class ArtifactEngine:
    """An engine over an exported sampler (``sgg_torch.export``), from
    ``sgg/serve.py:385-510``: the file alone, with no workdir, checkpoint or
    model code. Batch size, draws, temperature and, for a pixels-in
    artifact, the whole encoder are in the program. A features-in artifact
    serves ``features`` requests, a pixels-in one ``images`` and ``paths``;
    each refuses the other (a 400 over HTTP), and per-request temperatures
    too. Requests are padded or cut to one batch (the artifact's, or for a
    symbolic-batch artifact ``batch_size``); one lock covers each dispatch,
    whose noise comes from a ``torch.Generator`` seeded by ``seed`` in the
    order ``make_sampler`` draws."""

    def __init__(self, path: str, *, device="cuda", seed: int = 0,
                 batch_size: int | None = None):
        from sgg_torch.config import get_config
        from sgg_torch.export import artifact_noise, load_artifact

        self.device = resolve_device(device)
        self._call, meta = load_artifact(path, self.device)
        self._noise = artifact_noise
        self.meta = meta
        self.vocab = Vocab(tokens=list(meta["vocab_tokens"]),
                           is_object=list(meta["vocab_is_object"]),
                           is_predicate=list(meta["vocab_is_predicate"]))
        cfg = get_config("smoke")
        cfg.model.vocab_size = len(self.vocab)
        cfg.model.encoder = meta.get("encoder") or "precomputed"
        cfg.model.compute_dtype = meta["feats_dtype"]
        cfg.data.regions = meta["regions"]
        cfg.data.feat_dim = meta["feat_dim"]
        cfg.data.image_size = meta.get("image_size") or 224
        self.cfg = cfg
        self.batch_size = int(meta["batch_size"]) or int(batch_size or 32)
        self.num_samples = int(meta["num_samples"])
        self.step = int(meta.get("step", -1))
        self._images_in = meta["input"] == "images"
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._lock = threading.Lock()
        # The temperature is in the program; per-request overrides cannot be.
        self.supports_request_temperature = False
        self._default_temp = float(meta["temperature"])

    @property
    def feature_shape(self) -> tuple[int, int]:
        return (self.cfg.data.regions, self.cfg.data.feat_dim)

    def warmup(self) -> float:
        """One padded batch through the program; returns wall seconds."""
        t0 = time.perf_counter()
        if self._images_in:
            s = self.cfg.data.image_size
            x = np.zeros((self.batch_size, s, s, 3), np.uint8)
        else:
            x = np.zeros((self.batch_size, *self.feature_shape), np.float32)
        self._dispatch(x)
        return time.perf_counter() - t0

    def _dispatch(self, x: np.ndarray) -> np.ndarray:
        """tokens int32 [n, K, 3], in chunks of the batch, the last padded
        with zero rows."""
        B = self.batch_size
        dtype = torch.uint8 if self._images_in else self.cfg.model.dtype
        out = []
        for lo in range(0, x.shape[0], B):
            chunk = torch.from_numpy(np.array(x[lo:lo + B]))  # writable copy
            pad = B - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
            with self._lock:
                z, gumbel = self._noise(self.meta, B, self._generator, self.device)
                tokens = self._call(chunk.to(self.device, dtype), z, gumbel)
            out.append(tokens.cpu().numpy()[: B - pad])
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _graphs(self, tokens: np.ndarray) -> list[dict]:
        graphs, _ = assemble_scene_graphs(tokens, self.vocab, np.arange(len(tokens)))
        for g in graphs:
            g.pop("image_id", None)
        return graphs

    @staticmethod
    def _no_temps(temps) -> None:
        if temps is not None:
            raise ValueError("this artifact bakes its sampling temperature at export time; "
                             "per-request 'temperature' is not supported")

    def generate(self, feats, temps: np.ndarray | None = None) -> list[dict]:
        self._no_temps(temps)
        if self._images_in:
            raise ValueError("this artifact takes images (pixels-in export); POST 'images' "
                             "or 'paths' instead of 'features'")
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 3 or feats.shape[1:] != self.feature_shape or not len(feats):
            raise ValueError(f"expected features [n, {self.feature_shape[0]}, "
                             f"{self.feature_shape[1]}], got {feats.shape}")
        return self._graphs(self._dispatch(feats))

    def generate_from_images(self, images_u8: np.ndarray,
                             temps: np.ndarray | None = None) -> list[dict]:
        self._no_temps(temps)
        if not self._images_in:
            raise ValueError("this artifact takes precomputed features; POST 'features'")
        imgs = np.asarray(images_u8, np.uint8)
        s = self.cfg.data.image_size
        if imgs.ndim != 4 or imgs.shape[1:] != (s, s, 3) or not len(imgs):
            raise ValueError(f"expected images [n, {s}, {s}, 3], got {imgs.shape}")
        return self._graphs(self._dispatch(imgs))

    def decode_paths(self, paths) -> np.ndarray:
        """JPEG paths → uint8 [n, S, S, 3] (the native loader); a features-in
        artifact refuses them."""
        if not self._images_in:
            raise ValueError("this artifact takes precomputed features; POST 'features'")
        if isinstance(paths, str) or not len(paths):
            raise ValueError("'paths' must be a non-empty list of image paths")
        return load_batch([str(p) for p in paths], self.cfg.data.image_size)


class DynamicBatcher:
    """Coalesce concurrent requests into full device batches.

    Items (single images' features) from any number of requests are packed
    into one dispatch of up to ``engine.batch_size``; a batch launches when
    full or ``max_wait_ms`` after its first item arrived. ``close()`` stops
    the worker thread and joins it.
    """

    def __init__(self, engine: InferenceEngine, *, max_wait_ms: float = 5.0,
                 stats: ServeStats | None = None):
        self.engine = engine
        self.max_wait = max_wait_ms / 1e3
        self.stats = stats or ServeStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="sgg-batcher")
        self._worker.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker (after the batch it is on) and join it."""
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=timeout)

    def submit(self, feats: np.ndarray, timeout: float | None = 60.0,
               temperature: float | None = None) -> list[dict]:
        """Blocking: float[n,R,F] → n scene graphs (may span batches).

        ``temperature`` overrides the engine's sampling temperature for
        THIS request only; items with different temperatures still
        coalesce into one dispatch (a per-row temperature vector)."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 3 or feats.shape[1:] != self.engine.feature_shape:
            raise ValueError(
                f"expected features [n, {self.engine.feature_shape[0]}, "
                f"{self.engine.feature_shape[1]}], got {feats.shape}"
            )
        if temperature is not None:
            if not getattr(self.engine, "supports_request_temperature", False):
                raise ValueError(
                    "this engine bakes its sampling temperature; "
                    "per-request 'temperature' is not supported"
                )
            temperature = float(temperature)
            if not temperature > 0:
                raise ValueError("temperature must be > 0")
        futs = []
        for i in range(feats.shape[0]):
            f: Future = Future()
            self._q.put((feats[i], temperature, f))
            futs.append(f)
        with self.stats._lock:
            self.stats.requests += 1
            self.stats.items += len(futs)
        return [f.result(timeout=timeout) for f in futs]

    def _loop(self) -> None:
        B = self.engine.batch_size
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < B:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    break
                batch.append(item)
            feats = np.stack([b[0] for b in batch])
            temps = None
            if any(b[1] is not None for b in batch):
                temps = np.asarray(
                    [b[1] if b[1] is not None else
                     self.engine._default_temp for b in batch], np.float32,
                )
            t0 = time.perf_counter()
            try:
                graphs = self.engine.generate(feats, temps)
            except Exception as e:  # noqa: BLE001 — every waiting caller gets it
                with self.stats._lock:
                    self.stats.errors += 1
                for _, _, f in batch:
                    if not f.done():
                        f.set_exception(e)
                continue
            self.stats.record_batch(len(batch), time.perf_counter() - t0)
            for (_, _, f), g in zip(batch, graphs):
                f.set_result(g)


def make_http_server(batcher: DynamicBatcher, host: str = "127.0.0.1",
                     port: int = 8500,
                     max_body_bytes: int = 512 << 20) -> ThreadingHTTPServer:
    """Build (not start) the HTTP front end; ``.serve_forever()`` to run,
    ``.shutdown()`` and ``.server_close()`` to stop. ``port`` 0 binds a free
    port (``server.server_address[1]``).

    ``max_body_bytes`` bounds request bodies (default 512 MB); oversized
    requests get 413 without the body being read."""
    engine, stats = batcher.engine, batcher.stats

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # server_close() joins the handler threads; each ends when its
        # connection closes or idles this many seconds between requests.
        timeout = 30

        def log_message(self, *a):  # quiet: stats replace access logs
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str,
                       ctype: str = "text/plain; version=0.0.4") -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "ok": True, "step": engine.step,
                    "encoder": engine.cfg.model.encoder,
                    "vocab_size": len(engine.vocab),
                    "num_samples": engine.num_samples,
                })
            elif self.path == "/stats":
                self._send(200, stats.snapshot(engine.batch_size))
            elif self.path == "/metrics":
                self._send_text(200, prometheus_text(stats.snapshot(engine.batch_size)))
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    self._send(413, {
                        "error": f"request body {n} bytes exceeds the "
                                 f"server cap ({max_body_bytes}); split "
                                 "the request"
                    })
                    return
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/octet-stream"):
                    mode, arr = parse_binary_request(body, engine)
                    t0 = time.perf_counter()
                    if mode == "features":
                        graphs = batcher.submit(arr)
                    else:
                        graphs = engine.generate_from_images(arr)
                    self._send(200, {
                        "scene_graphs": graphs,
                        "latency_ms": round(
                            (time.perf_counter() - t0) * 1e3, 2),
                    })
                    return
                req = json.loads(body)
                temp = req.get("temperature")
                temp = None if temp is None else float(temp)
                if "features" in req:
                    feats = np.asarray(req["features"], np.float32)
                    t0 = time.perf_counter()
                    graphs = batcher.submit(feats, temperature=temp)
                elif "images" in req:
                    imgs = np.asarray(req["images"], np.uint8)
                    t0 = time.perf_counter()
                    graphs = engine.generate_from_images(
                        imgs, None if temp is None else np.full(len(imgs), temp, np.float32))
                elif "paths" in req:
                    imgs = engine.decode_paths(req["paths"])
                    t0 = time.perf_counter()
                    graphs = engine.generate_from_images(
                        imgs, None if temp is None else np.full(len(imgs), temp, np.float32))
                else:
                    self._send(400, {"error":
                                     "need 'features', 'images' or 'paths'"})
                    return
            except (ValueError, KeyError, json.JSONDecodeError, OSError) as e:
                self._send(400, {"error": str(e)})
                return
            self._send(200, {
                "scene_graphs": graphs,
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
            })

    return ThreadingHTTPServer((host, port), Handler)


def prometheus_text(s: dict) -> str:
    """A ``ServeStats.snapshot`` in Prometheus text exposition."""
    lines = [
        "# HELP sgg_requests_total HTTP generate requests.",
        "# TYPE sgg_requests_total counter",
        f"sgg_requests_total {s['requests']}",
        "# HELP sgg_items_total Images submitted for decoding.",
        "# TYPE sgg_items_total counter",
        f"sgg_items_total {s['items']}",
        "# HELP sgg_batches_total Device dispatches.",
        "# TYPE sgg_batches_total counter",
        f"sgg_batches_total {s['batches']}",
        "# HELP sgg_errors_total Failed batch dispatches.",
        "# TYPE sgg_errors_total counter",
        f"sgg_errors_total {s['errors']}",
        "# HELP sgg_batch_fill_avg Mean items per dispatch.",
        "# TYPE sgg_batch_fill_avg gauge",
        f"sgg_batch_fill_avg {s['avg_batch_fill']:.4f}",
        "# HELP sgg_batch_size Compiled device batch size.",
        "# TYPE sgg_batch_size gauge",
        f"sgg_batch_size {s['batch_size']}",
        "# HELP sgg_batch_latency_ms Device batch latency.",
        "# TYPE sgg_batch_latency_ms summary",
    ] + [
        f'sgg_batch_latency_ms{{quantile="{q}"}} {s["batch_latency_ms"][p]}'
        for q, p in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))
    ]
    return "\n".join(lines) + "\n"
