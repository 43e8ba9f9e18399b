"""In-memory (features, triples) dataset and the training iterators, from
``sgg/data/pipeline.py``.

Every iterator yields *super-batches* for the train step: ``n_critic`` critic
sub-batches and one generator sub-batch, ``{'features' | 'images':
[n_critic+1, B, ...], 'triples': int32 [n_critic+1, B, 3]}``; each row is an
image and one of its triples, chosen uniformly, or by the dataset's
predicate-balanced weights once :meth:`TripleDataset.set_predicate_balance`
has set them.
  - :func:`make_train_iterator`: numpy batches on the host from
    ``RandomState(seed + 7919·process_index)``, the reference's own draws, so
    its batches are identical to ``sgg``'s; with ``prefetch > 0`` a thread
    assembles them ahead and stops when the iterator is closed.
  - :func:`make_device_train_iterator`: the whole store lives on the device
    (optionally as int8 with a float32 scale per region,
    :func:`quantize_feature_store`) and each super-batch is one
    :func:`gather_super_batch` at draws ``(img, u)`` from a seeded
    ``torch.Generator``, so its batches differ from the reference's, whose
    draws are ``jax.random``'s; given the reference's draws the gather
    returns the reference's batch.
  - :class:`RotatingDeviceIterator`: a store larger than the device budget,
    split into the reference's equal subsets; training gathers from the
    resident subset while a thread uploads the next, and the iterator swaps
    once it is ready and the subset has served ``min_steps_per_subset``
    steps.
  - :func:`make_fused_device_stepper`: the device-resident store, N
    sample-and-step iterations per call, on the card N replays of one
    captured CUDA graph (``train.steps_per_dispatch``).
The grain loader, with its checkpointed state, is
``sgg_torch.data.grain_pipeline``.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from sgg_torch.data.shards import read_feature_shard


def sample_indices(triples: list, rng: np.random.RandomState, indices: np.ndarray,
                   batch_size: int, weights: list | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(image indices, one triple of each) for ``batch_size`` images drawn
    from ``indices``, the reference's ``sample_batch`` draws: the triple
    uniformly, or by ``weights[i]`` (``rng.choice``) when given."""
    img = indices[rng.randint(len(indices), size=batch_size)]
    if weights is None:
        pick = [triples[i][rng.randint(triples[i].shape[0])] for i in img]
    else:
        pick = [triples[i][rng.choice(triples[i].shape[0], p=weights[i])] for i in img]
    return img, np.stack(pick).astype(np.int32)


def sample_rows(store: np.ndarray, triples: list, rng: np.random.RandomState,
                indices: np.ndarray, batch_size: int,
                weights: list | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(store rows, one triple of each): :func:`sample_indices` on ``store``."""
    img, trip = sample_indices(triples, rng, indices, batch_size, weights)
    return store[img], trip


@dataclass
class TripleDataset:
    """In-memory (features, triples) pairs with ragged triples per image.

    features : float[N, R, F]
    triples  : list of int32[n_i, 3] (or a dense int32[N, T, 3])
    """

    features: np.ndarray
    triples: list[np.ndarray] | np.ndarray
    # Per-triple sampling weights (list of float[n_i], each summing to 1),
    # set by set_predicate_balance(); None = uniform.
    triple_weights: list | None = None

    def __post_init__(self):
        if isinstance(self.triples, np.ndarray) and self.triples.ndim == 3:
            self.triples = [t for t in self.triples]
        if len(self.triples) != self.features.shape[0]:
            raise ValueError(
                f"{len(self.triples)} triple lists for "
                f"{self.features.shape[0]} feature rows"
            )

    def set_predicate_balance(self, alpha: float) -> "TripleDataset":
        """Weight each image's triples ∝ global-predicate-frequency^(−alpha)
        (:func:`sgg_torch.data.images.compute_triple_weights`); alpha ≤ 0
        keeps the uniform choice."""
        from sgg_torch.data.images import compute_triple_weights

        self.triple_weights = compute_triple_weights(self.triples, alpha)
        return self

    def __len__(self) -> int:
        return self.features.shape[0]

    def process_slice(self, process_index: int, process_count: int) -> np.ndarray:
        """Disjoint, covering image-index shard for this process."""
        return np.arange(len(self))[process_index::process_count]

    def sample_batch(self, rng: np.random.RandomState, indices: np.ndarray,
                     batch_size: int) -> dict:
        """(image, one of its triples) pairs, the reference's unit."""
        feats, trip = sample_rows(self.features, self.triples, rng, indices, batch_size,
                                  self.triple_weights)
        return {"features": feats, "triples": trip}

    @classmethod
    def from_shards(cls, shard_paths: list[str]) -> "TripleDataset":
        """Images without triples are dropped, as in the reference."""
        feats, triples = [], []
        for p in shard_paths:
            d = read_feature_shard(p)
            n = d["features"].shape[0]
            per_image: list[list] = [[] for _ in range(n)]
            for row in d["triples"]:
                per_image[int(row[0])].append(row[1:4])
            keep = [i for i in range(n) if per_image[i]]
            feats.append(d["features"][keep])
            triples.extend(
                np.asarray(per_image[i], dtype=np.int32) for i in keep
            )
        return cls(features=np.concatenate(feats, axis=0), triples=triples)


def data_store(dataset) -> tuple[np.ndarray, str]:
    """(host array, batch key): ``features`` float [N, R, F] or ``images`` u8
    [N, H, W, 3]."""
    if hasattr(dataset, "features"):
        return dataset.features, "features"
    return dataset.images, "images"


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor sharing its memory; a bfloat16 array
    (``ml_dtypes``) keeps its bits as ``torch.bfloat16``."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _dense_cum_weights(tri_list, weights_list, T: int) -> np.ndarray:
    """[N, T] float32 per-image CDF over triples for inverse-CDF sampling.

    Row j holds cumsum(weights_j) over its n_j triples (last entry pinned to
    exactly 1.0 against float-sum drift) and 1.0 in every pad slot, so
    ``(u > cumw).sum(-1)`` with u ∈ [0,1) always lands on a real triple.
    """
    N = len(tri_list)
    cumw = np.ones((N, T), np.float32)
    for j, t in enumerate(tri_list):
        n = t.shape[0]
        c = np.cumsum(np.asarray(weights_list[j], np.float64))
        c[-1] = 1.0
        cumw[j, :n] = c.astype(np.float32)
        cumw[j, n - 1] = 1.0
    return cumw


def quantize_feature_store(feats: np.ndarray, chunk: int = 8192
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-region int8 quantization of a feature store:
    ``(q int8 [N, R, F], scale float32 [N, R])`` with ``x ≈ q * scale``, the
    scale each region's absmax / 127 (at least 1e-12). Chunked so the
    temporary float32 copy never exceeds ``chunk`` images."""
    n = feats.shape[0]
    q = np.empty(feats.shape, np.int8)
    scale = np.empty(feats.shape[:-1], np.float32)
    for lo in range(0, n, chunk):
        f = np.asarray(feats[lo : lo + chunk], np.float32)
        s = np.abs(f).max(axis=-1) / 127.0
        np.maximum(s, 1e-12, out=s)
        q[lo : lo + chunk] = np.clip(
            np.rint(f / s[..., None]), -127, 127
        ).astype(np.int8)
        scale[lo : lo + chunk] = s
    return q, scale


@dataclass
class DeviceStore:
    """What :func:`gather_super_batch` reads, on one device.

    ``data``: the store [N, ...] (int8 when ``scale`` is set); ``scale``:
    float32 [N, R] or None; ``dense`` int32 [N, T, 3] and ``counts`` int32
    [N]: each image's triples, zero-padded, and their number; ``cumw``:
    float32 [N, T], the per-image CDF of the triple weights, or None for the
    uniform choice; ``store_dtype``: the dtype a batch comes out in (the
    host store's); ``key``: ``features`` or ``images``."""

    data: torch.Tensor
    scale: torch.Tensor | None
    dense: torch.Tensor
    counts: torch.Tensor
    cumw: torch.Tensor | None
    store_dtype: torch.dtype
    key: str = "features"

    def __len__(self) -> int:
        return self.data.shape[0]

    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.data, self.scale, self.dense, self.counts, self.cumw)
                if t is not None]


def gather_super_batch(store: DeviceStore, img: torch.Tensor, u: torch.Tensor) -> dict:
    """One super-batch from explicit draws, the reference's
    ``_make_sample_body``: ``img`` int [n_sub, B] indexes the store, ``u``
    float32 [n_sub, B] in [0, 1) picks each image's triple: by inverse CDF,
    ``(u > cumw[img]).sum(-1)`` (strict, so a draw equal to a step of the CDF
    takes that step's triple), or uniformly, ``int(u * counts[img])``. An int8
    store is dequantized per batch, ``(q * scale)`` in float32 and then one
    cast to the store's dtype."""
    if store.cumw is not None:
        tsel = (u[..., None] > store.cumw[img]).sum(-1)
    else:
        tsel = (u * store.counts[img]).long()
    x = store.data[img]
    if store.scale is not None:
        x = (x.float() * store.scale[img][..., None]).to(store.store_dtype)
    return {store.key: x, "triples": store.dense[img, tsel]}


def _triple_tables(triples: list, weights: list | None, T: int):
    """(dense int32 [n, T, 3], counts int32 [n], cumw float32 [n, T] or
    None) for the images' triple lists."""
    n = len(triples)
    dense = np.zeros((n, T, 3), np.int32)
    counts = np.zeros((n,), np.int32)
    for j, t in enumerate(triples):
        dense[j, : t.shape[0]] = t
        counts[j] = t.shape[0]
    cumw = None if weights is None else _dense_cum_weights(triples, weights, T)
    return dense, counts, cumw


def _store_parts(dataset, int8_store: bool):
    """(host store, host scale or None, batch key, store dtype): the store
    int8-quantized when asked and it holds features."""
    store_host, key = data_store(dataset)
    store_dtype = to_tensor(store_host[:1]).dtype
    if int8_store and key == "features":
        q, scale = quantize_feature_store(store_host)
        return q, scale, key, store_dtype
    return store_host, None, key, store_dtype


def _draw_fn(device, seed: int, shape: tuple, N: int):
    """step → (img [shape] int64, u [shape] float32) from one seeded
    ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draws(step: int):
        img = torch.randint(0, N, shape, generator=gen, device=device)
        return img, torch.rand(shape, generator=gen, device=device)

    return draws


def make_train_iterator(dataset, batch_size: int, n_critic: int, seed: int = 0,
                        process_index: int = 0, process_count: int = 1,
                        prefetch: int = 2, skip: int = 0) -> Iterator[dict]:
    """Infinite iterator of numpy super-batches, drawn as the reference's
    ``make_train_iterator`` draws them (weighted when the dataset has
    triple weights) from this process's slice of the images
    (``process_slice``: disjoint, covering, within one image of each
    other). ``skip`` super-batches are drawn first and dropped (their
    indices only, no rows gathered or decoded), so that a resumed run
    continues the draws. Close it (``.close()``) to stop the prefetch
    thread."""
    indices = dataset.process_slice(process_index, process_count)
    if len(indices) == 0:
        raise ValueError(f"process {process_index}/{process_count} got an empty shard "
                         f"({len(dataset)} images)")
    rng = np.random.RandomState(seed + 7919 * process_index)
    n_sub = n_critic + 1
    for _ in range(skip * n_sub):
        sample_indices(dataset.triples, rng, indices, batch_size, dataset.triple_weights)

    def host_batch() -> dict:
        subs = [dataset.sample_batch(rng, indices, batch_size) for _ in range(n_sub)]
        return {k: np.stack([s[k] for s in subs]) for k in subs[0]}

    if prefetch <= 0:
        while True:
            yield host_batch()

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            b = host_batch()
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.5)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, daemon=True, name="sgg-torch-data-prefetch")
    thread.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        thread.join(timeout=10)


def device_store(dataset, int8_store: bool, device) -> DeviceStore:
    """The dataset's store (features, int8 features with their scale, or
    uint8 images) and its triple tables on ``device``."""
    store_host, scale_host, key, store_dtype = _store_parts(dataset, int8_store)
    tri = dataset.triples
    weights = getattr(dataset, "triple_weights", None)
    dense, counts, cumw = _triple_tables(tri, weights, max(t.shape[0] for t in tri))
    put = lambda a: None if a is None else to_tensor(a).to(device)  # noqa: E731
    return DeviceStore(put(store_host), put(scale_host), put(dense), put(counts), put(cumw),
                       store_dtype, key)


def make_device_train_iterator(dataset, batch_size: int, n_critic: int, seed: int = 0,
                               device: torch.device | str = "cuda", int8_store: bool = False,
                               draws: Callable | None = None) -> Iterator[dict]:
    """Device-resident iterator: the store (features, int8 features with
    their scale, or uint8 images) and the triple tables go to ``device``
    once; each super-batch is one :func:`gather_super_batch`. ``draws(step)
    → (img, u)`` gives each step's draws (default: a ``torch.Generator`` on
    the device seeded with ``seed``: img uniform over the images, u uniform
    in [0, 1))."""
    store = device_store(dataset, int8_store, device)
    draws = draws or _draw_fn(device, seed, (n_critic + 1, batch_size), len(store))

    def gen_batches():
        step = 0
        while True:
            img, u = draws(step)
            yield gather_super_batch(store, img, u)
            step += 1

    return gen_batches()


class FusedStepper:
    """``n_steps`` sample-and-step iterations per call, the counterpart of
    the reference's ``lax.scan(step ∘ sample)``
    (:func:`make_fused_device_stepper` builds it).

    ``stepper(state, step0) → metrics`` runs sample steps ``step0`` to
    ``step0 + n_steps − 1`` and train steps ``state.step`` onwards, leaves
    the state advanced and returns the last step's metrics. Before each call
    the host fills a static buffer with the steps' draws, in order: each
    step's ``(img, u)`` from ``draws`` and its noise and ``tau`` from
    ``step_fn.inputs`` (what ``step_fn`` draws when given no noise). One
    iteration (:meth:`_body`) reads its row of the buffer at a device
    counter, gathers the super-batch (:func:`gather_super_batch`), runs
    ``step_fn`` and advances the counter, so it reads nothing else from the
    host.

    On CUDA the first call runs ``WARMUP`` iterations eagerly on a side
    stream (kernel builds, library plans, the allocator), then captures one
    iteration in a ``torch.cuda.CUDAGraph`` (it does not run while captured)
    and replays it for the rest of the steps; every later call is
    ``n_steps`` replays with no wait for the device. A failed capture
    raises. The warm-up iterations are steps of the sequence, so the state
    after a call does not depend on where the capture fell.
    ``capture_s`` and ``capture_bytes`` (the device memory the capture
    reserved) record it. On the CPU a call runs the ``n_steps`` iterations
    eagerly, with no graph.
    """

    WARMUP = 1

    def __init__(self, store: DeviceStore, step_fn: Callable, shape: tuple, n_steps: int,
                 draws: Callable, device: torch.device):
        self.store, self.step_fn, self.shape, self.n_steps = store, step_fn, shape, n_steps
        self.draws, self.device = draws, device
        self.graph = None
        self.capture_s = self.capture_bytes = None
        self._buf: dict | None = None
        self._pos = torch.zeros(1, dtype=torch.long, device=device)
        self._out: dict | None = None

    def _fill(self, state, step0: int) -> None:
        for k in range(self.n_steps):
            img, u = self.draws(step0 + k)
            row = {"img": img, "u": u,
                   **self.step_fn.inputs(state.step + k, self.shape[1], self.device)}
            if self._buf is None:
                self._buf = {name: torch.empty((self.n_steps, *t.shape), dtype=t.dtype,
                                               device=self.device) for name, t in row.items()}
            for name, t in row.items():
                self._buf[name][k].copy_(t)
        self._pos.zero_()

    def _body(self, state) -> dict:
        row = {name: b.index_select(0, self._pos).squeeze(0) for name, b in self._buf.items()}
        batch = gather_super_batch(self.store, row.pop("img"), row.pop("u"))
        metrics = self.step_fn(state, batch, row)
        self._pos.add_(1)
        return metrics

    def _capture(self, state) -> int:
        """Warm-up iterations, then the capture; returns the steps run."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(main)
        warm = min(self.WARMUP, self.n_steps - 1)
        with torch.cuda.stream(side):
            for _ in range(warm):
                self._body(state)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does; what it reserves then is the graph's
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph, step = torch.cuda.CUDAGraph(), state.step
        with torch.cuda.graph(graph):
            self._out = self._body(state)
        state.step = step  # captured, not run
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.capture_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        return warm

    def __call__(self, state, step0: int) -> dict:
        self._fill(state, step0)
        if self.device.type != "cuda":
            for _ in range(self.n_steps):
                metrics = self._body(state)
            return metrics
        first = state.step
        ran = self._capture(state) if self.graph is None else 0
        for _ in range(self.n_steps - ran):
            self.graph.replay()
        state.step = first + self.n_steps
        return {k: v.clone() for k, v in self._out.items()}


def make_fused_device_stepper(dataset, step_fn: Callable, batch_size: int, n_critic: int,
                              n_steps: int, seed: int = 0, device: torch.device | str = "cuda",
                              int8_store: bool = False, draws: Callable | None = None
                              ) -> FusedStepper:
    """N train steps per call over the device-resident store, from the
    reference's ``make_fused_device_stepper``: a :class:`FusedStepper`,
    ``stepper(state, step0) → last metrics``, where ``step0`` counts sample
    steps from this process's launch (the per-step iterator also restarts
    its draws on relaunch). Its draws are :func:`make_device_train_iterator`'s
    (the same ``draws``, default the same seeded generator, drawn in the
    same order) and its step noise is what ``step_fn`` draws per step, so
    N is a pure scheduling choice: N steps of it equal N steps of the
    iterator and ``step_fn``."""
    device = torch.device(device)
    store = device_store(dataset, int8_store, device)
    shape = (n_critic + 1, batch_size)
    return FusedStepper(store, step_fn, shape, n_steps,
                        draws or _draw_fn(device, seed, shape, len(store)), device)


def rotation_subsets(n: int, per_image_bytes: int, subset_bytes: int, seed: int
                     ) -> list[np.ndarray]:
    """The reference's subsets of ``n`` images: ``RandomState(seed)``'s
    permutation cut into equal pieces of ``subset_bytes // per_image_bytes``
    images (at least 1, at most n), the last one wrapping to the start."""
    S = max(1, min(n, subset_bytes // max(per_image_bytes, 1)))
    n_subsets = max(1, -(-n // S))
    order = np.random.RandomState(seed).permutation(n)
    both = np.concatenate([order, order])
    return [both[j * S : j * S + S] for j in range(n_subsets)]


class RotatingDeviceIterator:
    """Super-batches from a store larger than the device budget, from the
    reference's ``make_rotating_device_iterator``.

    The store (int8 with its scale when asked) stays on the host, split by
    :func:`rotation_subsets` into equal subsets of at most ``subset_bytes``.
    Training gathers from the resident subset (:func:`gather_super_batch`,
    img uniform over the subset) while a thread uploads the next one; the
    iterator swaps when that one is ready and the resident one has served
    ``min_steps_per_subset`` steps, so the schedule follows the upload's
    speed. At most two subsets are alive: the thread starts the next upload
    only after a swap has released the old one.

    On CUDA the thread copies from pinned memory on its own stream and
    records an event; the swap makes the current stream wait on it and
    records the current stream on the new subset's tensors, so the
    allocator reuses a released subset's memory only after the gathers
    queued on it have run. ``draws(step) → (img, u)`` overrides the draws
    (default: a ``torch.Generator`` on the device seeded with ``seed``).
    ``swaps``, ``uploads`` (subset, host gather s, copy s, bytes) and
    ``max_alive`` record what happened; :meth:`close` stops the thread.
    """

    def __init__(self, dataset, batch_size: int, n_critic: int, seed: int = 0,
                 subset_bytes: int = 2_000_000_000, min_steps_per_subset: int = 0,
                 int8_store: bool = False, device: torch.device | str = "cuda",
                 log: Callable | None = print, draws: Callable | None = None):
        self.device = torch.device(device)
        self._store, self._scale, self._key, self._store_dtype = _store_parts(
            dataset, int8_store)
        per_img = self._store[0].nbytes + (0 if self._scale is None else self._scale[0].nbytes)
        self.subsets = rotation_subsets(len(dataset), per_img, subset_bytes, seed)
        self.n_subsets = len(self.subsets)
        self._triples = dataset.triples
        self._weights = getattr(dataset, "triple_weights", None)
        self._T = max(t.shape[0] for t in dataset.triples)
        self._log = log
        self.min_steps = min_steps_per_subset
        self.swaps = 0
        self.uploads: list[tuple] = []
        self.alive = self.max_alive = 0
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        S = len(self.subsets[0])
        self._draws = draws or _draw_fn(self.device, seed, (n_critic + 1, batch_size), S)
        self._step = self._on_subset = 0
        self._current, _ = self._upload(0)
        self._ready: queue.Queue = queue.Queue(maxsize=1)
        self._want = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        if self.n_subsets > 1:
            self._want.set()
            self._thread = threading.Thread(target=self._preload, daemon=True,
                                            name="sgg-torch-rotate-upload")
            self._thread.start()

    def _count(self, delta: int) -> None:
        with self._lock:
            self.alive += delta
            self.max_alive = max(self.max_alive, self.alive)

    def _upload(self, j: int) -> tuple[DeviceStore, object]:
        """Subset j on the device, and the event its copy recorded (None
        off CUDA), after the copy has finished."""
        t0 = time.perf_counter()
        idx = self.subsets[j]
        host = [self._store[idx], None if self._scale is None else self._scale[idx],
                *_triple_tables([self._triples[i] for i in idx],
                                None if self._weights is None
                                else [self._weights[i] for i in idx], self._T)]
        t1 = time.perf_counter()
        event = None
        if self._stream is None:
            parts = [None if a is None else to_tensor(a).to(self.device) for a in host]
        else:
            pinned = [None if a is None else to_tensor(a).pin_memory() for a in host]
            with torch.cuda.stream(self._stream):
                parts = [None if a is None else a.to(self.device, non_blocking=True)
                         for a in pinned]
                event = torch.cuda.Event()
                event.record(self._stream)
            event.synchronize()
            del pinned
        sub = DeviceStore(*parts, self._store_dtype, self._key)
        self._count(1)
        weakref.finalize(sub, self._count, -1)
        t2 = time.perf_counter()
        nbytes = sum(a.nbytes for a in host if a is not None)
        self.uploads.append((j, t1 - t0, t2 - t1, nbytes))
        if self._log:
            self._log(f"[sgg.data] subset {j} upload: host gather {t1 - t0:.3f}s, "
                      f"device copy {t2 - t1:.3f}s ({nbytes / 1e6:.1f} MB)")
        return sub, event

    def _preload(self) -> None:
        j = 1
        while True:
            self._want.wait()
            if self._stop.is_set():
                return
            self._want.clear()
            self._ready.put(self._upload(j % self.n_subsets))
            j += 1

    def preloaded(self) -> bool:
        """Whether the next subset is on the device and waits for a swap."""
        return not self._ready.empty()

    def _swap(self) -> None:
        sub, event = self._ready.get_nowait()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in sub.tensors():
                t.record_stream(stream)
        self._current = sub  # the old subset goes with its last reference
        del sub
        self.swaps += 1
        if self._log and self.swaps % self.n_subsets == 0:
            self._log(f"[sgg.data] subset rotation: cycle {self.swaps // self.n_subsets} "
                      f"complete ({self._on_subset} steps on last subset)")
        self._on_subset = 0
        self._want.set()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if (self.n_subsets > 1 and self._on_subset >= self.min_steps
                and not self._ready.empty()):
            self._swap()
        img, u = self._draws(self._step)
        batch = gather_super_batch(self._current, img, u)
        self._step += 1
        self._on_subset += 1
        return batch

    def close(self) -> None:
        self._stop.set()
        self._want.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
