"""Preprocess-time feature extraction, images → region features, from
``sgg/data/extract.py``: the image loaders (``:21-48``), VG's image paths
(``:51-69``), batched extraction in memory (``:72-124``) and streamed to
shards (``:127-307``), and the VGG-19 hot loop (``:310-327``).

JPEGs decode through the port's native loader (``sgg_torch.native``). Where
the loader cannot be built, the loaders raise ``NativeUnavailable``; the
reference falls back to PIL there. Only a file the loader itself rejects (a
PNG, a CMYK JPEG) goes to PIL, and only where PIL is installed; else the
error names the file.

The encoder is ``sgg_torch.models.encoders``' on ``use_pallas``'s route (by
default the CUDA kernels on the card, their plain versions on the CPU), with
its weights put on the device once. Extraction runs on CUDA unless it is
given ``device='cpu'``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

STALL_POLL_SEC = 30.0  # how often extract_to_shards' stall watchdog looks
_JPEG = (".jpg", ".jpeg")


def _pil_load(path: str, size: int, why: Exception | None) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise IOError(f"{path}: {why or 'not a JPEG'}, and PIL is not installed to "
                      "decode it") from e
    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def load_and_resize(path: str, size: int = 224) -> np.ndarray:
    """JPEG/PNG → uint8 [size, size, 3] (RGB): the native loader for JPEGs,
    PIL for what it rejects or does not read."""
    if path.lower().endswith(_JPEG):
        from sgg_torch import native

        try:
            return native.decode_file(path, size)
        except FileNotFoundError:
            raise
        except OSError as e:  # the loader rejects the file
            return _pil_load(path, size, e)
    return _pil_load(path, size, None)


def load_batch(paths: list[str], size: int = 224) -> np.ndarray:
    """Batch decode → uint8 [N, size, size, 3]: the loader's threads when every
    file is a JPEG; a batch with a file the loader rejects goes file by file."""
    if paths and all(p.lower().endswith(_JPEG) for p in paths):
        from sgg_torch import native

        try:
            return native.decode_batch(list(paths), size)
        except OSError:
            pass  # find the file: load_and_resize raises or takes PIL for it
    return np.stack([load_and_resize(p, size) for p in paths])


def resolve_image_paths(image_ids: Sequence[int], image_dir: str,
                        exts=(".jpg", ".jpeg", ".png")) -> list[str]:
    """VG images are stored as ``<image_id>.jpg``; find each, error on gaps."""
    paths, missing = [], []
    for i in image_ids:
        for ext in exts:
            p = os.path.join(image_dir, f"{i}{ext}")
            if os.path.exists(p):
                paths.append(p)
                break
        else:
            missing.append(i)
    if missing:
        raise FileNotFoundError(
            f"{len(missing)} images not found in {image_dir} (first few ids: {missing[:5]})")
    return paths


def make_extractor(encoder_name: str, encoder_params: dict | None = None,
                   image_size: int = 224, use_pallas: bool = True,
                   dtype: torch.dtype = torch.float32, seed: int = 0,
                   vit_dims: tuple = (768, 12, 12), moe_experts: int = 0,
                   out_dtype: torch.dtype = torch.float32, device="cuda", moe_top_k: int = 2):
    """uint8 images [n, S, S, 3] (numpy) → features [n, R, F] in ``out_dtype``
    on the device: the encoder with ``encoder_params`` (a port state_dict;
    None draws seeded random weights, a pipeline smoke) on the device once."""
    from sgg_torch.cli.common import resolve_device
    from sgg_torch.models.encoders import make_encoder, normalize_for

    device = resolve_device(device)
    if encoder_name == "precomputed":
        raise ValueError("encoder 'precomputed' cannot extract features")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enc = make_encoder(encoder_name, use_pallas=use_pallas, dtype=dtype,
                           image_size=image_size, vit_dims=vit_dims,
                           moe_experts=moe_experts, moe_top_k=moe_top_k)
    if encoder_params is not None:
        enc.load_state_dict(encoder_params)
    enc.to(device)
    pin = device.type == "cuda"

    def apply(images_u8: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images_u8))
        if pin:  # an asynchronous copy, so the device's queue keeps running
            x = x.pin_memory()
        with torch.no_grad():
            x = normalize_for(encoder_name, x.to(device, non_blocking=pin))
            return enc(x).to(out_dtype)

    return apply


def extract_features(encoder_name: str, image_paths: Sequence[str], encoder_params=None,
                     batch_size: int = 32, image_size: int = 224, use_pallas: bool = True,
                     dtype: torch.dtype = torch.float32, seed: int = 0,
                     vit_dims: tuple = (768, 12, 12), moe_experts: int = 0,
                     device="cuda", moe_top_k: int = 2) -> np.ndarray:
    """Batched extraction → float32 [N, R, F]."""
    apply = make_extractor(encoder_name, encoder_params, image_size, use_pallas, dtype, seed,
                           vit_dims, moe_experts, device=device, moe_top_k=moe_top_k)
    out = []
    for lo in range(0, len(image_paths), batch_size):
        imgs = load_batch(list(image_paths[lo:lo + batch_size]), image_size)
        out.append(apply(imgs).cpu().numpy())
    return np.concatenate(out, axis=0)


def extract_to_shards(encoder_name: str, image_ids: Sequence[int],
                      image_paths: Sequence[str], triples_per_image: Sequence[np.ndarray],
                      out_dir: str, shard_size: int = 1024, encoder_params=None,
                      batch_size: int = 32, image_size: int = 224, use_pallas: bool = True,
                      dtype: torch.dtype = torch.float32, feat_dtype=np.float32,
                      seed: int = 0, log_every: int = 50, vit_dims: tuple = (768, 12, 12),
                      moe_experts: int = 0, stall_exit_sec: float = 900.0,
                      device="cuda", moe_top_k: int = 2) -> dict:
    """Streaming extraction: images → encoder → shards, in O(shard) host
    memory. A thread decodes batch i+1 (a queue of 4) while the device
    computes batch i; each batch is launched before the previous one is read
    back, and shards are written as they fill. With ``stall_exit_sec`` > 0 a
    watchdog exits the process with 86 when no batch has been read back for
    that long (the supervisor relaunches; ``vocab.json``, written last by
    preprocess, keeps a partial output from counting as done). Returns
    {"num_images", "num_shards", "images_per_sec", "decode_wait_frac",
    "seconds"}: the decode-wait share says whether decoding or the device
    bounds the run."""
    from sgg_torch.data.shards import shard_name, write_feature_shard

    out_dtype = torch.float16 if np.dtype(feat_dtype) == np.float16 else torch.float32
    apply = make_extractor(encoder_name, encoder_params, image_size, use_pallas, dtype, seed,
                           vit_dims, moe_experts, out_dtype=out_dtype, device=device,
                           moe_top_k=moe_top_k)
    n = len(image_paths)
    os.makedirs(out_dir, exist_ok=True)
    n_shards = max(1, -(-n // shard_size))
    q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def decode_loop():
        try:
            for lo in range(0, n, batch_size):
                chunk = list(image_paths[lo:lo + batch_size])
                if not put((lo, len(chunk), load_batch(chunk, image_size))):
                    return
        except BaseException as e:  # noqa: BLE001 (handed to the consumer)
            put(e)
            return
        put(None)

    decoder = threading.Thread(target=decode_loop, daemon=True, name="sgg-torch-extract-decode")
    decoder.start()
    progress = {"t": time.time()}

    def stall_watchdog():
        while not stop.wait(STALL_POLL_SEC):
            if time.time() - progress["t"] > stall_exit_sec:
                print(f"[extract] STALL: no batch readback for "
                      f"{time.time() - progress['t']:.0f}s — exit 86", flush=True)
                os._exit(86)

    watchdog = None
    if stall_exit_sec > 0:
        watchdog = threading.Thread(target=stall_watchdog, daemon=True,
                                    name="sgg-torch-extract-watchdog")
        watchdog.start()

    buf: list[np.ndarray] = []
    buf_count = shard_idx = shard_start = done = 0
    t0 = time.time()
    decode_wait = 0.0

    def flush(take: int) -> None:
        nonlocal buf, buf_count, shard_idx, shard_start
        feats = np.concatenate(buf, axis=0)
        write_feature_shard(
            os.path.join(out_dir, shard_name(shard_idx, n_shards)),
            np.asarray(image_ids[shard_start:shard_start + take], np.int32), feats[:take],
            [np.asarray(x, np.int32) for x in
             triples_per_image[shard_start:shard_start + take]])
        rest = feats[take:]
        buf = [rest] if rest.size else []
        buf_count -= take
        shard_idx += 1
        shard_start += take

    def read_back(pending) -> None:
        nonlocal buf_count, done
        n_valid, dev = pending
        buf.append(dev.cpu().numpy()[:n_valid])
        progress["t"] = time.time()
        buf_count += n_valid
        done += n_valid
        while buf_count >= shard_size:
            flush(shard_size)
        if log_every and (done // batch_size) % log_every == 0:
            el = max(time.time() - t0, 1e-9)
            print(f"[extract] {done}/{n} images ({done / el:.0f}/s, "
                  f"decode-wait {100 * decode_wait / el:.0f}%)", flush=True)

    pending = None  # (n_valid, features on the device): one batch in flight
    try:
        while True:
            tw = time.time()
            item = q.get()
            decode_wait += time.time() - tw
            if isinstance(item, BaseException):
                raise item
            nxt = None if item is None else (item[1], apply(item[2]))
            if pending is not None:
                read_back(pending)
            pending = nxt
            if item is None:
                break
        while buf_count > 0:
            flush(min(shard_size, buf_count))
    finally:
        stop.set()
        decoder.join(timeout=10)
        if watchdog is not None:
            watchdog.join(timeout=10)
    dt = time.time() - t0
    return {"num_images": n, "num_shards": shard_idx,
            "images_per_sec": round(n / max(dt, 1e-9), 1),
            "decode_wait_frac": round(decode_wait / max(dt, 1e-9), 3),
            "seconds": round(dt, 1)}


def extract_vgg_features(image_ids: Sequence[int], image_dir: str,
                         weights_path: str | None = None, batch_size: int = 32,
                         image_size: int = 224, device="cuda") -> np.ndarray:
    """The reference's preprocess hot loop: VGG-19 conv5 features per image,
    from a ``.npy`` weight dict or seeded weights."""
    params = None
    if weights_path:
        from sgg_torch.models.vgg import load_npy_weights

        params = load_npy_weights(weights_path)
    return extract_features("vgg19", resolve_image_paths(image_ids, image_dir),
                            encoder_params=params, batch_size=batch_size,
                            image_size=image_size, device=device)
