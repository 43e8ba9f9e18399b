"""Build and bind the port's JPEG loader (``jpeg_loader.cc``), from
``sgg/native/loader.py``, and its JPEG encoder (:func:`encode_file`, which
the synthetic corpus writes with; the reference writes with PIL).

The library is compiled with g++ at its first use in a process, never at
import, into ``build/sgg_torch_native/`` under the repository root (beside
the kernels' ``build/sgg_torch_kernels/``), and rebuilt when a hash of the
source, the decoder and the flags changes. The decoder is libjpeg where its
headers are found (the reference's own decoder), else nvJPEG from the CUDA
toolkit (``$CUDA_HOME``, default ``/usr/local/cuda``); with neither, every
call raises :class:`NativeUnavailable`. A lock guards the build and the load,
since serving's handler threads may decode at once; the decode itself is
thread-safe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "jpeg_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgg_torch_native"
LIB_NAME = "libsggjpeg.so"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_error: str | None = None
build_seconds = 0.0  # wall time of this process's build (0 when it was up to date)


class NativeUnavailable(RuntimeError):
    """The loader cannot be built or loaded here."""


def cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def has_libjpeg_headers() -> bool:
    """Whether g++ finds ``jpeglib.h`` on its include path."""
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def decoder_flags() -> tuple[str, list[str]]:
    """(decoder, g++ arguments after the source) for this machine: libjpeg
    where its headers are, else nvJPEG; raises NativeUnavailable with neither."""
    if has_libjpeg_headers():
        return "libjpeg", ["-DSGG_DECODER_LIBJPEG", "-ljpeg", "-lpthread"]
    cuda = cuda_home()
    if (cuda / "include" / "nvjpeg.h").exists():
        lib = cuda / "lib64"
        return "nvjpeg", ["-DSGG_DECODER_NVJPEG", f"-I{cuda / 'include'}", f"-L{lib}",
                          f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart", "-lpthread"]
    raise NativeUnavailable(
        f"no JPEG decoder to build against: g++ finds no jpeglib.h and there is no "
        f"{cuda / 'include' / 'nvjpeg.h'}")


def build() -> tuple[Path, float]:
    """Compile the library if its source or flags changed → (path, seconds)."""
    decoder, tail = decoder_flags()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "source.sha256"
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *tail)).encode())
    h.update(SRC.read_bytes())
    digest = h.hexdigest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *tail]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeUnavailable(f"{decoder} loader build failed: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"{decoder} loader build failed:\n{' '.join(cmd)}\n"
                                f"{out.stderr[-1500:]}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, time.perf_counter() - t0


def _load():
    global _lib, _error, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeUnavailable(_error)
        try:
            path, build_seconds = build()
            lib = ctypes.CDLL(str(path))
            u8p, ip = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)
            for name, argtypes, restype in (
                    ("sgg_decoder_route", [], ctypes.c_char_p),
                    ("sgg_decoder_ready", [], ctypes.c_int),
                    ("sgg_decode_resize_file", [ctypes.c_char_p, ctypes.c_int, u8p],
                     ctypes.c_int),
                    ("sgg_decode_raw", [ctypes.c_char_p, ctypes.c_int, u8p, ctypes.c_long,
                                        ip, ip], ctypes.c_int),
                    ("sgg_decode_batch", [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                          ctypes.c_int, u8p, ip, ctypes.c_int],
                     ctypes.c_int),
                    ("sgg_encode_file", [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p,
                                         ctypes.c_int], ctypes.c_int)):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            if lib.sgg_decoder_ready() != 0:
                raise NativeUnavailable(
                    f"the {lib.sgg_decoder_route().decode()} decoder did not start")
            _lib = lib
            return _lib
        except (OSError, NativeUnavailable) as e:
            _error = str(e)
            raise NativeUnavailable(_error) from e


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def route() -> str:
    """The decoder (and encoder) the loader was built with: ``libjpeg`` or
    ``nvjpeg``."""
    return _load().sgg_decoder_route().decode()


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def _check_size(size: int) -> None:
    if int(size) != size or size <= 0:
        raise ValueError(f"the output size must be a positive integer, not {size!r}")


def decode_file(path: str, size: int) -> np.ndarray:
    """JPEG file → uint8 [size, size, 3] (RGB)."""
    _check_size(size)
    lib = _load()
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.sgg_decode_resize_file(os.fsencode(path), size, _u8(out))
    if rc:
        _raise(rc, path)
    return out


def _raise(rc: int, path: str):
    if rc == 1:
        raise FileNotFoundError(f"native decode failed ({rc}): cannot open {path}")
    raise IOError(f"native decode failed ({rc}) for {path}")


def decode_batch(paths: list[str], size: int, n_threads: int = 0) -> np.ndarray:
    """Threaded batch decode → uint8 [N, size, size, 3]; ``n_threads`` 0
    takes one thread per host core."""
    _check_size(size)
    lib = _load()
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.sgg_decode_batch(arr, n, size, _u8(out),
                                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                                    n_threads)
    if failures:
        bad = [paths[i] for i in np.nonzero(status)[0][:5]]
        raise IOError(f"native decode failed for {failures} files, e.g. {bad}")
    return out


def decode_raw(path: str, size: int) -> np.ndarray:
    """The decoded image before the resize, at the prescale the loader picks
    for ``size``: uint8 [h, w, 3]."""
    _check_size(size)
    lib = _load()
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    buf = np.empty(1, np.uint8)
    for _ in range(2):
        rc = lib.sgg_decode_raw(os.fsencode(path), size, _u8(buf), buf.size,
                                ctypes.byref(h), ctypes.byref(w))
        if rc == 3:  # too small: now h and w are known
            buf = np.empty(h.value * w.value * 3, np.uint8)
            continue
        if rc:
            _raise(rc, path)
        return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3)
    raise IOError(f"native decode failed (buffer) for {path}")


# Larger than any JPEG side (65,535): decode_raw at this size takes no prescale.
FULL_SIZE = 1 << 16


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a JPEG file: its decode at full size (no prescale)."""
    h, w = decode_raw(path, FULL_SIZE).shape[:2]
    return w, h


def encode_file(path: str, rgb: np.ndarray, quality: int = 75) -> None:
    """Write uint8 RGB [h, w, 3] as a baseline 4:2:0 JPEG of ``quality`` at
    ``path``, with the library's route (:func:`route`): libjpeg at PIL's
    default settings, or nvJPEG's encoder. Raises on any failure; nothing
    falls back to another encoder."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_file takes uint8 [h, w, 3], not {rgb.dtype} {rgb.shape}")
    lib = _load()
    rc = lib.sgg_encode_file(os.fsencode(path), rgb.shape[0], rgb.shape[1], _u8(rgb),
                             int(quality))
    if rc == 1:
        raise OSError(f"native encode failed ({rc}): cannot write {path}")
    if rc:
        raise IOError(f"native {route()} encode failed ({rc}) for {path}")


def resize_plain(src: np.ndarray, out: int) -> np.ndarray:
    """The loader's fixed-point 16.16 bilinear resize in numpy (its plain
    version): uint8 [h, w, 3] → uint8 [out, out, 3], bit for bit."""
    h, w = src.shape[:2]
    sx, sy = (w << 16) // out, (h << 16) // out

    def axis(s, n):
        f = np.maximum(np.arange(out, dtype=np.int64) * s + (s >> 1) - (1 << 15), 0)
        i0 = f >> 16
        return i0, np.where(i0 + 1 < n, i0 + 1, n - 1), (f >> 8) & 0xFF

    y0, y1, wy = axis(sy, h)
    x0, x1, wx = axis(sx, w)
    s = src.astype(np.int64)
    wx_, wy_ = wx[None, :, None], wy[:, None, None]
    top = s[y0][:, x0] * (256 - wx_) + s[y0][:, x1] * wx_
    bot = s[y1][:, x0] * (256 - wx_) + s[y1][:, x1] * wx_
    return ((top * (256 - wy_) + bot * wy_) >> 16).astype(np.uint8)
