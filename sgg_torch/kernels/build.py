"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source compiles to an object, all of them at once in
parallel nvcc processes, for ``sm_90a`` (Hopper); the objects link into one
shared library with a plain C interface,
``build/sgg_torch_kernels/libsgg_kernels.so`` under the repository root. No
source includes PyTorch's headers, so the build takes seconds where
``torch.utils.cpp_extension.load`` takes minutes and needs ninja. The library
is rebuilt only when a hash of the sources (``*.cu`` and ``*.cuh``) and the
flags changes, at the first launch in a process, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgg_torch_kernels"
LIB_NAME = "libsgg_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name: (argtypes, restype) of every C entry of the library.
_ENTRIES = {
    # (dtype, hard, row_tile, B, R, F, A, H, E, Z, V, feats, z, gumbel,
    #  mask_bias, tau, wf, wh, bh, v, wc, bc, wi, bi, k, bk, wd, bd, wv, bv,
    #  emb, proj, y, stream)
    "sgg_fused_decode": ([_I] * 11 + [_P] * 4 + [ctypes.c_float] + [_P] * 18, _I),
    "sgg_fused_decode_row_tile": ([_I] * 7, _I),
    # (dtype, out_dtype, relu, M, N, K, a, b, scale, bias, out, a_vec, b_vec,
    #  stream)
    "sgg_fused_matmul": ([_I] * 6 + [_P] * 5 + [_I] * 2 + [_P], _I),
    # (relu, M, N, K, a, b, scale, bias, out, bm, bn, bk, stages, threads,
    #  smem, grid_x, grid_y, stream): matmul.plan()'s tiled launch
    "sgg_fused_matmul_tiled": ([_I] * 4 + [_P] * 5 + [_I] * 8 + [_P], _I),
    # (dtype, relu, B, H, W, C, kh, kw, N, x, w, scale, bias, out, a_vec,
    #  b_vec, stream)
    "sgg_conv_direct": ([_I] * 9 + [_P] * 5 + [_I] * 2 + [_P], _I),
    # (relu, B, H, W, C, kh, kw, N, x, w, scale, bias, out, bm, bn, bk,
    #  stages, threads, smem, grid_x, grid_y, stream): conv_direct.plan()'s
    # tiled launch
    "sgg_conv_direct_tiled": ([_I] * 8 + [_P] * 5 + [_I] * 8 + [_P], _I),
    # (dtype, BH, S, D, q, k, v, o, lse, scale, stream)
    "sgg_flash_attention": ([_I] * 4 + [_P] * 5 + [ctypes.c_float, _P], _I),
    # (dtype, BH, S, D, q, k, v, do, lse, dstat, dq, scale_q, scale, stream)
    "sgg_flash_attention_bwd_dq": ([_I] * 4 + [_P] * 7 + [ctypes.c_float] * 2 + [_P], _I),
    # (dtype, BH, S, D, q, k, v, do, lse, dstat, dk, dv, scale_q, stream)
    "sgg_flash_attention_bwd_dkv": ([_I] * 4 + [_P] * 8 + [ctypes.c_float, _P], _I),
    # Check-only bf16 entries that store the float32 results before the cast:
    # (BH, S, D, q, k, v, o32, lse, scale, stream),
    "sgg_flash_attention_f32_result": ([_I] * 3 + [_P] * 5 + [ctypes.c_float, _P], _I),
    # (BH, S, D, q, k, v, do, lse, dstat, dq32, scale_q, scale, stream),
    "sgg_flash_attention_bwd_dq_f32_result": (
        [_I] * 3 + [_P] * 7 + [ctypes.c_float] * 2 + [_P], _I),
    # (BH, S, D, q, k, v, do, lse, dstat, dk32, dv32, scale_q, stream)
    "sgg_flash_attention_bwd_dkv_f32_result": (
        [_I] * 3 + [_P] * 8 + [ctypes.c_float, _P], _I),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> tuple[Path, float]:
    """Compile the library if its sources changed → (path, seconds spent).

    One nvcc per source, all started together, then one link. The
    compilers' output, with ptxas's register and shared-memory report, is
    kept in ``build.log`` beside the library.
    """
    srcs = sources()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _digest(srcs + headers())
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    tmp = BUILD_DIR / f"{LIB_NAME}.{pid}.tmp"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
