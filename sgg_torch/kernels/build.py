"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All ``csrc/*.cu`` sources compile into one shared library with a plain C
interface, ``build/sgg_torch_kernels/libsgg_kernels.so`` under the repository
root, for ``sm_90a`` (Hopper). No source includes PyTorch's headers, so the
build takes seconds where ``torch.utils.cpp_extension.load`` takes minutes and
needs ninja. The library is rebuilt only when a hash of the sources and the
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# sgg_fused_decode(dtype, hard, B, R, F, A, H, E, Z, V, feats, z, gumbel,
#   mask_bias, tau, wf, wh, bh, v, wc, bc, wi, bi, k, bk, wd, bd, wv, bv, emb,
#   proj, y, stream)
_FUSED_DECODE_ARGTYPES = [_I] * 10 + [_P] * 4 + [ctypes.c_float] + [_P] * 18


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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

    The compiler's output, with ptxas's register and shared-memory report,
    is kept in ``build.log`` beside the library.
    """
    srcs = sources()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _digest(srcs)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.sgg_fused_decode.argtypes = _FUSED_DECODE_ARGTYPES
    lib.sgg_fused_decode.restype = ctypes.c_int
    lib.sgg_fused_decode_smem_bytes.argtypes = [_I] * 7
    lib.sgg_fused_decode_smem_bytes.restype = ctypes.c_long
    return lib
