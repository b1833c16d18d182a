"""Build the package's CUDA kernels with nvcc and load them with ctypes.

All sources under `spotify_recommender_tpu_torch/csrc/*.cu` go into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libsrt_kernels.so csrc/*.cu

No `--use_fast_math`: flush-to-zero would flush tiny unit-vector
components, and the certificate's error bound assumes round-to-nearest
fp32 (see ops/fused_topk.BF16X2_EPS).

The library is built at first use into `spotify_recommender_tpu_torch/
_build/<hash of the sources>/`, so a fresh checkout builds it on the first
kernel launch and an edited source rebuilds it.  A missing nvcc or a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libsrt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C entry points: name -> argtypes (each returns cudaGetLastError() as int)
_SIGNATURES = {
    # x, hi, lo, n, stream
    "srt_split_bf16x2": (_P, _P, _P, _I64, _P),
    # q2, b, f, ft, ft_stride, np, depth, topc, ov, oi, ob, stream
    "srt_scan_v3": (_P, _I64, _I32, _P, _I64, _I64, _I32, _I32, _P, _P, _P, _P),
}


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the CUDA kernels"
        )
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build() -> Path:
    """Compile the library if this source hash has not been built yet;
    returns its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.srt_error_string.argtypes = (ctypes.c_int,)
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = library().srt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err}: {msg}")
