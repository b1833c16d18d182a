"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources under `spotify_recommender_tpu_torch/csrc/` go into two shared
libraries with a plain C interface, each built at its own first use:

    SERVING      split_bf16x2.cu, scan_v3.cu, scan_v2.cu, scan_wide.cu,
                 fused_topk.cu: the kernels of the user paths
                 (ops/cuda/split: the query prologue and the split;
                 scan_v3, scan_v2 on their flat and wide routes, fused),
                 libsrt_serving.so
    EXPERIMENTS  mxu_wgmma.cu, proto_scans.cu, ablation_r2.cu: the probes
                 of `experiments/` (ops/cuda/proto_scans, ablation),
                 libsrt_experiments.so

Both also compile `errors.cu` (the error message of a CUDA code), and both
hash every `csrc/*.cuh`.  Each source compiles in its own nvcc process,
all started together, and one more call links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler \\
         -fPIC -Xptxas=-v -c csrc/<name>.cu -o <name>.o       (in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libsrt_<lib>.so *.o

No `--use_fast_math`: flush-to-zero would flush tiny unit-vector
components, and the certificate's error bound assumes round-to-nearest
fp32 (see ops/fused_topk.BF16X2_EPS).

A library is built into `spotify_recommender_tpu_torch/_build/<hash of its
name, flags and sources>/`, so a fresh checkout builds it on the first
launch of one of its kernels and an edited source rebuilds it; `nvcc.log`
beside the library keeps ptxas's report of each kernel's registers and
spills.  A missing nvcc or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LOG_NAME = "nvcc.log"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float


@dataclasses.dataclass(frozen=True, eq=False)
class Library:
    """One kernel library: its sources under csrc/ and its C entry points
    (name -> argtypes; each returns cudaGetLastError() as an int)."""

    name: str
    sources: tuple
    signatures: dict

    @property
    def file_name(self) -> str:
        return f"libsrt_{self.name}.so"

    def paths(self) -> list:
        return [CSRC_DIR / s for s in self.sources]


SERVING = Library("serving", (
    "errors.cu", "split_bf16x2.cu", "scan_v3.cu", "scan_v2.cu", "scan_wide.cu",
    "fused_topk.cu",
), {
    # q, qn, ft, ft_sd, ft_sc, cn, excl, b, fq, fc, np, valid, k, exact,
    # bf16, eps, nsplit, split_cols, tq, vec, keys, ov, oi, stream
    "srt_fused_topk": (_P, _P, _P, _I64, _I64, _P, _P, _I64, _I64, _I64,
                       _I64, _I64, _I64, _I64, _I64, _F32, _I64, _I64, _I64,
                       _I64, _P, _P, _P, _P),
    # fq, fc, k, exact, bf16, tq, out (int)
    "srt_fused_blocks_per_sm": (_I64, _I64, _I64, _I64, _I64, _I64, _P),
    # q, qn, ft, ft_sd, ft_sc, cn, excl, b, fq, fc, np, valid, k, exact,
    # bf16, eps, nsplit, split_cols, cap, tq, vec, keys, ov, oi, stream
    "srt_fused_topk_large": (_P, _P, _P, _I64, _I64, _P, _P, _I64, _I64,
                             _I64, _I64, _I64, _I64, _I64, _I64, _F32, _I64,
                             _I64, _I64, _I64, _I64, _P, _P, _P, _P),
    # fq, fc, exact, bf16, tq, out (int)
    "srt_fused_large_blocks_per_sm": (_I64, _I64, _I64, _I64, _I64, _P),
    # large, k, tq, fc, bf16, out (4 ints)
    "srt_fused_tiling": (_I64, _I64, _I64, _I64, _I64, _P),
    # x, hi, lo, n, stream
    "srt_split_bf16x2": (_P, _P, _P, _I64, _P),
    # q, qn, q2, b, f, stream
    "srt_query_prologue": (_P, _P, _P, _I64, _I64, _P),
    # q2, b, f, ft, ft_stride, np, ncols, w, depth, topc, slice, wv, wi, wb,
    # ov, oi, ob, stream
    "srt_scan_v3": (_P, _I64, _I32, _P, _I64, _I64, _I64, _I32, _I32, _I32,
                    _I64, _P, _P, _P, _P, _P, _P, _P),
    # q2, qn, b, f, ft, ft_stride, cn, np, excl, valid, eps, w, topc, slice,
    # wv, wi, wb, ov, oi, ob, stream
    "srt_scan_v2": (_P, _P, _I64, _I32, _P, _I64, _P, _I64, _P, _I64, _F32,
                    _I32, _I32, _I64, _P, _P, _P, _P, _P, _P, _P),
    # q2, qn, b, f, ft, ft_stride, cn, np, ncols, excl, valid, eps, epi, w,
    # depth, slice, wv, wi, wb, ov, oi, ob, stream
    "srt_scan_wide": (_P, _P, _I64, _I32, _P, _I64, _P, _I64, _I64, _P, _I64,
                      _F32, _I32, _I32, _I32, _I64, _P, _P, _P, _P, _P, _P,
                      _P),
    # sv, si, sb, b, w, depth, topc, ov, oi, ob, stream
    "srt_bin_select": (_P, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _P, _P),
})

EXPERIMENTS = Library("experiments", (
    "errors.cu", "mxu_wgmma.cu", "proto_scans.cu", "ablation_r2.cu",
), {
    # q, b, qw, ft, ft_stride, np, slice, part, out, stream
    "srt_mxu_only": (_P, _I64, _I32, _P, _I64, _I64, _I64, _P, _P, _P),
    # q, b, qw, ft, ft_stride, np, w, ov, oi, ob, stream
    "srt_scan_d1": (_P, _I64, _I32, _P, _I64, _I64, _I32, _P, _P, _P, _P),
    # q, b, qw, ft, ft_stride, np, w, slice, wv, wi, wb, ov, oi, ob, stream
    "srt_scan_d1_split": (_P, _I64, _I32, _P, _I64, _I64, _I32, _I64, _P, _P,
                          _P, _P, _P, _P, _P),
    # q, qn, b, qw, ft, ft_stride, cn, np, excl, valid, eps, w, ov, oi, ob,
    # stream
    "srt_proto_scan": (_P, _P, _I64, _I32, _P, _I64, _P, _I64, _P, _I64, _F32,
                       _I32, _P, _P, _P, _P),
    # q, qn, ft, ft_stride, cn, excl, valid, b, f, np, tc, bf16, epi, red,
    # width, eps, out_s, out_i, dmax, dg, stream
    "srt_ablation": (_P, _P, _P, _I64, _P, _P, _I64, _I64, _I32, _I64, _I32,
                     _I32, _I32, _I32, _I32, _F32, _P, _P, _P, _P, _P),
    # f, bf16, epi, red, out (int); out (5 ints)
    "srt_ablation_blocks_per_sm": (_I32, _I32, _I32, _I32, _P),
    "srt_ablation_tiling": (_I32, _I32, _I32, _I32, _P),
})

LIBRARIES = (SERVING, EXPERIMENTS)


def source_hash(lib: Library) -> str:
    h = hashlib.sha256(" ".join((lib.name, *NVCC_FLAGS)).encode())
    for path in sorted([*lib.paths(), *CSRC_DIR.glob("*.cuh")]):
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


def build(lib: Library = SERVING) -> Path:
    """Compile `lib` if this source hash has not been built yet; returns
    the path of the shared library."""
    out_dir = BUILD_ROOT / source_hash(lib)
    so_path = out_dir / lib.file_name
    if so_path.exists():
        return so_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: a concurrent build never
    # sees a half-written library
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in lib.paths()]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                    for src, obj in zip(lib.paths(), objs)])
        so = str(Path(tmp) / lib.file_name)
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]])
        (out_dir / LOG_NAME).write_text(log)
        os.replace(so, so_path)
    return so_path


def _run(cmds: list) -> str:
    """Run the commands at once and wait for all; returns their output
    (ptxas's register and spill report), or raises if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [
        f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}"
        for c, p, out in zip(cmds, procs, outs) if p.returncode != 0
    ]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


@functools.lru_cache(maxsize=None)
def library(lib: Library = SERVING) -> ctypes.CDLL:
    """The loaded library `lib` (built on first call in this process)."""
    dll = ctypes.CDLL(str(build(lib)))
    for name, argtypes in lib.signatures.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    dll.srt_error_string.argtypes = (ctypes.c_int,)
    dll.srt_error_string.restype = ctypes.c_char_p
    return dll


def check(err: int, what: str, lib: Library = SERVING) -> None:
    """Raise when a C entry point of `lib` reports a CUDA error."""
    if err != 0:
        msg = library(lib).srt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err}: {msg}")
