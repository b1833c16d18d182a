"""ctypes bindings for the native CSV tokenizer (native/csv_parser.cpp).

The hot host-side loop of preprocessing, per-row tokenize + validate, is
string work; the reference runs it under OpenMP (reference
DataManager.cpp:164-253).  This port of the JAX package's binding builds
the repository's `native/csv_parser.cpp`, where it stands, with g++ at its
first use in a process:

    g++ -O3 -std=c++17 -fPIC -Wall -Wextra -pthread -shared \\
        native/csv_parser.cpp -o <build dir>/libsrt_csv.so

(`native/Makefile`'s flags; its target lies inside the JAX package, so the
port builds its own copy).  The library goes into
`spotify_recommender_tpu_torch/_build/<hash of compiler, flags and
source>/`, as the CUDA libraries do (ops/cuda/_build.py): an edited source
rebuilds, and a file lock lets one of several processes that start at once
build while the others wait for its result.

Unlike the JAX package, which falls back to the Python parse when the
library is absent, a failed build or load raises with the compiler's
message: `csv_ingest.ingest_csv(use_native=False)` is the Python path.
`csv_ingest.parse_csv_rows` is the behavioral oracle the parse is tested
against (tests/test_torch_native_ingest.py).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from spotify_recommender_tpu_torch.data.csv_ingest import RawTable

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "csv_parser.cpp"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libsrt_csv.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")


def source_hash() -> str:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build(root: Path = BUILD_ROOT) -> Path:
    """Compile the parser into `root` if this source hash has not been
    built there yet; returns the shared library's path.  Raises
    RuntimeError with the compiler's output when g++ is missing or
    fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"native csv parser source not found: {SOURCE}")
    out_dir = Path(root) / source_hash()
    so_path = out_dir / LIB_NAME
    if so_path.exists():
        return so_path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the native csv parser needs it "
                           "(or ingest with use_native=False)")
    out_dir.mkdir(parents=True, exist_ok=True)
    # one build at a time; the lock dies with its process
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so_path.exists():          # built while this process waited
            return so_path
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            so = Path(tmp) / LIB_NAME
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(so)],
                capture_output=True, text=True,
            )
            (out_dir / "g++.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the native csv parser failed "
                    f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(so, so_path)
    return so_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded parser library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    lib.srt_parse_csv.restype = ctypes.c_void_p
    lib.srt_parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int32]
    lib.srt_free.restype = None
    lib.srt_free.argtypes = [ctypes.c_void_p]
    lib.srt_error.restype = ctypes.c_char_p
    lib.srt_error.argtypes = [ctypes.c_void_p]
    for name in ("srt_num_input", "srt_num_valid", "srt_num_genres"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.srt_features.restype = ctypes.POINTER(ctypes.c_float)
    lib.srt_features.argtypes = [ctypes.c_void_p]
    lib.srt_genre_ids.restype = ctypes.POINTER(ctypes.c_int32)
    lib.srt_genre_ids.argtypes = [ctypes.c_void_p]
    for field in ("id", "name", "artist", "genre"):
        arena = getattr(lib, f"srt_{field}_arena")
        arena.restype = ctypes.POINTER(ctypes.c_char)
        arena.argtypes = [ctypes.c_void_p]
        offs = getattr(lib, f"srt_{field}_offs")
        offs.restype = ctypes.POINTER(ctypes.c_int64)
        offs.argtypes = [ctypes.c_void_p]
    return lib


def _strings(lib, handle, field: str, n: int) -> List[str]:
    offs = np.ctypeslib.as_array(
        getattr(lib, f"srt_{field}_offs")(handle), shape=(n + 1,)
    )
    total = int(offs[n])
    arena = ctypes.string_at(getattr(lib, f"srt_{field}_arena")(handle), total)
    return [
        arena[offs[i]:offs[i + 1]].decode("utf-8", errors="replace")
        for i in range(n)
    ]


def _env_threads() -> int:
    """Thread count from the environment (0 = library auto-detect).

    Honors OMP_NUM_THREADS for parity with the reference's OpenMP
    preprocessing (reference README.md:233-237), with SRT_NUM_THREADS
    taking precedence as the framework-specific override."""
    for var in ("SRT_NUM_THREADS", "OMP_NUM_THREADS"):
        val = os.environ.get(var, "").strip()
        if val:
            try:
                return max(0, int(val))
            except ValueError:
                pass
    return 0


def parse_csv_buffer(data: bytes, num_threads: Optional[int] = None) -> RawTable:
    """Parse raw CSV bytes with the native library -> RawTable.

    num_threads None = SRT_NUM_THREADS / OMP_NUM_THREADS from the
    environment (reference parity), else auto-detect."""
    lib = library()
    if num_threads is None:
        num_threads = _env_threads()
    handle = lib.srt_parse_csv(data, len(data), num_threads)
    try:
        err = lib.srt_error(handle)
        if err:
            raise ValueError(err.decode())
        n = int(lib.srt_num_valid(handle))
        ng = int(lib.srt_num_genres(handle))
        feats = (
            np.ctypeslib.as_array(lib.srt_features(handle), shape=(n, 11)).copy()
            if n
            else np.zeros((0, 11), np.float32)
        )
        gids = (
            np.ctypeslib.as_array(lib.srt_genre_ids(handle), shape=(n,)).copy()
            if n
            else np.zeros(0, np.int32)
        )
        return RawTable(
            track_ids=np.asarray(_strings(lib, handle, "id", n), dtype=object),
            track_names=np.asarray(_strings(lib, handle, "name", n),
                                   dtype=object),
            artists=np.asarray(_strings(lib, handle, "artist", n), dtype=object),
            raw_features=feats.astype(np.float32),
            genre_ids=gids.astype(np.int32),
            genre_names=_strings(lib, handle, "genre", ng),
            num_input_rows=int(lib.srt_num_input(handle)),
            num_valid_rows=n,
        )
    finally:
        lib.srt_free(handle)


def parse_csv_rows_native(header_line: str,
                          data_lines: Sequence[str]) -> RawTable:
    """`csv_ingest.parse_csv_rows`'s signature, parsed natively."""
    buf = header_line.rstrip("\n") + "\n" + "\n".join(data_lines)
    return parse_csv_buffer(buf.encode("utf-8"))
