"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and no PyTorch headers, so they are
compiled by hand with ``nvcc`` — one ``nvcc -c`` per source, all started
together, then one link into a shared library — and loaded with
``ctypes``.  The library is built at first use into
``src/repro_torch/_build/<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags, from the package's own sources only.

Nothing here runs at import time: the CPU tests import every module of
the package on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points and their argument types (every pointer and the stream
# are void*, so ctypes never truncates a 64-bit address).
SIGNATURES = {
    "repro_es_scan": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "repro_compact_gather": (_P, _P, _P, _L, _L, _L, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Seconds the last build took (0.0 when the library came from the cache).
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every source in parallel, link, and move the library into
    ``out_dir`` atomically (a concurrent build at worst duplicates the
    work)."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                               str(lib_tmp)], capture_output=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace")
                               + link.stderr.decode(errors="replace"))
        final = out_dir / LIB_NAME
        os.replace(lib_tmp, final)
    return final


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = BUILD_ROOT / _source_hash() / LIB_NAME
        if not path.exists():
            t0 = time.perf_counter()
            path = _build(path.parent)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = (_I,)
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launch."""
    if err != 0:
        msg = load().repro_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed "
                           f"(cudaError_t {err}: {msg})")
