"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and no PyTorch headers, so they are
compiled by hand with ``nvcc`` — one ``nvcc -c`` per ``.cu`` source, all
started together, then one link into a shared library — and loaded with
``ctypes``.  Device code shared by two sources lives in a ``.cuh`` header
beside them (hashed with the sources).  The library is built at first use into
``src/repro_torch/_build/<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags, from the package's own sources only.

A second, *checked* library can be built beside it (:func:`checked`):
the ES-scan, dEclat-difference, N-list and flash-attention sources
compiled with ``-DREPRO_CHECKED``, which turns their ``REPRO_CHECK``
lines into device-side asserts on every global index and window bound
(and, in the tensor-core attention, on its mbarrier ring and TMA
boxes), into ``_build/checked-<hash>/``.  Inside ``with checked():``
the wrappers launch from it; a failed assert traps the launch.

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
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"
# The checked build: its extra flags and the sources it compiles.
CHECKED_FLAGS = ("-DREPRO_CHECKED", "-lineinfo")
CHECKED_SOURCES = ("bitmap_diff.cu", "bitmap_intersect.cu",
                   "flash_attention.cu", "flash_attention_fp32.cu",
                   "nlist_merge.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types (every pointer and the stream
# are void*, so ctypes never truncates a 64-bit address).
SIGNATURES = {
    "repro_es_scan": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I,
                      _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "repro_compact_gather": (_P, _P, _P, _L, _L, _L, _P),
    "repro_diff_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                        _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "repro_scan_warps": (_I, _I, _I),
    "repro_nlist_merge": (_P, _L, _P, _P, _P, _P, _P, _L, _L, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P),
    "repro_zmerge_scatter": (_P, _L, _P, _L, _P, _P, _P, _P, _P, _L, _P,
                             _P),
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _F, _I, _I, _I, _P),
    "repro_embedding_bag": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _P),
    "repro_suffix_table": (_P, _P, _L, _I, _I, _P),
    "repro_nlist_set_packed_adv": (_I,),       # the checked build only
}

_locks = {False: threading.Lock(), True: threading.Lock()}
_libs: Dict[bool, ctypes.CDLL] = {}
_use_checked = False
# Seconds the last build of the plain library took (0.0 when it came from
# the cache), and of the checked one.
build_seconds = 0.0
checked_build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def _sources(checked: bool = False):
    if checked:
        return [CSRC_DIR / name for name in CHECKED_SOURCES]
    return sorted(CSRC_DIR.glob("*.cu"))


def _flags(checked: bool):
    return NVCC_FLAGS + CHECKED_FLAGS if checked else NVCC_FLAGS


def _source_hash(checked: bool = False) -> str:
    h = hashlib.sha256(" ".join(_flags(checked)).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):   # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path, checked: bool = False) -> Path:
    """Compile the sources in parallel, link, and move the library into
    ``out_dir`` atomically (a concurrent build at worst duplicates the
    work)."""
    nvcc = _nvcc()
    flags = _flags(checked)
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        objs = []
        for src in _sources(checked):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *flags, "-shared", *objs, "-o",
                               str(lib_tmp)], capture_output=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace")
                               + link.stderr.decode(errors="replace"))
        final = out_dir / LIB_NAME
        os.replace(lib_tmp, final)
    return final


def library_path(checked: bool = False) -> Path:
    """Where the library built from the present sources lives."""
    tag = ("checked-" if checked else "") + _source_hash(checked)
    return BUILD_ROOT / tag / LIB_NAME


def load(checked: "bool | None" = None) -> ctypes.CDLL:
    """The kernels' shared library, built on first use: the checked one
    inside ``with checked():`` (or with ``checked=True``), else the plain
    one.  The two build independently, so two threads may build both at
    once."""
    global build_seconds, checked_build_seconds
    if checked is None:
        checked = _use_checked
    with _locks[checked]:
        if checked in _libs:
            return _libs[checked]
        path = library_path(checked)
        if not path.exists():
            t0 = time.perf_counter()
            path = _build(path.parent, checked)
            if checked:
                checked_build_seconds = time.perf_counter() - t0
            else:
                build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is None:          # an entry the other build carries
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = (_I,)
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[checked] = lib
        return lib


@contextmanager
def checked() -> Iterator[ctypes.CDLL]:
    """Launch the ES-scan, dEclat-difference, N-list and flash-attention
    kernels from the checked library while the block runs (the other
    kernels have no checked build and raise there); yields that
    library."""
    global _use_checked
    lib = load(checked=True)
    _use_checked = True
    try:
        yield lib
    finally:
        _use_checked = False


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launch."""
    if err != 0:
        msg = load(False).repro_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed "
                           f"(cudaError_t {err}: {msg})")
