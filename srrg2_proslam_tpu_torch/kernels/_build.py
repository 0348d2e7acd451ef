"""Build the CUDA sources in ``csrc/`` into one shared library and load it.

The library is compiled at first use with ``nvcc`` for ``sm_90a`` (Hopper)
into ``srrg2_proslam_tpu_torch/build/`` (git-ignored), named by a hash of
the sources, one ``nvcc -c`` per source, all started together, then linked
once, and bound with ``ctypes``: every entry point has a plain C
interface taking device pointers, sizes and the CUDA stream, and returns
``cudaGetLastError()`` after its launch.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argument types (pointers, then sizes/scalars, then stream)
_SIGNATURES = {
    "fast_scores_launch": [_P, _P, _I, _I, _I, _F, _P],
    "brief_descriptors_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gn_burst_stereo_launch": [_P, _P, _P, _P, _P, _P, _I, _I,
                               _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
}

_lib = None
build_seconds = None   # wall time of the last compile (None: not built here)
build_log = ""         # nvcc's output of that compile (-Xptxas -v)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC")


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first if needed."""
    global _lib
    if _lib is None:
        _lib = build()
    return _lib


def build(extra_flags: tuple = (), csrc: Path = CSRC) -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` with ``NVCC_FLAGS`` + ``extra_flags`` (unless a
    library of the same sources and flags is already built) and load it."""
    flags = NVCC_FLAGS + list(extra_flags)
    sources = sorted(Path(csrc).glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(Path(csrc).glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    so = BUILD_DIR / f"libproslam_kernels_{digest.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # processes building the same library (ranks of one host) take turns:
    # the first builds it, the others find it built
    with open(BUILD_DIR / f"{so.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile(sources, flags, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _compile(sources: list, flags: list, so: Path) -> None:
    global build_seconds, build_log
    objdir = BUILD_DIR / f"{so.stem}.{os.getpid()}.o"
    objdir.mkdir(parents=True, exist_ok=True)
    tmp = objdir / so.name
    objs = [objdir / f"{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    build_log = "".join(proc.communicate()[0] for proc in procs)
    if any(proc.returncode != 0 for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    shutil.rmtree(objdir)
    build_seconds = time.perf_counter() - t0


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
