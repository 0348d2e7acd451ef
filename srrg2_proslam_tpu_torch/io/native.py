"""ctypes bindings of the native image decoder and in-order prefetcher.

Port of srrg2_proslam_tpu/io/native.py.  The library is the repo's own C++
(``native/src/image_decode.cpp`` and ``prefetcher.cpp``: a PNG (zlib) and
PGM/PPM decoder and a threaded prefetcher that decodes a file list in
order a few files ahead).  It is compiled at first use with
``g++ -O3 -shared -fPIC ... -lz -pthread`` (a compiler process per
source, all started together, under a file lock) into the git-ignored
``srrg2_proslam_tpu_torch/build/``, named by a hash of the sources and
flags; nothing is written into ``native/``.  A failed build raises with
the compiler's output: there is no silent fallback.  ``datasets.decode_plain``
is the plain Python decoder the native one is held to.  Files this library
does not read (JPEG, palette, 1/2/4-bit and interlaced PNG, BMP) go to the
port's second image library, ``io/images.py``, as the JAX package sends
them to PIL; ``compile_library`` builds both.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..kernels._build import BUILD_DIR

SOURCES = [Path(__file__).resolve().parents[2] / "native" / "src" / name
           for name in ("image_decode.cpp", "prefetcher.cpp")]
# no floating-point contraction: the float decoders (JPEG 2000's 9/7 wavelet)
# round each operation as their numpy twins and PIL's libraries do
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
LIBS = ["-lz", "-pthread"]

_lib = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler for the native IO library: set CXX or install g++")
    return cxx


def compile_library(stem: str, sources: List[Path], libs: List[str],
                    headers: Sequence[Path] = ()) -> Path:
    """Compile ``sources`` into ``BUILD_DIR/<stem>_<hash>.so`` unless a
    library of the same sources, ``headers`` and flags exists; returns its
    path.  One process builds it under a file lock while the others wait,
    each source by its own compiler process, all started together.  Raises
    with the compiler's output on failure."""
    digest = hashlib.sha256()
    for src in [*sources, *headers]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS + libs).encode())
    so = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{so.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            work = Path(tempfile.mkdtemp(prefix=f"{so.stem}.", dir=BUILD_DIR))
            try:
                objects = [work / f"{i}.o" for i in range(len(sources))]
                procs = [subprocess.Popen([_cxx(), *CXX_FLAGS, "-c", "-o", str(obj), str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
                         for obj, src in zip(objects, sources)]
                outputs = [proc.communicate()[0] for proc in procs]
                failed = any(proc.returncode for proc in procs)
                if not failed:
                    link = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(work / "lib.so"),
                                           *map(str, objects), *libs],
                                          capture_output=True, text=True)
                    outputs.append(link.stdout + link.stderr)
                    failed = link.returncode != 0
                if failed:
                    raise RuntimeError(f"building {stem} failed:\n" + "".join(outputs))
                os.replace(work / "lib.so", so)
            finally:
                shutil.rmtree(work, ignore_errors=True)
    return so


def build() -> Path:
    """Compile the native IO library unless it exists; returns its path."""
    return compile_library("libproslam_io", SOURCES, LIBS)


def library() -> ctypes.CDLL:
    """The loaded native library, compiling it first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ints = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.psl_decode_file.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.psl_decode_file.argtypes = [ctypes.c_char_p] + ints
        lib.psl_free.argtypes = [ctypes.c_void_p]
        lib.psl_prefetch_create.restype = ctypes.c_void_p
        lib.psl_prefetch_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int]
        lib.psl_prefetch_next.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.psl_prefetch_next.argtypes = [ctypes.c_void_p] + ints
        lib.psl_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _to_array(ptr, w: int, h: int, channels: int, bitdepth: int, lib) -> np.ndarray:
    dtype = np.uint16 if bitdepth == 16 else np.uint8
    count = w * h * channels * np.dtype(dtype).itemsize
    buf = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * count)).contents
    arr = np.frombuffer(buf, dtype=dtype).reshape(h, w, channels).copy()
    lib.psl_free(ptr)
    return arr[:, :, 0] if channels == 1 else arr


def try_decode(path: str) -> Optional[np.ndarray]:
    """One file -> its samples, or None when the native decoder does not
    read it (the JAX package's ``native.decode``)."""
    lib = library()
    w, h, c, d = (ctypes.c_int() for _ in range(4))
    ptr = lib.psl_decode_file(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                              ctypes.byref(c), ctypes.byref(d))
    if not ptr:
        return None
    return _to_array(ptr, w.value, h.value, c.value, d.value, lib)


def decode(path: str) -> np.ndarray:
    """One PNG/PGM/PPM file -> its samples, [H, W] or [H, W, C] uint8/uint16."""
    arr = try_decode(path)
    if arr is None:
        raise ValueError(f"native decoder cannot read {path} (PNG, PGM and PPM only)")
    return arr


def to_gray_f32(arr: np.ndarray) -> np.ndarray:
    """Decoded samples -> float32 gray 0..255: colour as 0.299 R + 0.587 G +
    0.114 B in float64, 16-bit samples / 256 (by dtype, not by data)."""
    scale_16 = arr.dtype == np.uint16
    if arr.ndim == 3:
        if arr.shape[2] >= 3:
            arr = 0.299 * arr[:, :, 0] + 0.587 * arr[:, :, 1] + 0.114 * arr[:, :, 2]
        else:
            arr = arr[:, :, 0]
    arr = np.asarray(arr, np.float32)
    if scale_16:
        arr = arr / 256.0
    return np.ascontiguousarray(arr)


class Prefetcher:
    """In-order decoder over a list of files: ``n_threads`` native threads
    keep up to ``window`` files decoded ahead of the consumer."""

    def __init__(self, paths: List[str], n_threads: int = 4, window: int = 8):
        self._lib = library()
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.psl_prefetch_create(arr, len(self._paths), n_threads, window)
        self._consumed = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def next_or_none(self) -> Optional[np.ndarray]:
        """The next file's samples, or None when the native decoder does not
        read it; StopIteration past the last file."""
        if self._consumed >= len(self._paths):
            raise StopIteration
        w, h, c, d = (ctypes.c_int() for _ in range(4))
        ptr = self._lib.psl_prefetch_next(self._handle, ctypes.byref(w), ctypes.byref(h),
                                          ctypes.byref(c), ctypes.byref(d))
        self._consumed += 1
        if not ptr:
            return None
        return _to_array(ptr, w.value, h.value, c.value, d.value, self._lib)

    def __next__(self) -> np.ndarray:
        arr = self.next_or_none()
        if arr is None:
            raise ValueError("native decoder cannot read "
                             f"{os.fsdecode(self._paths[self._consumed - 1])}")
        return arr

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.psl_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
