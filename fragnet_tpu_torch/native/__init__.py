"""Native (C++) host runtime for graph construction (counterpart of
fragnet_tpu/native).

Builds ``graphops.cc`` with ``g++ -O3 -shared -fPIC -std=c++17`` on first
use into ``fragnet_tpu_torch/_build/`` (git-ignored), the library named by
a hash of the source, the compiler's version and the C library's, and
loads it with ctypes.
Each build writes a file of its own process and moves it into place, so
concurrent processes (test workers) never load a half-written library.

Where no ``g++`` is on PATH the callers take their pure-Python / numpy
paths (graphs/build.py, ops/tcsr.py), whose outputs are identical. Where
``g++`` exists, a failed build or load raises: it is not taken for a
missing toolchain.

Public API:
  available()                      — True when the library is loaded
  line_graph(src, dst, n_nodes)    — directed share-one-atom line graph
  tile_meta_arrays(...)            — TCSR windows (see ops/tcsr.py)
  CALLS                            — this process's calls of each entry
                                     that ran the library
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "graphops.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

CALLS: Dict[str, int] = {"line_graph": 0, "tile_meta_arrays": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def so_path(cxx: str) -> str:
    """The library's path for compiler ``cxx``: a hash of the source, the
    compiler's version and the C library's in its name (a library built on
    another machine is not loaded)."""
    with open(_SRC, "rb") as f:
        src = f.read()
    version = subprocess.run([cxx, "-dumpfullversion"], capture_output=True,
                             check=True).stdout
    libc = " ".join(platform.libc_ver()).encode()
    tag = hashlib.sha256(src + version + libc).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"graphops-{tag}.so")


def _build_and_load(cxx: str) -> ctypes.CDLL:
    so = so_path(cxx)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run([cxx] + CXX_FLAGS + [_SRC, "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.lg_build.restype = ctypes.c_int64
    lib.lg_build.argtypes = [ctypes.c_int64, i32p, i32p, ctypes.c_int64,
                             ctypes.c_int64, i32p, i32p]
    lib.tile_meta.restype = ctypes.c_int32
    lib.tile_meta.argtypes = [ctypes.c_int64, i32p, i32p, f32p,
                              ctypes.c_int64, ctypes.c_int32,
                              ctypes.c_int32, ctypes.c_int32,
                              ctypes.c_int32, i32p, i32p, i32p, i32p, i32p]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None without ``g++``."""
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                cxx = shutil.which("g++")
                _lib = _build_and_load(cxx) if cxx else None
                _tried = True
    return _lib


def available() -> bool:
    return _get() is not None


def _count(entry: str) -> None:
    with _lock:
        CALLS[entry] += 1


def _edges(src, dst, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) as contiguous int32, checked before the C code indexes
    per-node arrays with them: equal lengths, every id in [0, n_nodes)."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be "
                         f"1-d of one length")
    if src.size and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError(f"an edge endpoint lies outside [0, {n_nodes})")
    return src, dst


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def line_graph(src: np.ndarray, dst: np.ndarray,
               n_nodes: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Directed line graph over edges (share exactly ONE node, set semantics,
    i-major / j-ascending — reference data.py:116-128 ordering). Returns
    (res0, res1) int32 arrays, or None when the native lib is unavailable."""
    lib = _get()
    if lib is None:
        return None
    _count("line_graph")
    src, dst = _edges(src, dst, n_nodes)
    E = len(src)
    if E == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy()
    deg = np.bincount(np.concatenate([src, dst]).astype(np.int64),
                      minlength=n_nodes)
    cap = int((deg[src.astype(np.int64)] + deg[dst.astype(np.int64)]).sum())
    out0 = np.empty(cap, np.int32)
    out1 = np.empty(cap, np.int32)
    n = lib.lg_build(E, _i32p(src), _i32p(dst), n_nodes, cap,
                     _i32p(out0), _i32p(out1))
    if n < 0:  # pragma: no cover — cap is a proven upper bound
        raise RuntimeError("lg_build: output bound exceeded")
    return out0[:n].copy(), out1[:n].copy()


def tile_meta_arrays(src: np.ndarray, dst: np.ndarray, mask: np.ndarray,
                     n_nodes: int, tn: int, te: int,
                     n_chunks: Optional[int], k_src: Optional[int]):
    """Native TCSR window computation (contract in ops/tcsr.py). Returns
    (ew_blk, sw_tile, flat, n_chunks, k_src), "overflow" (a window does not
    fit: the caller leaves the kernel path off) or None (unavailable)."""
    lib = _get()
    if lib is None:
        return None
    _count("tile_meta_arrays")
    src, dst = _edges(src, dst, n_nodes)
    mask = np.ascontiguousarray(mask, np.float32)
    E = len(src)
    if mask.shape != (E,) or n_nodes % tn or E % te:
        raise ValueError(f"mask {mask.shape} for {E} edges, or {n_nodes} "
                         f"nodes / {E} edges not multiples of tn {tn} / te "
                         f"{te}")
    n_tiles = n_nodes // tn
    ew = np.zeros(n_tiles, np.int32)
    sw = np.zeros(n_tiles, np.int32)
    flat = np.zeros(E, np.int32)
    mc = np.zeros(1, np.int32)
    mk = np.zeros(1, np.int32)
    rc = lib.tile_meta(E, _i32p(src), _i32p(dst), _f32p(mask), n_nodes,
                       tn, te, n_chunks or 0, k_src or 0,
                       _i32p(ew), _i32p(sw), _i32p(flat), _i32p(mc),
                       _i32p(mk))
    if rc != 0:
        return "overflow"
    return ew, sw, flat, int(mc[0]) if n_chunks is None else n_chunks, \
        int(mk[0]) if k_src is None else k_src
