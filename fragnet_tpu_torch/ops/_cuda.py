"""Build and load the hand-written CUDA kernels (``fragnet_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds. Libraries go to
``fragnet_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
and are built on first use. ``build_all`` starts one ``nvcc`` per source at
once. One source may export several launchers (a kernel and its
edge-partitioned entry point); each has its own ``CudaKernel`` and launch
count, and they share the library.

Every exported launcher takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; the wrapper
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


# every CudaKernel of the port's own sources, in the order of definition
REGISTRY: List["CudaKernel"] = []
# seconds each source's last nvcc took, by source file name
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


class CudaKernel:
    """One ``csrc/<source>`` library and its exported launcher ``symbol``.

    ``launches`` counts the wrapper's launches of this kernel; callers reset
    it to 0 to count one run. ``csrc`` names another source directory (an
    older version of the kernels, for A/B timing)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 csrc: str = CSRC):
        if csrc == CSRC:
            REGISTRY.append(self)
        self.source = source
        self.csrc = csrc
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def path(self) -> str:
        return os.path.join(self.csrc, self.source)

    def so_path(self) -> str:
        with open(self.path, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"{stem}-{tag}.so")

    def compile_command(self, out: str) -> List[str]:
        return [_nvcc()] + NVCC_FLAGS + ["-o", out, self.path]

    def load(self):
        """Build the library if missing, load it, and return the launcher."""
        with self._lock:
            if self._fn is None:
                so = self.so_path()
                if not os.path.exists(so):
                    _run_builds([self])
                lib = ctypes.CDLL(so)
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, self.symbol + "_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
            return self._fn

    def launch(self, *args) -> None:
        """Call the launcher and count the launch; raise if CUDA refused it."""
        fn = self.load()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1


def _run_builds(kernels: Sequence[CudaKernel]) -> Dict[str, str]:
    """Compile the given kernels' sources concurrently, each library once;
    returns each source's compiler output (ptxas register/spill report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    by_so = {k.so_path(): k for k in kernels}
    t0 = time.perf_counter()
    for so, k in by_so.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        procs.append((k, so, tmp, subprocess.Popen(
            k.compile_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    # each compiler's output drained on its own thread, so that each
    # source's time is its own and not its wait behind the others
    def drain(p):
        return p.communicate()[0], time.perf_counter() - t0

    with ThreadPoolExecutor(len(procs)) as pool:
        outs = list(pool.map(drain, [p for *_, p in procs]))
    logs, failed = {}, []
    for (k, so, tmp, p), (out, sec) in zip(procs, outs):
        logs[k.source], BUILD_SECONDS[k.source] = out, sec
        if p.returncode != 0:
            failed.append(f"{k.source}:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def build_all(kernels: Sequence[CudaKernel],
              force: bool = False) -> Dict[str, str]:
    """Build every kernel whose library is missing (all of them with
    ``force``), one nvcc per source, all started together."""
    todo = [k for k in kernels if force or not os.path.exists(k.so_path())]
    return _run_builds(todo) if todo else {}


def launch_counts() -> Dict[str, int]:
    """Every port kernel's launch count, by launcher symbol."""
    return {k.symbol: k.launches for k in REGISTRY}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device, inner_contiguous: bool = False) -> None:
    """Raise unless ``t`` has the dtype, shape and device a kernel expects
    and is contiguous — or, with ``inner_contiguous``, contiguous in every
    dimension but the first, whose stride the kernel takes as an argument
    (at least the size of one slice)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if inner_contiguous and t.dim() > 0:
        if t.shape[0] and (not t[0].is_contiguous()
                           or t.stride(0) < t[0].numel()):
            raise ValueError(f"{name} has strides {t.stride()}: each slice "
                             f"of the first dimension must be contiguous "
                             f"and apart from the others")
    elif not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_aligned(t: torch.Tensor, name: str, nbytes: int) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (a kernel
    that reads it in float4 needs 16)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} is not {nbytes}-byte aligned")
