"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build runs
at first use, not at import, into ``build/torch_kernels/`` at the repository
root (gitignored), under a file name keyed by a hash of the sources and the
flags: an edited source builds anew, an unchanged one is loaded as it is.
Nothing here includes PyTorch's headers, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("relay_mix.cu", "conv2d_nhwc.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# the C entry points of csrc/relay_mix.cu and their arguments:
#   int relay_mix_2d_launch(const void* A, const void* delta, void* out, int n,
#                           long long D, int dtype, void* stream)
#   int fused_aggregate_2d_launch(const void* c, const void* delta, void* out,
#                                 int n, long long D, int dtype, int splits,
#                                 void* partials, void* counters,
#                                 long long counters_len, void* stream)
#   long long fused_aggregate_2d_workspace(long long D, int splits,
#                                          long long* counters)
#   unsigned long long stream_capture_id(void* stream)
# and each kernel's launch plan (launches nothing):
#   int relay_mix_2d_plan(const void* delta, void* out, int n, long long D,
#                         int dtype, int* plan)                  // plan[5]
#   int fused_aggregate_2d_plan(const void* delta, void* out, int n,
#                               long long D, int dtype, int splits,
#                               int* plan)                       // plan[5]
# the C entry points of csrc/conv2d_nhwc.cu (shape: 13 ints, kernels/conv.py):
#   int conv2d_fprop_launch(const void* x, const void* w, void* y,
#                           const int* shape, void* stream)
#   int conv2d_dgrad_launch(const void* dy, const void* w, void* dx,
#                           const int* shape, void* stream)
#   int conv2d_wgrad_launch(const void* x, const void* dy, void* dw,
#                           void* partials, const int* shape, int slab,
#                           int splits, void* stream)
#   int conv2d_plan(int direction, const int* shape, int splits,
#                   int* plan)                                   // plan[5]
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "relay_mix_2d_launch": (_I, [_P, _P, _P, _I, _LL, _I, _P]),
    "fused_aggregate_2d_launch": (_I, [_P, _P, _P, _I, _LL, _I, _I, _P, _P, _LL, _P]),
    "fused_aggregate_2d_workspace": (_LL, [_LL, _I, ctypes.POINTER(_LL)]),
    "stream_capture_id": (ctypes.c_ulonglong, [_P]),
    "relay_mix_2d_plan": (_I, [_P, _P, _I, _LL, _I, ctypes.POINTER(_I)]),
    "fused_aggregate_2d_plan": (_I, [_P, _P, _I, _LL, _I, _I, ctypes.POINTER(_I)]),
    "conv2d_fprop_launch": (_I, [_P, _P, _P, ctypes.POINTER(_I), _P]),
    "conv2d_dgrad_launch": (_I, [_P, _P, _P, ctypes.POINTER(_I), _P]),
    "conv2d_wgrad_launch": (_I, [_P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _P]),
    "conv2d_plan": (_I, [_I, ctypes.POINTER(_I), _I, ctypes.POINTER(_I)]),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library for these sources already existed
    log: str        # nvcc's output (ptxas resource usage with verbose=True)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the kernels are built from csrc/ with the "
            "CUDA toolkit on the machine that has the GPU"
        )
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librelay_kernels-{h.hexdigest()[:16]}.so"


def build(*, verbose: bool = False) -> BuildResult:
    """Compile the sources unless the library for them exists.  ``verbose``
    adds ``-Xptxas -v`` (registers, shared memory and spills per kernel)
    and forces a rebuild so the report is printed."""
    path = _library_path()
    if path.exists() and not verbose:
        return BuildResult(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return BuildResult(path, seconds, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    return bind(ctypes.CDLL(str(build().path)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' types on a loaded kernel library."""
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
