"""The host BVH builder: ``bvh_builder.cpp`` compiled with the host ``g++``
and loaded with ctypes.

The source is the port's own copy of the JAX package's builder, compiled
with the same flags (``-O3 -march=native -std=c++17 -pthread``), so both
packages build the same tree from the same bounds.  The library builds at
first use into ``build/gopbrt_tpu_torch/native/<hash of the source>/`` at
the root of the checkout.  Where no C++ compiler is found, ``bvh_build``
returns None and ``ops/bvh.build_from_bounds`` falls back to its NumPy
builder (``backend="auto"``) or raises (``backend="native"``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from gopbrt_tpu_torch._build import BUILD_ROOT

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvh_builder.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]

# gopbrt_bvh_build's n_threads (0: the source picks) and method (0: SAH)
_DEFAULT_THREADS = 0
_METHOD_SAH = 0

_F, _I = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)


def _compile() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / "native" / digest
    lib = out_dir / "libgopbrt_bvh.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, _SRC, "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    return str(lib)


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """The built library, or None where it cannot be compiled or loaded."""
    try:
        lib = ctypes.CDLL(_compile())
    except (OSError, subprocess.CalledProcessError):
        return None
    fn = lib.gopbrt_bvh_build
    fn.restype = ctypes.c_int64
    fn.argtypes = [_F, _F, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int32, _F, _F, _I, _I, _I, _I, _I]
    lib.gopbrt_native_abi_version.restype = ctypes.c_int32
    if lib.gopbrt_native_abi_version() != 1:
        return None
    return lib


def bvh_build(lo: np.ndarray, hi: np.ndarray, max_leaf: int = 4, n_buckets: int = 12):
    """Build a flat binned-SAH BVH natively -> (node_lo, node_hi,
    node_right, node_first, node_count, node_axis, prim_order) NumPy
    arrays, or None where the library is unavailable.  The source's HLBVH
    method and thread count stay at the SAH build and their defaults."""
    lib = load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    if lo.shape != (n, 3) or hi.shape != (n, 3):
        raise ValueError(f"lo and hi must be [n, 3], got {lo.shape} and {hi.shape}")
    cap = 2 * n
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    ints = [np.empty((cap,), np.int32) for _ in range(4)]  # right, first, count, axis
    order = np.empty((n,), np.int32)

    def fp(a):
        return a.ctypes.data_as(_F)

    def ip(a):
        return a.ctypes.data_as(_I)

    n_nodes = lib.gopbrt_bvh_build(fp(lo), fp(hi), n, max_leaf, n_buckets, _DEFAULT_THREADS,
                                   _METHOD_SAH, fp(node_lo), fp(node_hi),
                                   *(ip(a) for a in ints), ip(order))
    if n_nodes <= 0:
        return None
    return (node_lo[:n_nodes].copy(), node_hi[:n_nodes].copy(),
            *(a[:n_nodes].copy() for a in ints), order)
