"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, from the package's own sources, into
``build/gopbrt_tpu_torch/<hash of the sources>/`` at the root of the
checkout; a source edit changes the hash and rebuilds.  Sources build in
parallel, one ``nvcc`` each.  A failed build raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "gopbrt_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launches of the CUDA kernels, by kernel name ("megakernel", "intersect",
# "intersect_any", "bvh_intersect", "bvh_intersect_any", "mesh_megakernel").
# Each wrapper adds one where it launches its kernel and nowhere else;
# callers reset it with LAUNCHES.clear().
LAUNCHES: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
# ctypes signature of each library's entry points, by library (source stem).
# The bounce kernels, on persistent lanes (csrc/lanes.cuh), take one int of
# device memory for their path counter after the stream, then an int flag:
# nonzero for the counting instance, which fills the three ints after the
# path counter.
_SIGNATURES = {
    "megakernel": {
        "gopbrt_path_li":
            [_P] * 5 + [_I, _P, _I, _I, _I, ctypes.c_uint]
            + [ctypes.c_float] * 4 + [_I, _I, ctypes.c_float, _I, _P, _P, _I],
    },
    "intersect": {
        # o, d, t_max, n, rec, n_prims, dead_d2, instance, flags, outputs,
        # stream
        "gopbrt_intersect": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P],
        "gopbrt_intersect_any": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _P],
    },
    "bvh_intersect": {
        # o, d, t_max, n, nodes, records, (prim_order,) flags, outputs, stream
        "gopbrt_bvh_intersect": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P],
        "gopbrt_bvh_intersect_any": [_P, _P, _P, _I, _P, _P, _I, _P, _P],
    },
    "mesh_megakernel": {
        # o, d, pixel, sample, L, n, tables, table_words, nodes, records,
        # bvh_flags, n_mats, n_lights, seed, func_int, world_radius, cone_w0,
        # cone_sp, max_depth, rr_start, rr_threshold, flags, stream, counter,
        # count
        "gopbrt_mesh_li":
            [_P] * 5 + [_I, _P, _I, _P, _P, _I, _I, _I, ctypes.c_uint]
            + [ctypes.c_float] * 4 + [_I, _I, ctypes.c_float, _I, _P, _P, _I],
    },
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every kernel source that is not built yet.

    Returns {name: {"path", "seconds", "log"}}; ``seconds`` is 0.0 and
    ``log`` empty for a library that was already built.
    """
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, info = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        info[src.stem] = {"path": str(lib), "seconds": 0.0, "log": ""}
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        info[name].update(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, lib)
    return info


# what the counting instance of a bounce kernel counts, in the ints after
# its path counter (csrc/bounce.cuh run_paths)
STATS = ("paths", "steps", "warp_slots")


def counter(device) -> torch.Tensor:
    """The work counter of a launch on persistent lanes, int32 on the card,
    which the C entry zeroes on the stream before the launch: the path
    counter, then the counting instance's STATS."""
    return torch.empty((1 + len(STATS),), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def load(name: str = "megakernel") -> ctypes.CDLL:
    """The built library ``name`` with its entry points' ctypes signatures."""
    lib = ctypes.CDLL(build()[name]["path"])
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
