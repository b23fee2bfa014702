"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, from the package's own sources, into
``build/gopbrt_tpu_torch/<hash of the sources>/`` at the root of the
checkout; a source edit changes the hash and rebuilds.  Sources build in
parallel, one ``nvcc`` each.  A failed build raises.

Every launch goes through ``launch``, on an ``Entry`` that the kernel's
wrapper under ``ops/`` declares beside the arguments it passes: its
library, symbol, ``LAUNCHES`` key and ctypes signature.  ``check_rays`` is
what the wrappers of kernels #1-#5 ask of their rays.
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
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "gopbrt_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# flags of one source beyond NVCC_FLAGS, by library (source stem)
SOURCE_FLAGS = {
    # no fused multiply-adds: every product and sum rounds on its own, as
    # the plain version's PyTorch operations round them
    "camera_rays": ["-fmad=false"],
    "splat_rows": ["-fmad=false"],
}

# Launches of the CUDA kernels, by kernel name ("megakernel", "intersect",
# "intersect_any", "bvh_intersect", "bvh_intersect_any", "mesh_megakernel",
# "camera_rays", "splat_rows"); a name not in portbench's KERNEL_SYMBOL is a
# substring of its kernel's device symbol (camera_rays_kernel,
# splat_rows_kernel).
# ``launch`` adds one a launch and nothing else does; callers reset it with
# LAUNCHES.clear().
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
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
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(src.stem, []), "-o", str(tmp),
               str(src)]
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
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (a source stem)."""
    return ctypes.CDLL(build()[name]["path"])


class Entry(NamedTuple):
    """A kernel's C entry point: its library (source stem), its symbol, its
    key in LAUNCHES, and the ctypes types of the arguments it takes before
    the stream (``args``) and after it (``after``).  Each entry returns its
    cudaError_t."""

    lib: str
    symbol: str
    key: str
    args: tuple
    after: tuple = ()


@functools.lru_cache(maxsize=None)
def _function(entry: Entry):
    fn = getattr(load(entry.lib), entry.symbol)
    fn.argtypes = [*entry.args, ctypes.c_void_p, *entry.after]
    fn.restype = ctypes.c_int
    return fn


def launch(entry: Entry, device, args: tuple, *after) -> None:
    """Runs ``entry`` on ``device``'s current stream: ``args``, the stream,
    then ``after``.  Raises on a nonzero cudaError_t; counts one launch in
    ``LAUNCHES[entry.key]``."""
    err = _function(entry)(*args, torch.cuda.current_stream(device).cuda_stream, *after)
    if err != 0:
        raise RuntimeError(f"{entry.key} launch failed: cudaError_t {err}")
    LAUNCHES[entry.key] += 1


def launch_lanes(entry: Entry, device, n: int, args: tuple, *dtypes) -> tuple:
    """Outputs of ``n`` lanes, one fresh [n] tensor of each of ``dtypes`` on
    ``device``, filled by a launch of ``entry`` with ``args`` then their
    pointers; no launch where ``n`` is 0."""
    outs = tuple(torch.empty((n,), dtype=t, device=device) for t in dtypes)
    if n:
        launch(entry, device, (*args, *(x.data_ptr() for x in outs)))
    return outs


def check_rays(o, d, t_max=None, *, device, card: bool, out=None, bvh=None,
               animated=False) -> None:
    """What the wrappers of kernels #1-#5 ask of their rays: o and d float32
    [N, 3] (and t_max float32 [N]) on ``device``, the device of the tables
    they read, which are not ``animated``.  ``card``: also what a launch
    asks: the rays on a card and contiguous, ``out`` float32 [N, 3] beside
    them and contiguous, and the BVH table ``bvh``'s nodes 64-byte and
    records 16-byte aligned."""
    if animated:
        raise ValueError("the intersection kernels take no animated table: its moving prims "
                         "need each lane's transform (the plain versions at the lanes' times)")
    lanes = (o, d) if t_max is None else (o, d, t_max)
    names = "o and d" if t_max is None else "o, d and t_max"
    if any(x.dtype != torch.float32 for x in lanes):
        raise TypeError(f"{names} must be float32")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape or (
            t_max is not None and t_max.shape != o.shape[:1]):
        raise ValueError(f"o and d must be [N, 3] (t_max [N]), got "
                         f"{[tuple(x.shape) for x in lanes]}")
    if any(x.device != device for x in lanes):
        raise ValueError(f"{names} must lie on the tables' device {device}")
    if not card:
        return
    if o.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {o.device}")
    if out is not None:
        if out.shape != o.shape or out.dtype != torch.float32 or out.device != o.device:
            raise ValueError("out must be float32 [N, 3] on the rays' device")
        lanes += (out,)
    if not all(x.is_contiguous() for x in lanes):
        raise ValueError("the rays and the output must be contiguous")
    if bvh is not None and (bvh.nodes.data_ptr() % 64 or bvh.records.data_ptr() % 16):
        raise ValueError("the BVH nodes must be 64-byte and the records 16-byte aligned "
                         "(bvh_table packs them so)")
