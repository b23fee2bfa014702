"""The least time the card could take for a frame's integrator work.

Frozen yardstick: later changes to the program's kernels, trees or plain
code do not move it.

- Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
  67 TFLOP/s of float32 outside the tensor cores, 3.35 TB/s of HBM3
  (``chip_smoke.py:181-182`` of the program's commit d908b8a).
- Operations: the events that the reference's ``path_li_plain`` counts on
  the frame's lanes (its own tables and, on a mesh, its own NumPy SAH
  tree), times ``OPS_PER_EVENT`` of the reference's frozen copy of
  ``ops/megakernel.py`` (``ops/megakernel.py:119-175`` of the program's
  commit d908b8a: the float32 operations a CUDA bounce kernel spends on
  each event).
- Bytes: each path's inputs and output once (``BYTES_PER_PATH``: origin,
  direction, pixel and sample in, radiance out; ``chip_smoke.py:183-184``)
  and each table once a frame: the kernel's packed scene table and, on a
  mesh, the tree's nodes and primitive records.
"""

from __future__ import annotations

from reference.ops import megakernel as ref_mk
from reference.ops import mesh_megakernel as ref_mesh

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
BYTES_PER_PATH = 44
OPS_PER_EVENT = ref_mk.OPS_PER_EVENT


def fp32_ops(counts: dict) -> int:
    """Float32 operations of the events in ``counts``."""
    return sum(OPS_PER_EVENT[k] * v for k, v in counts.items())


def table_bytes(scene, accel: str) -> int:
    """Bytes of the tables a bounce kernel reads, each once: the brute
    sweep's packed scene table, or the mesh table with the tree's nodes and
    primitive records."""
    if accel == "brute":
        return ref_mk.TABLE_WORDS * 4
    bt = scene.bvh_tables
    return (ref_mesh.MESH_TABLE_WORDS + bt.nodes.numel() + bt.records.numel()) * 4


def least_ms(counts: dict, n_paths: int, n_table_bytes: int) -> tuple[float, str]:
    """(least milliseconds on the card, "operations" or "bytes", whichever
    bounds it)."""
    t_ops = fp32_ops(counts) / PEAK_FP32_FLOPS * 1e3
    t_bytes = (n_paths * BYTES_PER_PATH + n_table_bytes) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def share(readings) -> float | None:
    """100 x the least time of a traced frame's integrator work over the
    device ms of the kernels launched inside its ``render.li`` ranges, or
    None where either is missing."""
    li_ms = [f.li_device_ms for f in readings.frames]
    if readings.least_ms is None or not li_ms or min(li_ms) <= 0:
        return None
    return 100.0 * readings.least_ms / (sum(li_ms) / len(li_ms))
