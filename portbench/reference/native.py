"""The reference has no native BVH builder: ``bvh_build`` returns None, so
``ops/bvh.build_timed`` builds every tree with its NumPy binned SAH."""

from __future__ import annotations

METHODS = {"sah": 0, "hlbvh": 1}


def bvh_build(lo, hi, max_leaf: int = 4, n_buckets: int = 12, method: str = "sah"):
    return None
