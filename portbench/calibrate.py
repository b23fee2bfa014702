"""The readings a cell's check limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

For each seed of ``--seeds``, the program renders frame 0 of the run of
that seed through the cell's client at the cell's own size; for each seed
of ``--control-seeds`` each control (check.CONTROLS: the reference in
bfloat16 between its stages) is read in the program's place, and the
program renders the same frame again with each planted fault
(faults.FAULTS).  Each image is compared with the reference on the rows
that the cell's check compares, drawn from the seed, at each tolerance of
``--tols``.  One JSON line a reading, then one a tolerance: the lower
reading (the largest of the program's), the upper (the least of the
controls'), their ratio, and the least reading of each control and fault.
Needs the card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import check  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402


def readings(cell, seeds, control_seeds, tols, log=print) -> list:
    dev = torch.device("cuda")
    settings = cell.traffic["settings"]
    height = settings["height"]
    rows = min(cell.check["rows"], height)

    def span(seed):
        r0 = random.Random(f"portbench:{seed}").randrange(height - rows + 1)
        return r0, r0 + rows

    # the program's images first, while its state is alive: (kind, seed) -> rows
    frame = harness.connect(cell, dev)
    images = {}
    for seed in seeds:
        r0, r1 = span(seed)
        images["program", seed] = frame(harness.frame_seed(seed, 0)).cpu().numpy()[r0:r1]
    for name in faults.FAULTS:
        with faults.plant(name):
            for seed in control_seeds:
                r0, r1 = span(seed)
                images[name, seed] = frame(harness.frame_seed(seed, 0)).cpu().numpy()[r0:r1]
    del frame
    torch.cuda.empty_cache()

    ref_scene, ref_camera = check.reference_inputs(cell.config, settings, dev)
    out = []
    for seed in dict.fromkeys(seeds + control_seeds):
        t0 = time.perf_counter()
        fs = harness.frame_seed(seed, 0)
        ref = check.reference_rows(ref_scene, ref_camera, settings, fs, span(seed))
        got = {k: img for (k, s), img in images.items() if s == seed}
        if seed in control_seeds:
            for c in check.CONTROLS:
                got[c] = check.reference_rows(ref_scene, ref_camera, settings, fs, span(seed),
                                              lowp=c)
        for kind, img in got.items():
            diff = np.abs(img.astype(np.float64) - ref.astype(np.float64)).max(axis=-1)
            r = {"cell": cell.name, "kind": kind, "seed": seed,
                 "px_off": {str(t): check.px_off(img, ref, t) for t in tols},
                 "diff_q": [float(q) for q in np.quantile(diff, [0.5, 0.9, 0.99, 0.999, 1])],
                 "seconds": time.perf_counter() - t0}
            out.append(r)
            log(json.dumps(r))
    for t in tols:
        prog = [r["px_off"][str(t)] for r in out if r["kind"] == "program"]
        least = {k: min(r["px_off"][str(t)] for r in out if r["kind"] == k)
                 for k in check.CONTROLS + tuple(faults.FAULTS) if control_seeds}
        lower = max(prog) if prog else None
        upper = min(least[k] for k in check.CONTROLS) if least else None
        log(json.dumps({"cell": cell.name, "tol": t, "lower": lower, "upper": upper,
                        "least_by_kind": least,
                        "ratio": upper / lower if lower and upper is not None else None}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--tols", type=float, nargs="*", default=[1e-3, 1e-4, 3e-5, 1e-5, 3e-6])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(manifest, args.workload)
    readings(cell, args.seeds, args.control_seeds, args.tols,
             log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
