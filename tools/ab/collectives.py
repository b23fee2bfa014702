#!/usr/bin/env python3
"""Which collectives a ``torch.distributed`` backend takes on CUDA tensors,
for the exchanges of ``gopbrt_tpu_torch/parallel/shard.py`` (the halo
strips and the bands: an all-gather; the reference's ``ppermute``: a
point-to-point pair).

    python3 tools/ab/collectives.py [--backend gloo] [--ranks 2]

On a machine with a card, each probe runs in ``--ranks`` fresh processes
that share ``cuda:0`` over the backend (a ``FileStore`` in a temporary
directory): ``all_gather``, ``all_gather_into_tensor``, ``all_reduce``
and ``batch_isend_irecv`` to the next and previous rank.  Each rank prints
whether the result was right or what the backend raised; a probe whose
ranks do not finish in 60 s is reported and its processes killed.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PROBES = ("all_gather", "all_gather_into_tensor", "all_reduce", "batch_isend_irecv")


def _probe(rank: int, world: int, tmp: str, backend: str, what: str) -> None:
    dist.init_process_group(backend, init_method=f"file://{tmp}/store-{what}", rank=rank,
                            world_size=world)
    t = torch.full((4,), float(rank + 1), device="cuda:0")
    try:
        if what == "all_gather":
            out = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(out, t)
            ok = [float(o[0]) for o in out] == [float(r + 1) for r in range(world)]
        elif what == "all_gather_into_tensor":
            out = torch.empty((world * 4,), device=t.device)
            dist.all_gather_into_tensor(out, t)
            ok = out[::4].tolist() == [float(r + 1) for r in range(world)]
        elif what == "all_reduce":
            dist.all_reduce(t)
            ok = float(t[0]) == world * (world + 1) / 2
        else:
            nxt, prv = (rank + 1) % world, (rank - 1) % world
            got = torch.empty_like(t)
            for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, nxt),
                                                dist.P2POp(dist.irecv, got, prv)]):
                work.wait()
            torch.cuda.synchronize()
            ok = float(got[0]) == float(prv + 1)
        msg = "right" if ok else "wrong result"
    except RuntimeError as e:  # what the backend refuses
        msg = f"raised: {str(e).splitlines()[0][:200]}"
    with open(os.path.join(tmp, f"{what}-{rank}.txt"), "w") as f:
        f.write(msg)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("collectives: no CUDA device")
        return 1
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; backend "
          f"{args.backend}, {args.ranks} ranks on cuda:0", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for what in PROBES:
            ctx = mp.start_processes(_probe, args=(args.ranks, tmp, args.backend, what),
                                     nprocs=args.ranks, join=False, start_method="spawn")
            deadline, note = time.monotonic() + 60, "finished"
            try:
                while not ctx.join(timeout=1):
                    if time.monotonic() > deadline:
                        note = "timed out"
                        break
            except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:
                note = f"a rank died: {e}"
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join(timeout=10)
            res = []
            for r in range(args.ranks):
                path = os.path.join(tmp, f"{what}-{r}.txt")
                res.append(open(path).read() if os.path.exists(path) else "no result")
            print(f"{what} on CUDA tensors: {res} ({note})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
