#!/usr/bin/env python3
"""The readings that the limits in ``portbench/checks/<cell>.json`` are set from.

For each seed, in one process per cell (the set-up is long):

- ``program``: the program's job once, through the harness's job, judged by
  the reference as a run judges it (the lower readings);
- ``control``: the reference put in the program's place and computed in
  TF32, the precision below the configurations' float32 (the upper
  readings);
- ``half_batch``: the reference in the program's place with half of the
  rows left out and the others weighted twice (the mean over the rest), a
  planted fault.

A step that returns its state unchanged reads 1 on every coefficient number
and needs no run. Run from the root of a checkout, on the chip:

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

Each reading is printed as one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def half_batch_weights(n: int, seed: int, device):
    """Weights 2 on a seeded half of the rows and 0 on the rest."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    keep = torch.rand((n,), generator=g, device=device) < 0.5
    return keep.to(torch.float32) * 2.0


def readings(bench, name: str, seed: int, device: str = "cuda", scale: float = 1.0,
             kinds=("program", "control", "half_batch")) -> dict:
    """{kind: readings} of cell ``name`` on ``seed``. The cell's job judges
    every kind, so a new configuration or job needs no change here."""
    import torch

    cell = bench.cell(name)
    cfg = bench.load("configs", cell["config"])
    traffic = bench.load("traffic", cell["traffic"])
    os.environ["PHOTON_PALLAS"] = "1" if cfg.get("fused") else "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = importlib.import_module(f"portbench.jobs.{traffic['job']}").Job(
        cfg, traffic, seed, device, scale=scale)
    out = {}
    if "program" in kinds:
        job.unit()  # the warm-up that a run makes before its window
        answer = job.unit()
        job.free_program()
        gc.collect()
        out["program"] = job.readings([answer])[0]
    else:
        job.free_program()
    ref = job.reference("f64")
    if "control" in kinds:
        out["control"] = job.judge(job.answer_of(job.reference("tf32")), ref)
    if "half_batch" in kinds:
        w = half_batch_weights(job.n, seed, torch.device(device))
        out["half_batch"] = job.judge(job.answer_of(job.reference("f64", weights=w)), ref)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--kinds", nargs="+", default=["program", "control", "half_batch"])
    args = parser.parse_args(argv)
    import torch

    from portbench.harness import Bench

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(bench, args.workload, seed, kinds=tuple(args.kinds))
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
