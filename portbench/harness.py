"""One run of one benchmark cell.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic. The harness finds everything else by name:

- ``portbench/configs/<config>.json``: the configuration's sizes, its
  ``generator`` (``portbench/gen/<generator>.py``) and its ``reference``
  (``portbench/reference/<reference>.py``);
- ``portbench/traffic/<traffic>.json``: the job, by its ``job``
  (``portbench/jobs/<job>.py``), and the job's parameters;
- ``portbench/checks/<cell>.json``: the limit of each number compared;
- ``portbench/metrics/<metric>.py``: the reader of each per-layer metric.

A run: set-up (the job's data, the program's dataset and kernels, one
warm-up job), a window of whole jobs for ``--seconds``, with ``--trace 1``
one more stretch of jobs under the profiler, then the check of every answer
against the reference once the program's state is freed, and the result as
the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")


class Bench:
    """The benchmark's files under one checkout root."""

    def __init__(self, root: Path = BENCH.parent):
        self.root = Path(root)
        self.dir = self.root / BENCH.name
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def load(self, kind: str, name: str) -> dict:
        with open(self.dir / kind / f"{name}.json") as f:
            return json.load(f)

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics that list the cell under ``workloads``
        (every entry has the key)."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", scale: float = 1.0, t_start: float | None = None,
             log=print) -> tuple[dict, list]:
    """(result, check lines) of one run of cell ``name``. ``scale`` shrinks
    the configuration's totals (tests on the CPU)."""
    import torch

    from portbench import peaks, program, trace

    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(name)
    cfg = bench.load("configs", cell["config"])
    traffic = bench.load("traffic", cell["traffic"])
    limits = bench.load("checks", name)
    os.environ["PHOTON_PALLAS"] = "1" if cfg.get("fused") else "0"
    # the configurations state float32: no TF32 in any product
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    card = peaks.card() if cuda else {"name": "cpu", "power_limit_w": None}
    log(f"card: {card['name']} at {card['power_limit_w']} W; cell {name}, seed {seed}, "
        f"{seconds} s, trace {int(trace_on)}")

    job_cls = importlib.import_module(f"portbench.jobs.{traffic['job']}").Job
    job = job_cls(cfg, traffic, seed, device, scale=scale)
    t = time.perf_counter()
    job.unit()  # warm-up: every shape of the window, nothing kept
    job.stages["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("set-up by stage: " + ", ".join(f"{k} {v:.3f} s" for k, v in job.stages.items())
        + f"; setup_s {setup_s:.3f}")

    before = program.counters()
    outputs, ends = [], []
    w0 = time.perf_counter()
    while True:
        outputs.append(job.unit())
        ends.append(time.perf_counter() - w0)
        if ends[-1] >= seconds:
            break
    wall = ends[-1]
    counts = program.delta(before, program.counters())
    per_unit = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    each = (" ".join(f"{u:.4f}" for u in per_unit) if len(per_unit) <= 20
            else f"{min(per_unit):.4f} to {max(per_unit):.4f}")
    log(f"window: {len(outputs)} units in {wall:.4f} s (each {each} s); counters {counts}")

    summary, trace_counts, extra = None, None, []
    if trace_on:
        before = program.counters()
        t = time.perf_counter()
        extra, summary = trace.traced(
            lambda: [job.unit() for _ in range(int(traffic["traced_units"]))])
        trace_counts = program.delta(before, program.counters())
        log(f"traced: {len(extra)} units, busy {summary['busy_s']:.4f} of "
            f"{summary['window_s']:.4f} s ({wall / len(outputs) * len(extra):.4f} s untraced), "
            f"{time.perf_counter() - t:.3f} s with the reduction; counters {trace_counts}")
        for kname, (c, s) in sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:12]:
            log(f"traced kernel: {c} x {kname[:160]}: {s:.6f} s")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    e2e = job.end_to_end(len(outputs), wall)
    e2e["setup_s"] = setup_s
    ctx = job.layer_context(outputs, counts, wall)
    # the traced units' length untraced: the window's mean unit, as every unit
    # does the same work (the profiler slows the host loop it records)
    ctx.update(trace=summary, trace_counts=trace_counts, card=card,
               untraced_s=wall / len(outputs) * len(extra))
    metrics = {}
    if trace_on:
        for m in bench.per_layer(name):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the check: the program's state freed, the reference in its place
    answers = outputs + extra
    job.free_program()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings = job.readings(answers)
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s over {len(readings)} answers")
    failed = sum(1 for r in readings
                 if not all(math.isfinite(r[k]) and r[k] <= lim for k, lim in limits.items()))
    worst = {k: max(r[k] for r in readings) for k in readings[0]}
    for k, v in worst.items():
        if k not in limits:
            log(f"reading (not compared): {k} {v!r}")
    checks = {k: {"value": worst[k], "limit": lim} for k, lim in limits.items()}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": card["name"], "count": 1,
                   "memory_peak_bytes": peak}
    result = {"correct": bool(readings) and failed == 0, "attempted": len(readings),
              "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check: {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def main(argv=None, t_start: float | None = None) -> int:
    parser = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    import torch

    bench = Bench()
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result, lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=t_start, log=log)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
