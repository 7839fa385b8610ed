"""The device trace of a window, reduced to what the metrics read.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` with the CUDA activity
alone: the card's kernels, copies and sets, and the CUDA runtime calls that
launched them. Host operators are not recorded, since recording each one
slows the host loop and so lengthens the window that the idle share is
taken over. The profiler's events are read in memory. The reduction:

- device operations are the events on the CUDA device; ``busy_s`` is the
  length of the union of their intervals, ``window_s`` the traced window's
  length by the host clock around ``fn`` (which ends in a synchronize);
- ``kernels`` sums each device operation's seconds and count by name;
- ``idle_gaps`` names each gap between device operations by the innermost
  CUDA runtime call running at its middle (``host`` where none runs: the
  host is computing what to launch next) and sums the gaps by that name.
"""

from __future__ import annotations

import bisect
import time


def traced(fn) -> tuple[object, dict]:
    """(fn(), summary) with ``fn`` run under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return out, summarize(_spans(prof), window_s)


def _spans(prof) -> list:
    """(on the device, start s, duration s, name) of every profiler event."""
    from torch.autograd import DeviceType

    spans = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue  # an annotation's range on the device timeline, no work
        spans.append((on_device, e.start_ns() * 1e-9, e.duration_ns() * 1e-9, e.name()))
    return spans


def summarize(spans: list, window_s: float) -> dict:
    """The reduction of the trace's (on the device, start, duration, name)
    spans (see module doc)."""
    device, host = [], []
    for on_device, start, dur, name in spans:
        (device if on_device else host).append((start, dur, name))
    device.sort()
    kernels: dict = {}
    for _, dur, name in device:
        acc = kernels.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += dur
    busy, gaps, end = 0.0, [], None
    for start, dur, _ in device:
        stop = start + dur
        if end is None:
            busy, end = dur, stop
        elif start > end:
            gaps.append((end, start))
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    host.sort()
    starts = [s for s, _, _ in host]
    reach, last = [], float("-inf")  # reach[j]: the latest end among host[:j + 1]
    for s, dur, _ in host:
        last = max(last, s + dur)
        reach.append(last)
    by_name: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "host"
        j = bisect.bisect_right(starts, mid) - 1
        if j >= 0 and reach[j] >= mid:
            # the innermost host call that covers the middle: the latest
            # start among those still running there
            while host[j][0] + host[j][1] < mid:
                j -= 1
            name = host[j][2]
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top_ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "kernels": kernels,
            "device_ops": [[n, s] for n, s in top_ops], "idle_gaps": [[n, s] for n, s in top_gaps]}


def kernel_seconds(summary: dict, match) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name ``match`` accepts."""
    count, secs = 0, 0.0
    for name, (c, s) in summary["kernels"].items():
        if match(name):
            count += c
            secs += s
    return count, secs
