"""The share of the random-effect bucket solves' trips that a CUDA graph
replay served, in percent: ``re.graph_trips`` over ``re.trips`` (every
bucket solve's host syncs), from the program's recorder
(photon_ml_tpu_torch/util/timed.py), which counts only under the profiler:
the traced stretch. 0 where every bucket solve ran eagerly; None where the
recorder lacks the trip counter."""


def read(ctx):
    if ctx.get("config") != "glmix" or ctx.get("trace") is None:
        return None
    from photon_ml_tpu_torch.util import timed

    snapshot = getattr(timed, "snapshot", None)
    if snapshot is None:
        return None
    counters = snapshot()["counters"]
    trips = counters.get("re.trips", 0)
    if not trips:
        return None
    return 100.0 * counters.get("re.graph_trips", 0) / trips
