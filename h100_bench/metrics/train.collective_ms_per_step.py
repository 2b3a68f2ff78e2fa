"""``parallel/mesh.py``: the device time of NCCL's kernels on rank 0's card
(the step's one flat ``all_reduce`` and ``gather_rows`` after each eval
batch), ms per training step of the traced runs."""

from h100_bench.common.trace import device_time_s


def read(run):
    if run.chips < 2:
        return None
    t, n = device_time_s(run.kernels, lambda name: "nccl" in name.lower())
    runs = run.counters.get("traced_runs")
    if not n or not runs:
        return None
    p = run.params
    steps = runs * p["epochs"] * -(-p["rows"][0] // p["batch"])
    return 1e3 * t / steps
