"""``engine/protocols.py``: a joint run's wall less its ``fused-joint-run``
call (the Trainer's construction, the data's upload, the per-epoch logging
and metrics, the final save), ms a run."""


def read(run):
    runs = run.spans.named("joint_run")
    fused = run.spans.named("fused-joint-run")
    if not runs or len(fused) != len(runs):
        return None
    return (sum(b - a for _, a, b in runs) - sum(b - a for _, a, b in fused)) / len(runs) / 1e6
