"""``engine/trainer.py``: the wall time of one ``fused-joint-run`` call (all
epochs and their evals, queued and read back), ms a run; a span the
benchmark records around ``Trainer.train_joint_run``."""


def read(run):
    spans = run.spans.named("fused-joint-run")
    if not spans:
        return None
    return sum(b - a for _, a, b in spans) / len(spans) / 1e6
