"""Extraction host: the time to queue one batch's upload and forward, ms a
batch (``extract_embeddings(stats=)``'s ``dispatch_s``)."""


def read(run):
    b = run.counters.get("batches")
    return 1e3 * run.counters["dispatch_s"] / b if b else None
