"""Extraction host: the loop's wait for the prefetch thread's next batch,
ms a batch (``extract_embeddings(stats=)``'s ``feed_wait_s``)."""


def read(run):
    b = run.counters.get("batches")
    return 1e3 * run.counters["feed_wait_s"] / b if b else None
