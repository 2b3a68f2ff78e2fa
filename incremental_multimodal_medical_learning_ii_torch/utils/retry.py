"""Retry-with-exponential-backoff for device dispatches (a copy of the JAX
package's ``utils/retry.py::retry_call``).

Backend errors carry no reliable transient-vs-deterministic flag, so the
policy retries any exception a bounded number of times: a deterministic
error costs ``retries`` extra attempts and then surfaces unchanged.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


def retry_call(
    fn: Callable[[], T],
    retries: int,
    backoff_s: float,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> T:
    """Run ``fn``; on exception retry up to ``retries`` times, sleeping
    ``backoff_s * 2**attempt`` between attempts.  ``on_retry(attempt, exc)``
    runs before each sleep."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - backend errors are opaque
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2 ** attempt))
    raise AssertionError("unreachable")
