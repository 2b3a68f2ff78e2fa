"""Port utils/chained_timing.py (the JAX package's
tests/test_chained_timing.py): a long run no slower than the short one is
an invalid sample (None), never clamped to an absurd rate."""

import numpy as np

import incremental_multimodal_medical_learning_ii_torch.utils.chained_timing as ct
from incremental_multimodal_medical_learning_ii_torch.utils.chained_timing import rate_or_none


def test_time_chained_measures_positive_difference(monkeypatch):
    t = {"now": 0.0}
    monkeypatch.setattr(ct.time, "perf_counter", lambda: t["now"])

    def factory(k):
        def loop():
            t["now"] += 0.01 * k  # each iteration costs 10 ms
            return np.zeros(())
        return loop

    per = ct.time_chained(factory, lambda r: (), k_short=2, k_long=8, repeats=1)
    assert per is not None
    np.testing.assert_allclose(per, 0.01, rtol=1e-6)
    assert rate_or_none(per, 100.0) == 100.0 / per


def test_time_chained_invalid_when_long_not_slower(monkeypatch):
    t = {"now": 0.0}
    monkeypatch.setattr(ct.time, "perf_counter", lambda: t["now"])
    costs = {2: 5.0, 8: 0.5}  # the short run hit a slow phase

    def factory(k):
        def loop():
            t["now"] += costs[k]
            return np.zeros(())
        return loop

    assert ct.time_chained(factory, lambda r: (), k_short=2, k_long=8, repeats=1) is None
    assert rate_or_none(None, 100.0) is None
