"""bench.py's scan-difference timer: outlier detection with mocked clocks.

A trial that another process slows down must not become the result: the
timer retries trial sets whose spread exceeds 2x. These tests drive
``scan_diff_time`` with a scripted fake clock — no real timing, no
flakiness.
"""

import numpy as np

import bench


class _FakeClock:
    """Clock whose reading advances by scripted amounts per run call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _mk(clock, durations):
    """A run callable consuming scripted durations in order."""
    it = iter(durations)

    def run():
        clock.advance(next(it))

    return run


def test_clean_trials_return_median_no_retry():
    clock = _FakeClock()
    # dispatch overhead 30 ms on every call; per-step cost 10 ms.
    # lo scans 2 steps (50 ms wall), hi scans 6 (90 ms wall).
    run_lo = _mk(clock, [0.050] * 3)
    run_hi = _mk(clock, [0.090] * 3)
    dt, contended = bench.scan_diff_time(run_lo, run_hi, 2, 6, trials=3,
                                         clock=clock)
    assert not contended
    np.testing.assert_allclose(dt, 0.010, rtol=1e-9)  # dispatch cancelled


def test_contaminated_trial_retries_then_clean():
    clock = _FakeClock()
    # First trial set: trial 2's hi call hits a stall (+1 s) -> spread
    # >2x -> retry. Second set is clean.
    run_lo = _mk(clock, [0.050, 0.050, 0.050] + [0.050] * 3)
    run_hi = _mk(clock, [0.090, 1.090, 0.090] + [0.090] * 3)
    dt, contended = bench.scan_diff_time(run_lo, run_hi, 2, 6, trials=3,
                                         retries=2, clock=clock)
    assert contended  # the marker reaches the artifact
    np.testing.assert_allclose(dt, 0.010, rtol=1e-9)


def test_persistent_contention_returns_min_positive():
    clock = _FakeClock()
    # Every trial set noisy: estimates alternate 10 ms / 40 ms per step.
    # After retries exhaust, the MINIMUM positive estimate wins (contention
    # only adds time).
    run_lo = _mk(clock, [0.050] * 9)
    run_hi = _mk(clock, [0.090, 0.210, 0.210] * 3)
    dt, contended = bench.scan_diff_time(run_lo, run_hi, 2, 6, trials=3,
                                         retries=2, clock=clock)
    assert contended
    np.testing.assert_allclose(dt, 0.010, rtol=1e-9)


def test_all_negative_estimates_return_nan():
    clock = _FakeClock()
    # Pathological contention: EVERY trial's lo call is slower than its hi
    # call, so no positive per-step estimate ever exists. The round-4
    # advisor finding: returning max(dts) here (a value <= 0) produced a
    # negative/infinite img/s in the artifact. Must return NaN instead.
    run_lo = _mk(clock, [0.500] * 9)
    run_hi = _mk(clock, [0.090] * 9)
    dt, contended = bench.scan_diff_time(run_lo, run_hi, 2, 6, trials=3,
                                         retries=2, clock=clock)
    assert contended
    assert np.isnan(dt)


def test_negative_estimate_is_rejected():
    clock = _FakeClock()
    # lo contaminated so hi-lo goes negative in one trial; a negative
    # per-step time must never be returned.
    run_lo = _mk(clock, [0.200, 0.050, 0.050] * 3)
    run_hi = _mk(clock, [0.090, 0.090, 0.090] * 3)
    dt, contended = bench.scan_diff_time(run_lo, run_hi, 2, 6, trials=3,
                                         retries=2, clock=clock)
    assert contended
    assert dt > 0
    np.testing.assert_allclose(dt, 0.010, rtol=1e-9)
