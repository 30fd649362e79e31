"""Debug and observability surface of the session: the decode step trace,
taps, per-chunk snapshots, the NaN guard, stage markers and the profiler
capture, each switched on by a ``RuntimeConfig`` field."""
