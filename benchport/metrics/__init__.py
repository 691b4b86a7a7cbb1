"""Per-metric readers, one file a metric named as in BENCHMARK.json:
``read(ctx)`` returns the metric's value, or None where the run gave it
nothing to read (the harness then leaves the metric out). ``_counts``
holds the frozen operation and byte counts and the card's peaks,
``_trace`` the arithmetic on the profiler's events."""
