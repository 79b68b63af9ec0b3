"""One reader a metric, found by the metric's name in BENCHMARK.json.

Each module ``<name>.py`` defines ``read(run) -> float | None``: the
metric's value from the run's record (``portbench.harness.Run``), or None
where the run holds nothing to read it from (then the metric is left out
of the result line).
"""
