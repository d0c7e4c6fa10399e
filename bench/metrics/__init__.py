"""Metric readers, one file a metric, named as the metric is in
``BENCHMARK.json``: ``read(run)`` returns the value, or None when the
run holds nothing to read it from (the metric is then left out)."""
