"""The facade's own time (``harness/readings.py`` ``facade_ms``) in the
kNN cells, which report ``query_rate``."""
from bench.harness.readings import facade_ms as read  # noqa: F401
