"""The facade's own time (``harness/readings.py`` ``facade_ms``) in the
window cells, which report ``batch_p95_ms``."""
from bench.harness.readings import facade_ms as read  # noqa: F401
