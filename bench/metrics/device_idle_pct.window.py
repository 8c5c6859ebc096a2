"""The device's idle share (``harness/readings.py`` ``device_idle_pct``)
in the window cells, which report ``batch_p95_ms``."""
from bench.harness.readings import device_idle_pct as read  # noqa: F401
