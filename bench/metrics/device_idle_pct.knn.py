"""The device's idle share (``harness/readings.py`` ``device_idle_pct``)
in the kNN cells, which report ``query_rate``."""
from bench.harness.readings import device_idle_pct as read  # noqa: F401
