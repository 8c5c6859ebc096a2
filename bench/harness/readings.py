"""Readings that per-layer metrics of more than one name share: a metric
whose cells report different end-to-end metrics is split into one name for
each (``<quantity>.<cells>``), and each name's reader is this function."""


def facade_ms(rec):
    """Facade (``core/engine.py`` ``SpatialIndex.query``: planning, the lock,
    the ``QueryResult``): the mean, over the measured window's batches, of a
    batch's wall less the walls of its stages
    (``QueryResult.stages[*].wall_ms``), in ms."""
    if not rec.on_card:
        return None
    own = [b["wall_ms"] - sum(s["wall_ms"] for s in b["stages"])
           for b in rec.window if b["stages"]]
    return sum(own) / len(own) if own else None


def device_idle_pct(rec):
    """Device (the card): 100 less the busy share of the traced stretch, from
    ``torch.profiler``'s device operations (their union). Where the trace
    lacks launches that the timed wrappers saw, their mean event time is
    added to the busy time."""
    p = rec.profile
    if not rec.on_card or not p or p["window_s"] <= 0:
        return None
    busy = p["busy_s"]
    stretch = set(rec.stretch)
    for name, lost in p.get("missing", {}).items():
        if lost:
            ms = [v for b, v in rec.kernel_ms.get(name, {}).items()
                  if b in stretch]
            calls = max(rec.kernel_calls_in(name, stretch), 1)
            busy += lost * sum(ms) * 1e-3 / calls
    return 100.0 * max(0.0, 1.0 - busy / p["window_s"])
