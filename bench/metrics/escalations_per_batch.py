"""Overflow ladder (``core/exec.py`` ``OverflowLadder``): the mean, over the
measured window's batches, of the refine stage's
``StageStats.escalations``."""


def read(rec):
    n = [sum(s["escalations"] for s in b["stages"] if s["stage"] == "refine")
         for b in rec.window
         if any(s["stage"] == "refine" for s in b["stages"])]
    return sum(n) / len(n) if n else None
