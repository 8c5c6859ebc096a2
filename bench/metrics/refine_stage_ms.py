"""Stage pipeline (``core/exec.py`` ``FusedDeviceStage`` with its
``_finish`` epilogue): the mean wall of a batch's ``refine`` stage, in ms,
over the measured window's batches."""


def read(rec):
    if not rec.on_card:
        return None
    ms = [sum(s["wall_ms"] for s in b["stages"] if s["stage"] == "refine")
          for b in rec.window
          if any(s["stage"] == "refine" for s in b["stages"])]
    return sum(ms) / len(ms) if ms else None
