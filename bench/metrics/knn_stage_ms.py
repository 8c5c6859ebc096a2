"""kNN stage (``core/exec.py`` ``KnnDeviceStage``): the mean wall of a
batch's ``knn-rank`` stage, in ms, over the measured window's
batches."""


def read(rec):
    if not rec.on_card:
        return None
    ms = [s["wall_ms"] for b in rec.window for s in b["stages"]
          if s["stage"] == "knn-rank"]
    return sum(ms) / len(ms) if ms else None
