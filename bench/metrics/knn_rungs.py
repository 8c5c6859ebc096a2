"""kNN stage: the mean, over the measured window's batches, of
``StageStats.rungs``, the deepest radius rung any point of the batch
needed."""


def read(rec):
    n = [s["rungs"] for b in rec.window for s in b["stages"]
         if s["stage"] == "knn-rank"]
    return sum(n) / len(n) if n else None
