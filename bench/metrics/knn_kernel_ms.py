"""Kernels of the kNN path (``kernels/refine.py`` ``refine_compact``, B1;
``kernels/knn.py`` ``knn_topk``, B3): the CUDA-event time of their launches
summed over a batch, the mean over the instrumented stretch's kNN batches,
in ms."""


def read(rec):
    if not rec.on_card:
        return None
    per = {}
    for name in ("refine_compact", "knn_topk"):
        for b, ms in rec.kernel_ms.get(name, {}).items():
            per[b] = per.get(b, 0.0) + ms
    knn = [i for i in rec.stretch
           if any(s["stage"] == "knn-rank" for s in rec.batches[i]["stages"])]
    if not knn or not per:
        return None
    return sum(per.get(i, 0.0) for i in knn) / len(knn)
