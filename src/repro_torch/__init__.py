"""PyTorch + CUDA port of the GLIN reproduction (``repro``).

``core`` holds the index, the device snapshot and the ``SpatialIndex``
facade; ``kernels`` the hand-written CUDA kernels with their plain torch
versions; ``models`` the LM template stack, ``train``, ``data`` and
``ckpt`` its training. The package imports torch and numpy only.
"""
