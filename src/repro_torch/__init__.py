"""PyTorch + CUDA port of the GLIN reproduction (``repro``).

``core`` holds the index, the device snapshot and the ``SpatialIndex``
facade; ``kernels`` the hand-written CUDA kernels of the refine stage with
their plain torch versions. The package imports torch and numpy only.
"""
