"""The general part of the benchmark: specification, stores, traffic, the
cell runner, kernel timing and trace reading, byte counts and peaks. What
belongs to one configuration, mix or per-layer metric sits in its own file
under ``configs/``, ``traffic/`` and ``metrics/``, and the code a file
names by a word of its own under ``families/``, ``centres/`` and
``drivers/``."""
