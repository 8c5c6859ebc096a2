"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
measures (the stores, the traffic, the plain reference, the byte counts,
the peaks, the comparison that decides ``correct``) lives under this
folder; the program under test is only what ``src/repro_torch`` gives.
"""
