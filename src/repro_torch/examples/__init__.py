"""The port's GLIN examples, each the counterpart of the repository's
``examples/`` script of the same name: ``quickstart``, ``serve_queries``
and ``distributed_glin``. Run one as ``PYTHONPATH=src python -m
repro_torch.examples.<name>`` (on the card; ``--device cpu`` for the
kernels' plain versions on the CPU)."""
