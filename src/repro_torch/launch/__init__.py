"""Launchers: ``python -m repro_torch.launch.serve ...`` (spatial and LM
serving) and ``python -m repro_torch.launch.train ...`` (training)."""
