"""The LM template stack's dense and SSM families in PyTorch: layers,
attention over the ``flash_attention`` / ``decode_attention`` kernels, the
Mamba-2 mixer over the ``ssd_scan`` kernel, the decoder stack (forward,
prefill, decode step) and the carry of the reference's weights."""
