"""The LM template stack's dense family in PyTorch: layers, attention over
the ``flash_attention`` / ``decode_attention`` kernels, the decoder stack
(forward, prefill, decode step) and the carry of the reference's weights."""
