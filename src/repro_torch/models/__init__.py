"""The LM template stack's dense, SSM and hybrid families in PyTorch:
layers, attention over the ``flash_attention`` / ``decode_attention``
kernels, the Mamba-2 mixer over the ``ssd_scan`` kernel, the decoder stack
(forward, prefill, decode step; the hybrid's parallel attention and SSM
mixers and meta tokens) and the carry of the reference's weights."""
