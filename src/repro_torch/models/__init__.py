"""The LM zoo on PyTorch: configs, layers, the decoder forward and the
loss (port of ``repro.models``; the decoder-only dense and vlm families,
cache-free)."""
