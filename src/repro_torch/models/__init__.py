"""The LM zoo on PyTorch: configs, layers, the Mamba2 SSM, the model
assembly of every family (decoders, MoE, vlm, SSM, hybrid, Whisper's
encoder-decoder), the loss and the serve path (port of
``repro.models``)."""
