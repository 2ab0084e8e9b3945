"""Table SPI backends: ``cuda`` (PyTorch + hand-written CUDA kernels)."""
