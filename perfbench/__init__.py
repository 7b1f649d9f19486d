"""The benchmark of the PyTorch and CUDA port (``tpu_diinn_torch``)."""
