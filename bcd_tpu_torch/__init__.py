"""bcd_tpu_torch: the PyTorch and CUDA port of bcd_tpu."""
