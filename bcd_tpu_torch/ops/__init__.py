"""Ops of the PyTorch port: plain tensor code and the K1, K2, K4 kernel wrappers."""
