"""Engine of the PyTorch port: fused tile pipeline, monoscale, multiscale, pipeline."""
