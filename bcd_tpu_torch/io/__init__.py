"""EXR I/O of the port: the codec and the image adapters."""
