"""Scripts that measure the port on the GPU (run as files, not imported)."""
