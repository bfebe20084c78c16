"""The plain reference the benchmark holds the port to (`model`), in
PyTorch operations alone; it imports nothing of the port."""
