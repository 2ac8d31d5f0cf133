"""The plain reference of the link and the decode: NumPy and plain
PyTorch, importing nothing of the program and nothing of the harness."""
