"""The plain reference the benchmark holds the program against: plain
PyTorch and NumPy, importing nothing of the program."""
