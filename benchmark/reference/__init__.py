"""Plain references of what each cell's timed path produces: NumPy and
plain PyTorch, importing nothing of the program."""
