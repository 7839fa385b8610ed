"""Plain references: PyTorch alone, nothing of the program."""
