"""Plain references that decide ``correct``: plain PyTorch and numpy,
importing nothing of the program under test."""
