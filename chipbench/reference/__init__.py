"""The frozen plain reference: NumPy and Python only, importing nothing of the
program."""
