"""The plain reference: float32 PyTorch, imports nothing of the program."""
