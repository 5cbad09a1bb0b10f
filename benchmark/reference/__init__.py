"""The benchmark's plain reference: stock PyTorch, float32, imports nothing
of the program."""
