"""The benchmark's plain reference: CONCORD in PyTorch, independent of the program."""
