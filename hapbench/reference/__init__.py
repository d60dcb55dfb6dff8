"""The plain float32 reference the benchmark holds the program's output to.
It imports nothing of the program."""
