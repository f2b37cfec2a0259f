"""The plain float32 reference the benchmark compares the program with."""
