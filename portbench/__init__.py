"""The port's benchmark (BENCHMARK.json): cells, traffic, metrics and the
plain reference that decides `correct`."""
