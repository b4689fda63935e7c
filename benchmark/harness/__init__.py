"""The harness: a cell's files by name, its inputs from the seed, the
training window, the trace, the comparison with the reference, and the
planted faults."""
