"""One-off measurements that define the benchmark's numbers: the readings
that the limits of ``correct`` are set from."""
