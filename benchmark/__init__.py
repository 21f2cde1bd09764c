"""The port's benchmark: harness, reference, metrics and data."""
