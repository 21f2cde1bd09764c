"""The benchmark's harness: traffic, window, trace reduction, work
counts and the check."""
