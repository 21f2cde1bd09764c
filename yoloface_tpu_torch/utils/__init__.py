"""Utilities of the port: the environment verifier."""
