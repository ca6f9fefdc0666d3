"""Frozen copies of the sources and arithmetic the benchmark measures with."""
