# Copied from av1tpu/tui/__init__.py.
"""Observability dashboard (ref: internal/tui): job queue + system metrics."""
