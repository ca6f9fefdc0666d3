# Copied from av1tpu/daemon/__init__.py.
"""Job orchestration and the scan pass (ref: internal/daemon, cmd/av1d)."""
