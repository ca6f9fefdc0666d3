# Copied from av1tpu/tools/__init__.py.
"""Operator CLI tools: clip encode, quality measurement, diagnostics."""
