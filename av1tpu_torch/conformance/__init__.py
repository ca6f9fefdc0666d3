# Copied from av1tpu/conformance/__init__.py (the decoder half only).
"""Independent AV1 conformance decoder bound at runtime via ctypes.

The system libaom is bound through its stable public C ABI with
ctypes, and the few struct layouts it needs are self-calibrated.  The
daemon's decode-verify gate uses its decoder to prove an output is
standard AV1 before the source is replaced.

Everything degrades gracefully: `aomcodec.available()` is False when
the library is missing.
"""
