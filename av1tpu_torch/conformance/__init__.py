# Copied from av1tpu/conformance/__init__.py.
"""Independent AV1 conformance codec bound at runtime via ctypes.

The system libaom is bound through its stable public C ABI with
ctypes, and the few struct layouts it needs are self-calibrated.  Its
decoder proves an output is standard AV1 before the daemon's
decode-verify gate replaces the source; its encoder makes known-good
streams that hold the port's spec decoder to libaom in the tests.

Everything degrades gracefully: `aomcodec.available()` is False when
the library is missing.
"""
