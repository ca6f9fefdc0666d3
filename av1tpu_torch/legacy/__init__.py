"""The private av1tpu bitstream profile (``tpu.bitstream: "av1tpu"``) on
PyTorch: a port of ``av1tpu/legacy/`` and of the device half of
``av1tpu/engine_tpu.py``.

The daemon's default is the standard-AV1 ``SpecTorchEngine``; this
profile is the JAX package's retired round-1 engine, kept so that the
port does everything the JAX package does.  ``engine.LegacyTorchEngine``
encodes it on a card or on the CPU, ``decoder`` decodes it, and
``entropy_tile`` binds its native tile codec (``native/tile.cc``).
"""
