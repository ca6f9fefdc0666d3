"""av1tpu_torch — the spec-AV1 encode path in PyTorch, with CUDA kernels.

A second package beside ``av1tpu``: the same keyframe and P-frame
encoders, written as PyTorch tensor code, with the two Pallas kernels
of the JAX package rewritten by hand in CUDA C++ for Hopper
(``csrc/``).  Framework-free host code (the native tile writer, the
header/OBU writer, the numpy spec decoder, the shared constant tables,
rate control and the config) is imported from ``av1tpu``; this package
never imports ``jax``.

Layout (JAX counterpart in parentheses):
  device               device choice, numeric flags, kernel build/load
  encoder.kernels      gather (pallas_gather), refine (pallas_motion),
                       motion (motion.search_v3)
  specav1.transforms   spec integer inverse transforms (jax_intra)
  specav1.torch_inter  P-frame encoder (jax_inter)
  specav1.torch_intra  keyframe wavefront encoder (jax_intra)
  engine, spec_engine  host pipeline and SpecTorchEngine (spec_engine)
"""
