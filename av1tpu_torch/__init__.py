"""av1tpu_torch — the spec-AV1 encode path in PyTorch, with CUDA kernels.

A second package beside ``av1tpu``: the same keyframe and P-frame
encoders, written as PyTorch tensor code, with the two Pallas kernels
of the JAX package rewritten by hand in CUDA C++ for Hopper
(``csrc/``).  The framework-free host code it needs (the native C++
tile writer, the header/OBU writer, the numpy spec decoder, the
constant tables, rate control, the config and the test source) is its
own copy of the JAX package's, each file naming its origin; this
package imports neither ``jax`` nor ``av1tpu``.

Layout (JAX counterpart in parentheses):
  device               device choice, numeric flags, kernel build/load
  encoder.kernels      gather (pallas_gather), refine (pallas_motion),
                       motion (motion.search_v3)
  specav1.transforms   spec integer inverse transforms (jax_intra)
  specav1.torch_inter  P-frame encoder (jax_inter)
  specav1.torch_intra  keyframe wavefront encoder (jax_intra)
  engine, spec_engine  host pipeline and SpecTorchEngine (spec_engine)
  config, encoder.ratectrl, utils.testsrc, encoder.entropy (native
  tile writer sources and loader), specav1.{bits, cdfs, msac, obu,
  headers, recon, inter_recon, mvrefs, lr, tile, writer, native,
  decoder}      copies of the JAX package's framework-free modules
"""
