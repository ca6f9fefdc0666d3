"""PyTorch port (av1tpu_torch) vs the JAX package: a grainy GOP through
both engines in the daemon's default config apart from chunking.

``TpuEncoderConfig(chunk=1)``: golden, CDEF and LR on; the grain keeps
the GOP's deblocking decision off, so CDEF and LR run on the unfiltered
reconstruction (what a daemon job on a grainy rip runs).  A key + 2 P of
seeded ``testsrc2`` grain at 128x144 (16-px strip geometry) through
``SpecTpuEngine`` and ``SpecTorchEngine``: the same CDEF strengths and
LR choices, the same recons and the same bytes, frame by frame; the
port's decoder, the JAX package's and libaom must each reproduce the
port's reconstruction.

The file holds few test items on purpose: its JAX programs (a keyframe
and a P-frame with CDEF and LR) take most of its time, and the test
scheduler starts files with few items last, beside the suite's longest
files, instead of before them.
"""

import functools

import numpy as np
import pytest
import torch

from av1tpu.config import TpuEncoderConfig
from av1tpu.conformance import aomcodec
from av1tpu.spec_engine import SpecTpuEngine
from av1tpu.specav1 import decoder as j_decoder
from av1tpu_torch import config as port_config
from av1tpu_torch.spec_engine import SpecTorchEngine
from av1tpu_torch.specav1 import decoder
from av1tpu_torch.utils import testsrc

torch.set_num_threads(1)
W, H = 128, 144


def _frames():
    rng = np.random.default_rng(5)
    out = []
    for i in range(3):
        f = testsrc.testsrc2(W, H, i)
        y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                    0, 255).astype(np.uint8)
        out.append(testsrc.Frame(y=y, u=f.u, v=f.v))
    return out


def _encode(eng, frames):
    """(payloads, recons, CDEF strengths, LR choices, engine)."""
    eng.start_stream()
    payloads, recons, cdefs, lrs = [], [], [], []
    for i, f in enumerate(frames):
        pend = eng._submit(f, 96, is_key=(i == 0))
        out = pend[11]
        cdefs.append(np.asarray(out[16 if i == 0 else 9]).tolist())
        lrs.append(np.asarray(out[17 if i == 0 else 10]).tolist())
        recons.append(eng._ref)
        payloads.append(bytes(eng._finalize(pend)[0]))
    return payloads, recons, cdefs, lrs, eng


@functools.lru_cache(maxsize=None)
def _gop():
    frames = _frames()
    return {"jax": _encode(SpecTpuEngine(TpuEncoderConfig(chunk=1)), frames),
            "port": _encode(SpecTorchEngine(
                port_config.TpuEncoderConfig(chunk=1), device="cpu"),
                frames)}


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_grainy_default_gop_matches_jax_engine(frame):
    """Frame by frame: CDEF strengths, LR choices, recon planes, bytes."""
    jp, jr, jc, jl, je = _gop()["jax"]
    tp, tr, tc, tl, te = _gop()["port"]
    assert te._cdef and te._lr and te._golden and not te._gop_deblock
    assert not je._gop_deblock
    assert tc[frame] == jc[frame] and tl[frame] == jl[frame]
    for pl in range(3):
        np.testing.assert_array_equal(np.asarray(jr[frame][pl]),
                                      tr[frame][pl])
    assert tp[frame] == jp[frame], (len(tp[frame]), len(jp[frame]))


def test_grainy_default_gop_decodes_to_port_recon():
    """The port's decoder, the JAX package's and libaom on the port's
    stream, whose filters turned on: CDEF in some frame, LR in every
    frame."""
    payloads, recons, cdefs, lrs, _ = _gop()["port"]
    assert any(map(any, cdefs)), cdefs
    assert all(max(c) >= 0 for c in lrs), lrs
    for dec in (decoder, j_decoder, aomcodec):
        frames_dec = dec.decode_stream(payloads)
        assert len(frames_dec) == 3
        for d, r in zip(frames_dec, recons):
            for pl in range(3):
                hh, ww = d[pl].shape
                np.testing.assert_array_equal(np.asarray(d[pl], np.int64),
                                              r[pl][:hh, :ww])
