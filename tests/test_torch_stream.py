"""PyTorch port (av1tpu_torch) vs the JAX package: the keyframe encoder
and whole streams through the engine.

The keyframe test calls the JAX encoder with exactly the arguments the
JAX engine passes at 128x128, so the engine test reuses its compiled
program.  Tolerances: every block must agree (99% of 16 blocks admits
no disagreeing block, so each of the keyframe's 19 outputs is held
exactly, one test case each), the streams are expected to be
byte-identical, and the required bounds are
bits per pixel within 1% and Y-PSNR within 0.05 dB; the port's stream
must decode in the in-repo spec decoder to the port's own recon.  The
deblocked keyframe reuses the same JAX result: the JAX loop filter is
applied to it as the JAX keyframe encoder's own tail does.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.config import TpuEncoderConfig
from av1tpu.specav1 import decoder, jax_intra
from av1tpu.specav1 import loopfilter as jlf
from av1tpu.utils import testsrc
from av1tpu_torch import config as port_config
from av1tpu_torch.spec_engine import SpecTorchEngine
from av1tpu_torch.specav1 import torch_intra

torch.set_num_threads(1)
W, H = 128, 128
CFG = dict(chunk=1, golden=False, cdef=False, lr=False)


def grainy_frame(i, rng):
    """testsrc2 + seeded luma grain (noise floor > 1: deblocking off)."""
    f = testsrc.testsrc2(W, H, i)
    y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape), 0,
                255).astype(np.uint8)
    return testsrc.Frame(y=y, u=f.u, v=f.v)


@functools.lru_cache(maxsize=None)
def _jax_key():
    """(frame, the JAX keyframe encoder's 19 outputs, filters off)."""
    f = grainy_frame(0, np.random.default_rng(2))
    want = jax_intra._encode_frame(
        jnp.asarray(f.y), jnp.asarray(f.u), jnp.asarray(f.v), jnp.int32(96),
        nbr=4, nbc=4, bit_depth=8, th=H, tw=W, tile_row_starts=(),
        lf_y=jnp.int32(0), lf_uv=jnp.int32(0), deblock=False, qround=0.70,
        cdef=False, cdef_damping=jnp.int32(4), lr=False)
    return f, [np.asarray(a) for a in want]


def _port_key(f, **kw):
    got = torch_intra.encode_frame(torch.from_numpy(f.y),
                                   torch.from_numpy(f.u),
                                   torch.from_numpy(f.v), 96, 4, 4, 8,
                                   th=H, tw=W, **kw)
    return [t.numpy() for t in got]


# the 19 outputs of jax_intra._encode_frame, in order
KEY_OUTPUTS = ("rec_y", "rec_u", "rec_v", "lv_y", "lv_u", "lv_v", "mode",
               "uv_mode", "skip", "angle", "split", "mode16", "uv_mode16",
               "angle16", "split16", "strip_skip", "cdefs", "lr_choice",
               "lr_taps")


@functools.lru_cache(maxsize=None)
def _port_key_plain():
    return _port_key(_jax_key()[0])


@pytest.mark.parametrize("i", range(len(KEY_OUTPUTS)), ids=KEY_OUTPUTS)
def test_key_frame_matches_jax(i):
    """Keyframe wavefront with split16, output by output: recon and
    levels, modes, angles, uv modes, skips, splits and the 16x16
    sub-decisions, strip, CDEF and LR outputs."""
    want = _jax_key()[1]
    got = _port_key_plain()
    assert len(got) == len(want) == len(KEY_OUTPUTS)
    assert got[i].shape == want[i].shape
    np.testing.assert_array_equal(got[i], want[i])


def test_key_frame_deblock_matches_jax():
    """deblock=True filters only the returned recon: the JAX loop filter
    on the JAX keyframe's unfiltered planes and split grid (what its
    own tail computes) equals the port's filtered output, and every
    decision and level stays what the unfiltered encode gave."""
    f, want = _jax_key()
    lfy, lfuv = 9, 7
    filt = jlf.deblock_frame(*(jnp.asarray(want[i]) for i in range(3)),
                             jnp.int32(lfy), jnp.int32(lfuv),
                             jnp.int32(lfuv), 8, H, W,
                             split=jnp.asarray(want[10]), strip=False)
    got = _port_key(f, lf_y=lfy, lf_uv=lfuv, deblock=True)
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(filt[i]))
    assert (got[0] != want[0]).sum() > 50, "the filter did nothing"
    assert want[10].any(), "no split block: the masked passes never ran"
    for i in range(3, 19):
        np.testing.assert_array_equal(got[i], want[i])


class _Recording(SpecTorchEngine):
    """SpecTorchEngine that keeps each frame's reconstruction."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.recons = []

    def _submit(self, *a, **k):
        pend = super()._submit(*a, **k)
        self.recons.append(self._ref)
        return pend


def _y_psnr(frames, decoded):
    mse = np.mean([np.mean((f.y.astype(np.float64) - d[0]) ** 2)
                   for f, d in zip(frames, decoded)])
    return 10 * np.log10(255.0 ** 2 / mse)


def test_engine_stream_matches_jax_engine():
    """3-frame grainy clip through both engines' encode_stream."""
    from av1tpu.spec_engine import SpecTpuEngine
    rng = np.random.default_rng(4)
    frames = [grainy_frame(i, rng) for i in range(3)]
    jout = list(SpecTpuEngine(TpuEncoderConfig(**CFG)).encode_stream(
        frames, 96))
    port = _Recording(port_config.TpuEncoderConfig(**CFG), device="cpu")
    tout = list(port.encode_stream(frames, 96))
    assert [k for _, k in tout] == [k for _, k in jout] == \
        [True, False, False]
    jbits = sum(8 * len(p) for p, _ in jout)
    tbits = sum(8 * len(p) for p, _ in tout)
    assert abs(tbits - jbits) <= 0.01 * jbits
    jdec = decoder.decode_stream([p for p, _ in jout])
    tdec = decoder.decode_stream([p for p, _ in tout])
    assert len(tdec) == 3
    assert abs(_y_psnr(frames, tdec) - _y_psnr(frames, jdec)) <= 0.05
    for d, r in zip(tdec, port.recons):
        for pl in range(3):
            hh, ww = d[pl].shape
            np.testing.assert_array_equal(np.asarray(d[pl], np.int64),
                                          r[pl][:hh, :ww])
    # expected: the same bytes (every decision agrees)
    assert [p for p, _ in tout] == [p for p, _ in jout]


def _base_qindexes(payloads):
    """Each frame header's base_q_idx, in stream order."""
    from av1tpu_torch.specav1 import headers, obu
    seq, qs = None, []
    for p in payloads:
        for o in obu.parse_obus(p):
            if o.type == obu.OBU_SEQUENCE_HEADER:
                seq = headers.parse_sequence_header(o.payload)
            elif o.type == obu.OBU_FRAME:
                qs.append(headers.parse_frame_header(o.payload,
                                                     seq).base_q_idx)
    return qs


def test_encode_next_matches_jax_engine_and_encode_stream():
    """One frame a dispatch: the port's encode_next gives the JAX
    engine's encode_next bytes on the 3-frame grainy clip (the key and
    P-frame programs that the stream test compiles), and, at the
    qindexes that encode_stream chose per frame (its keyframe boost,
    read from its frame headers), the port's own encode_stream bytes."""
    from av1tpu.spec_engine import SpecTpuEngine
    rng = np.random.default_rng(4)
    frames = [grainy_frame(i, rng) for i in range(3)]
    jeng = SpecTpuEngine(TpuEncoderConfig(**CFG))
    jeng.start_stream()
    jout = [jeng.encode_next(f, 96) for f in frames]
    pcfg = port_config.TpuEncoderConfig(**CFG)
    port = SpecTorchEngine(pcfg, device="cpu")
    port.start_stream()
    tout = [port.encode_next(f, 96) for f in frames]
    assert [k for _, k in tout] == [True, False, False]
    assert tout == jout
    stream = list(SpecTorchEngine(pcfg, device="cpu").encode_stream(frames,
                                                                    96))
    qs = _base_qindexes(p for p, _ in stream)
    assert qs[0] < 96 and len(qs) == 3
    port.start_stream()
    assert [port.encode_next(f, q) for f, q in zip(frames, qs)] == stream
