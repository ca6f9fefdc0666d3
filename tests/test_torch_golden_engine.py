"""PyTorch port (av1tpu_torch) vs the JAX package: a two-reference GOP
through both engines in the daemon's default in-loop filter chain.

A "flash" GOP of clean 128x144 frames with the frame types pinned: key
A, inter B (another scene), inter A again.  The source is clean and
144 % 32 == 16 with 128 % 16 == 0, so the GOP's deblocking decision is
on over the 16-px strip geometry, and CDEF and LR run after it (the
engines' defaults apart from chunking): the chain deblock -> CDEF -> LR,
with the strip rows in CDEF's skip grid.  LAST (B's recon) is useless
for the third frame while GOLDEN (A's filtered recon) is nearly it.
The port's bytes must equal ``SpecTpuEngine``'s; the port's decoder,
the JAX package's and libaom must each reproduce the port's
reconstruction.  A clean drift through both engines in the default
config at ``chunk=2`` (key, a chunk of 2 through the packed upload, a
remainder) gives the same bytes too; it reuses this file's keyframe and
P-frame programs, so its one new JAX program is the chunk program.
"""

import functools

import numpy as np
import pytest
import torch

from av1tpu.conformance import aomcodec
from av1tpu.config import TpuEncoderConfig
from av1tpu.spec_engine import SpecTpuEngine
from av1tpu.specav1 import decoder as j_decoder
from av1tpu_torch import config as port_config
from av1tpu_torch.spec_engine import SpecTorchEngine
from av1tpu_torch.specav1 import decoder
from av1tpu_torch.utils.cleansrc import clean_frame

torch.set_num_threads(1)
W, H = 128, 144


def _encode(eng, frames):
    """(payloads, recons, GOLDEN blocks per inter frame, engine, CDEF
    strengths per frame)."""
    eng.start_stream()
    payloads, recons, n_gold, cdefs = [], [], [], []
    for i, f in enumerate(frames):
        pend = eng._submit(f, 96, is_key=(i == 0))
        recons.append(eng._ref)
        if i:
            n_gold.append(int(np.asarray(pend[11][14]).sum()))
        cdefs.append(np.asarray(pend[11][16 if i == 0 else 9]).tolist())
        payloads.append(bytes(eng._finalize(pend)[0]))
    return payloads, recons, n_gold, eng, cdefs


@functools.lru_cache(maxsize=None)
def _gop():
    """{(engine, golden): _encode(...)} of the flash GOP, encoded once."""
    frames = [clean_frame(W, H, 0, 0), clean_frame(W, H, 5, 1),
              clean_frame(W, H, 1, 0)]
    out = {}
    for golden in (True, False):
        cfg = dict(chunk=1, golden=golden)
        out["jax", golden] = _encode(SpecTpuEngine(TpuEncoderConfig(**cfg)),
                                     frames)
        out["port", golden] = _encode(
            SpecTorchEngine(port_config.TpuEncoderConfig(**cfg),
                            device="cpu"), frames)
    return out


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("golden", [True, False])
def test_deblock_gop_matches_jax_engine(golden, frame):
    """Frame by frame: the same GOLDEN choices, the same CDEF strengths,
    the same filtered recons, the same bytes."""
    jp, jr, jg, je, jc = _gop()["jax", golden]
    tp, tr, tg, te, tc = _gop()["port", golden]
    assert je._gop_deblock and te._gop_deblock
    assert te._cdef and te._lr and je._cdef and je._lr
    assert len(tp) == len(jp) == 3 and len(tg) == len(jg) == 2
    assert tc[frame] == jc[frame]
    if frame:
        assert tg[frame - 1] == jg[frame - 1]
    for pl in range(3):
        np.testing.assert_array_equal(np.asarray(jr[frame][pl]),
                                      tr[frame][pl])
    assert tp[frame] == jp[frame], (len(tp[frame]), len(jp[frame]))


@functools.lru_cache(maxsize=None)
def _decoded(dec):
    return dec.decode_stream(_gop()["port", True][0])


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("dec", [decoder, j_decoder, aomcodec],
                         ids=["port-decoder", "jax-package-decoder",
                              "libaom"])
def test_golden_deblock_gop_decodes_to_port_recon(dec, frame):
    recons = _gop()["port", True][1]
    frames_dec = _decoded(dec)
    assert len(frames_dec) == 3
    d, r = frames_dec[frame], recons[frame]
    for pl in range(3):
        hh, ww = d[pl].shape
        np.testing.assert_array_equal(np.asarray(d[pl], np.int64),
                                      r[pl][:hh, :ww])


def test_golden_flash_back_frame_is_smaller():
    """Frame 3 predicts from GOLDEN and is under half its size in the
    one-reference encode of the same GOP."""
    payloads, _, n_gold, _, cdefs = _gop()["port", True]
    assert any(map(any, cdefs)), cdefs
    assert n_gold[1] > 8, n_gold
    assert _gop()["port", False][2] == [0, 0]
    assert len(payloads[2]) < len(_gop()["port", False][0][2]) // 2


def test_chunked_deblock_gop_matches_jax_engine(monkeypatch):
    """TpuEncoderConfig(chunk=2) through encode_stream under the same
    LookaheadRateController: 4 frames of clean drift make a key, one
    chunk of 2 whose sources both engines upload packed, and a
    remainder; the port's stream equals SpecTpuEngine's, payload by
    payload."""
    from av1tpu.encoder import io_pack as j_io_pack
    from av1tpu.encoder import ratectrl as j_ratectrl
    from av1tpu_torch.encoder import io_pack, ratectrl
    frames = [clean_frame(W, H, t, 0) for t in range(4)]

    def run(eng, rc, pack_mod):
        rate = rc.LookaheadRateController(96, target_bits=4 * W * H * 0.6,
                                          total_frames=4, keyint=120)
        chunks, packs = [], []
        submit, real_pack = eng._submit_chunk, pack_mod.pack_chunk

        def chunk_spy(fr, qs):
            chunks.append(len(fr))
            return submit(fr, qs)

        def pack_spy(*a, **k):
            res = real_pack(*a, **k)
            packs.append(res is not None)
            return res

        eng._submit_chunk = chunk_spy
        monkeypatch.setattr(pack_mod, "pack_chunk", pack_spy)
        out = list(eng.encode_stream(frames, rate))
        assert [k for _, k in out] == [True, False, False, False]
        assert chunks == [2] and packs == [True]
        return [bytes(p) for p, _ in out]

    want = run(SpecTpuEngine(TpuEncoderConfig(chunk=2)), j_ratectrl,
               j_io_pack)
    got = run(SpecTorchEngine(port_config.TpuEncoderConfig(chunk=2),
                              device="cpu"), ratectrl, io_pack)
    for i in range(4):
        assert got[i] == want[i], (i, len(got[i]), len(want[i]))
