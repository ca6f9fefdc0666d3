"""The port's own host codec (av1tpu_torch) vs the JAX package's.

The port keeps copies of the JAX package's framework-free modules: the
spec decoder, the header/OBU writer, the native tile writer and its
loader, and the constant tables.  Each copy must behave exactly as its
original: the same planes from the same stream, the same header bytes,
the same tile bytes, the same tables.  None of these tests compiles a
JAX program.
"""

import numpy as np
import pytest
import torch

from av1tpu.specav1 import cdfs as j_cdfs
from av1tpu.specav1 import decoder as j_decoder
from av1tpu.specav1 import inter_recon as j_inter_recon
from av1tpu.specav1 import native as j_native
from av1tpu.specav1 import obu as j_obu
from av1tpu.specav1 import recon as j_recon
from av1tpu.specav1 import writer as j_writer
from av1tpu_torch import spec_engine
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.specav1 import (cdfs, decoder, inter_recon, native, obu,
                                  recon, writer)
from av1tpu_torch.utils import testsrc

torch.set_num_threads(1)
CFG = dict(chunk=1, golden=False, cdef=False, lr=False)


def _grainy(w, h, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = testsrc.testsrc2(w, h, i)
        y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                    0, 255).astype(np.uint8)
        out.append(testsrc.Frame(y=y, u=f.u, v=f.v))
    return out


def _port_encode(w, h, n, seed):
    """(engine, pending frames, recons) of a key + P CPU encode by the
    port."""
    eng = spec_engine.SpecTorchEngine(TpuEncoderConfig(**CFG), device="cpu")
    eng.start_stream()
    pend, recons = [], []
    for i, f in enumerate(_grainy(w, h, n, seed)):
        pend.append(eng._submit(f, 96, is_key=(i == 0)))
        recons.append(eng._ref)
    return eng, pend, recons


# 96x80 codes a 16-px bottom strip on both frame types
@pytest.mark.parametrize("w,h", [(64, 64), (96, 80)])
def test_decoder_matches_jax_package_decoder(w, h):
    """The port's decode_stream gives the JAX package's decoder's planes,
    and both equal the port's own reconstruction."""
    eng, pend, recons = _port_encode(w, h, 2, w + h)
    payloads = [eng._finalize(p)[0] for p in pend]
    got = decoder.decode_stream(payloads)
    want = j_decoder.decode_stream(payloads)
    assert len(got) == len(want) == 2
    for g, wnt, r in zip(got, want, recons):
        for pl in range(3):
            np.testing.assert_array_equal(g[pl], wnt[pl])
            hh, ww = g[pl].shape
            np.testing.assert_array_equal(np.asarray(g[pl], np.int64),
                                          r[pl][:hh, :ww])


def test_decoder_refuses_deblocked_frame():
    """A frame header with the loop filter on names the unported
    module before any tile is read."""
    seq = writer.write_sequence_header(64, 64)
    hdr = writer.write_key_frame_header(64, 64, 96, lf_level=8,
                                        lf_level_uv=4)
    hdr.byte_align()
    tu = seq + obu.make_obu(obu.OBU_FRAME, hdr.tobytes())
    with pytest.raises(NotImplementedError, match="loopfilter"):
        decoder.decode_stream([tu])


@pytest.mark.parametrize("w,h,q,bd", [(64, 64, 96, 8), (1920, 1080, 60, 8),
                                      (256, 144, 255, 10),
                                      (1280, 720, 0, 10)])
def test_header_writers_match_jax_package(w, h, q, bd):
    assert writer.write_sequence_header(w, h, bit_depth=bd) == \
        j_writer.write_sequence_header(w, h, bit_depth=bd)
    kw = dict(color_primaries=9, transfer=16, matrix=9)
    assert writer.write_sequence_header(w, h, bit_depth=bd, **kw) == \
        j_writer.write_sequence_header(w, h, bit_depth=bd, **kw)
    for trl2 in (0, 2):
        key = dict(order_hint=q & 127, tile_rows_log2=trl2,
                   render_size=(w - 2, h - 2))
        a = writer.write_key_frame_header(w, h, q, **key)
        b = j_writer.write_key_frame_header(w, h, q, **key)
        a.byte_align()
        b.byte_align()
        assert a.tobytes() == b.tobytes()
        for refresh in (0x01, 0x00):
            inter = dict(order_hint=5, refresh_frame_flags=refresh,
                         tile_rows_log2=trl2, render_size=None)
            a = writer.write_inter_frame_header(w, h, q, **inter)
            b = j_writer.write_inter_frame_header(w, h, q, **inter)
            a.byte_align()
            b.byte_align()
            assert a.tobytes() == b.tobytes()
        assert writer.tile_row_spans(h, trl2) == \
            j_writer.tile_row_spans(h, trl2)
    tiles = [b"\x01\x02", b"\x03", b"\x04\x05\x06"]
    assert writer.assemble_tile_group(tiles) == \
        j_writer.assemble_tile_group(tiles)


def test_tables_match_jax_package():
    """DC_Q, AC_Q, smooth weights, directional derivatives, subpel taps
    and every default CDF loaded from the port's .npz copy."""
    for bd in (8, 10):
        np.testing.assert_array_equal(recon.DC_Q[bd], j_recon.DC_Q[bd])
        np.testing.assert_array_equal(recon.AC_Q[bd], j_recon.AC_Q[bd])
    for size in recon.SM_WEIGHTS:
        np.testing.assert_array_equal(recon.SM_WEIGHTS[size],
                                      j_recon.SM_WEIGHTS[size])
    np.testing.assert_array_equal(recon.DR_DERIVATIVE,
                                  j_recon.DR_DERIVATIVE)
    np.testing.assert_array_equal(inter_recon.SUBPEL_REGULAR,
                                  j_inter_recon.SUBPEL_REGULAR)
    a, b = cdfs._tables(), j_cdfs._tables()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for q in (0, 20, 60, 96, 255):
        ta = native._fc_tables(cdfs.FrameContext(q))
        tb = j_native._fc_tables(j_cdfs.FrameContext(q))
        assert [t for t, _ in ta] == [t for t, _ in tb]
        for (_, x), (_, y) in zip(ta, tb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("w,h", [(64, 64), (96, 80)])
def test_tile_writer_matches_jax_package(w, h, monkeypatch):
    """The port's native tile writer, header writer and OBU framing give
    the same frame bytes as the JAX package's modules on the same
    device outputs (key + P)."""
    eng, pend, _ = _port_encode(w, h, 2, 3 * w + h)
    got = [eng._finalize(p) for p in pend]
    monkeypatch.setattr(spec_engine, "native", j_native)
    monkeypatch.setattr(spec_engine, "W", j_writer)
    monkeypatch.setattr(spec_engine, "obu_mod", j_obu)
    want = [eng._finalize(p) for p in pend]
    assert got == want
    assert [k for _, k in got] == [True, False]
