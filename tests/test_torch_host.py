"""The port's own host codec (av1tpu_torch) vs the JAX package's.

The port keeps copies of the JAX package's framework-free modules: the
spec decoder, the header/OBU writer, the native tile writer and its
loader, and the constant tables.  Each copy must behave exactly as its
original: the same planes from the same stream, the same header bytes,
the same tile bytes, the same tables, the same host reference encoder
streams; but for the tile decoder's three marked departures, where the
copy follows libaom and its original does not, and a fourth in the MV
stacks of the writers and the decoder: the extra search negates a
candidate whose reference's RefFrameSignBias differs from the block's
(spec 7.10.2.12), which the original never does and which changes bytes
once GOLDEN's key lies 65 or more frames back; it is held to libaom and
to a plain reference of the spec by tests/test_torch_signbias.py.  None
of these tests compiles a JAX program.
"""

import types

import numpy as np
import pytest
import torch

from av1tpu.specav1 import cdef as j_cdef
from av1tpu.specav1 import cdfs as j_cdfs
from av1tpu.specav1 import decoder as j_decoder
from av1tpu.specav1 import encode as j_encode
from av1tpu.specav1 import inter_recon as j_inter_recon
from av1tpu.specav1 import native as j_native
from av1tpu.specav1 import obu as j_obu
from av1tpu.specav1 import recon as j_recon
from av1tpu.specav1 import writer as j_writer
from av1tpu_torch import spec_engine
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.specav1 import (cdef, cdfs, decoder, encode, headers,
                                  inter_recon, lr, native, obu, recon, writer)
from av1tpu_torch.utils import testsrc
from av1tpu_torch.utils.cleansrc import clean_frame

torch.set_num_threads(1)
CFG = dict(chunk=1, golden=False, cdef=False, lr=False)


def _jax_native():
    """The JAX package's native writer in the engine's place.  Its tile
    rows take no sign bias and count nothing, so it writes the port's
    bytes only where no reference reads as a future frame (every bias
    0), as in these streams' first frames."""
    def encode_tile_rows(*a, sign_bias=None, counts=None, **k):
        assert not any(sign_bias or ()), sign_bias
        return j_native.encode_tile_rows(*a, **k)
    return types.SimpleNamespace(**dict(vars(j_native),
                                        encode_tile_rows=encode_tile_rows))


def _grainy(w, h, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = testsrc.testsrc2(w, h, i)
        y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                    0, 255).astype(np.uint8)
        out.append(testsrc.Frame(y=y, u=f.u, v=f.v))
    return out


def _port_encode(w, h, n, seed, frames=None, golden=False, filters=False):
    """(engine, pending frames, recons) of a key + P CPU encode by the
    port; the first frame is the key.  filters: CDEF and LR on."""
    cfg = dict(CFG, golden=golden, cdef=filters, lr=filters)
    eng = spec_engine.SpecTorchEngine(TpuEncoderConfig(**cfg), device="cpu")
    eng.start_stream()
    pend, recons = [], []
    for i, f in enumerate(frames or _grainy(w, h, n, seed)):
        pend.append(eng._submit(f, 96, is_key=(i == 0)))
        recons.append(eng._ref)
    return eng, pend, recons


def _flash_gop(w, h):
    """Clean key A, inter B, inter A: deblocking on, GOLDEN blocks in
    the third frame."""
    return [clean_frame(w, h, 0, 0), clean_frame(w, h, 5, 1),
            clean_frame(w, h, 1, 0)]


def _flat_gop(w, h):
    """Flat frames a few levels apart: nothing splits, so the frame's
    transform grid is uniform 32x32."""
    out = []
    for lvl in (100, 104, 101):
        f = clean_frame(w, h, 0, 0)
        out.append(testsrc.Frame(y=np.full_like(f.y, lvl), u=f.u, v=f.v))
    return out


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


def _drift_gop(w, h):
    """Clean scene A and two blends towards scene B: smooth content, on
    which the search settles on long vectors."""
    out = [clean_frame(w, h, 0, 0)]
    for k in (1, 2):
        fa, fb = clean_frame(w, h, k, 0), clean_frame(w, h, k, 1)
        out.append(testsrc.Frame(*(
            (((5 - k) * pa.astype(np.int32) + k * pb.astype(np.int32) + 2)
             // 5).astype(np.uint8)
            for pa, pb in ((fa.y, fb.y), (fa.u, fb.u), (fa.v, fb.v)))))
    return out


# heights 24 past a multiple of 32 (the geometry of 1080 rows: the last
# block row overhangs the frame by 8 rows), in one and in four tile rows;
# and four tile rows with long vectors beside the tile rows' ends
@pytest.mark.parametrize("w,h,gop", [(128, 88, None), (64, 536, None),
                                     (128, 512, _drift_gop)])
def test_decoder_departures_follow_libaom(w, h, gop):
    """The port's tile decoder departs from its original in three places:
    the coefficient contexts count only the units inside the frame, the
    MV grid keeps a block's coded size and not its visible part (both
    matter where a block overhangs the frame's edge), and the MV
    candidates are clamped against the frame's edges, not the tile's.  On
    streams where the original decoder loses the reconstruction, the port's
    must reproduce it, as libaom does where the system has it."""
    from av1tpu.conformance import aomcodec
    frames = gop(w, h) if gop else None
    eng, pend, recons = _port_encode(w, h, 2, w + h, frames=frames,
                                     golden=gop is not None)
    payloads = [eng._finalize(p)[0] for p in pend]
    decoded = [decoder.decode_stream(payloads)]
    if aomcodec.available():
        decoded.append(aomcodec.decode_stream(payloads))
    for got in decoded:
        assert len(got) == len(recons)
        for g, r in zip(got, recons):
            for pl in range(3):
                hh, ww = np.asarray(g[pl]).shape
                assert hh == (h if pl == 0 else h // 2)
                np.testing.assert_array_equal(np.asarray(g[pl], np.int64),
                                              r[pl][:hh, :ww])
    # a departure stands only while the original loses these streams
    original = j_decoder.decode_stream(payloads)
    assert any(not np.array_equal(o[pl], g[pl])
               for o, g in zip(original, decoded[0]) for pl in range(3))


# uniform 32x32 grid (the JAX package's decoder takes its vectorized
# filter there), split blocks, and split blocks + the 16-px strip
@pytest.mark.parametrize("w,h,gop", [(64, 64, _flat_gop),
                                     (128, 128, _flash_gop),
                                     (96, 80, _flash_gop)])
def test_decoder_matches_jax_package_decoder_deblocked(w, h, gop):
    """A two-reference stream with the loop filter on: the port's
    decoder (always the grid-driven numpy filter) gives the JAX
    package's decoder's planes, and both equal the port's recon."""
    eng, pend, recons = _port_encode(w, h, 3, 0, frames=gop(w, h),
                                     golden=True)
    assert eng._gop_deblock and all(p[14] > 0 for p in pend)
    splits = sum(int(p[11][10 if p[0] == "key" else 11].sum())
                 for p in pend)
    assert (splits == 0) == (gop is _flat_gop)
    payloads = [eng._finalize(p)[0] for p in pend]
    got = decoder.decode_stream(payloads)
    want = j_decoder.decode_stream(payloads)
    assert len(got) == len(want) == 3
    for g, wnt, r in zip(got, want, recons):
        for pl in range(3):
            np.testing.assert_array_equal(g[pl], np.asarray(wnt[pl]))
            hh, ww = g[pl].shape
            np.testing.assert_array_equal(np.asarray(g[pl], np.int64),
                                          r[pl][:hh, :ww])


def test_decoder_refuses_deblocked_frame():
    """The decoder used to refuse a frame header with the loop filter
    on, and then one with CDEF on; now it parses the levels and the CDEF
    strengths and decodes a keyframe with deblocking, CDEF and LR on to
    the encoder's recon, every plane."""
    eng, pend, recons = _port_encode(64, 64, 1, 0,
                                     frames=[clean_frame(64, 64, 0)],
                                     filters=True)
    tu = eng._finalize(pend[0])[0]
    (frame,) = decoder.decode_stream([tu])
    obus = list(obu.parse_obus(tu))
    seq = headers.parse_sequence_header(obus[0].payload)
    hdr = headers.parse_frame_header(obus[1].payload, seq)
    assert all(hdr.lf.level) and tuple(hdr.lf.level) == (pend[0][14],) * 4
    assert seq.enable_cdef and seq.enable_restoration
    cdefs = pend[0][11][16].tolist()
    assert any(cdefs) and hdr.cdef.bits == 0
    assert [hdr.cdef.y_pri[0], hdr.cdef.y_sec[0], hdr.cdef.uv_pri[0],
            hdr.cdef.uv_sec[0]] == cdefs
    assert hdr.cdef.damping == pend[0][16] == spec_engine.cdef_damping(
        hdr.base_q_idx)
    assert list(hdr.lr.frame_restoration_type) == [1, 0, 0]
    for pl in range(3):
        hh, ww = frame[pl].shape
        np.testing.assert_array_equal(frame[pl], recons[0][pl][:hh, :ww])


@pytest.mark.parametrize("w,h,q,bd", [(64, 64, 96, 8), (1920, 1080, 60, 8),
                                      (256, 144, 255, 10),
                                      (1280, 720, 0, 10)])
def test_header_writers_match_jax_package(w, h, q, bd):
    assert writer.write_sequence_header(w, h, bit_depth=bd) == \
        j_writer.write_sequence_header(w, h, bit_depth=bd)
    kw = dict(color_primaries=9, transfer=16, matrix=9)
    assert writer.write_sequence_header(w, h, bit_depth=bd, **kw) == \
        j_writer.write_sequence_header(w, h, bit_depth=bd, **kw)
    kw = dict(enable_cdef=True, enable_restoration=True)
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
        # loop-filter levels and the GOLDEN reference slot
        for lvl, lvl_uv in ((1, 0), (12, 12), (63, 40)):
            lf = dict(lf_level=lvl, lf_level_uv=lvl_uv, tile_rows_log2=trl2)
            a = writer.write_key_frame_header(w, h, q, **lf)
            b = j_writer.write_key_frame_header(w, h, q, **lf)
            gold = dict(lf, order_hint=9, ref_slots=(0, 0, 0, 1, 0, 0, 0))
            c = writer.write_inter_frame_header(w, h, q, **gold)
            d = j_writer.write_inter_frame_header(w, h, q, **gold)
            plain = writer.write_inter_frame_header(w, h, q, order_hint=9,
                                                    tile_rows_log2=trl2)
            for x in (a, b, c, d, plain):
                x.byte_align()
            assert a.tobytes() == b.tobytes()
            assert c.tobytes() == d.tobytes() != plain.tobytes()
        # CDEF strengths (sec 4 codes as 3) and luma WIENER restoration
        for cd in ((3, 0, 0, 0, 0), (4, 8, 2, 1, 0), (6, 12, 4, 8, 2)):
            fl = dict(cdef=cd, lr_types=(1, 0, 0), tile_rows_log2=trl2,
                      lf_level=9, lf_level_uv=9)
            a = writer.write_key_frame_header(w, h, q, **fl)
            b = j_writer.write_key_frame_header(w, h, q, **fl)
            c = writer.write_inter_frame_header(w, h, q, order_hint=3, **fl)
            d = j_writer.write_inter_frame_header(w, h, q, order_hint=3,
                                                  **fl)
            for x in (a, b, c, d):
                x.byte_align()
            assert a.tobytes() == b.tobytes()
            assert c.tobytes() == d.tobytes()
        assert writer.tile_row_spans(h, trl2) == \
            j_writer.tile_row_spans(h, trl2)
    tiles = [b"\x01\x02", b"\x03", b"\x04\x05\x06"]
    assert writer.assemble_tile_group(tiles) == \
        j_writer.assemble_tile_group(tiles)
    # the engines' av1C record (the container's CodecPrivate): the CDEF and
    # LR enable flags follow the config, the colour codes the source stream
    from av1tpu.config import TpuEncoderConfig as JaxConfig
    from av1tpu.spec_engine import SpecTpuEngine
    for cfg in ({}, dict(cdef=False, lr=False), dict(cdef=True, lr=False)):
        ref = SpecTpuEngine(JaxConfig(**cfg))
        eng = spec_engine.SpecTorchEngine(TpuEncoderConfig(**cfg),
                                          device="cpu")
        for stream in (None, _SourceStream()):
            want = ref.codec_private(ref.sequence_header(w, h, bd, stream))
            got = eng.codec_private(eng.sequence_header(w, h, bd, stream))
            assert got == want
            (o,) = obu.parse_obus(got[4:])
            seq = headers.parse_sequence_header(o.payload)
            assert (bool(seq.enable_cdef), bool(seq.enable_restoration)) == \
                (cfg.get("cdef", True), cfg.get("lr", True))


class _SourceStream:
    """A probed source stream's colour codes (BT.2020 PQ)."""
    color_primaries_code = 9
    color_transfer_code = 16
    color_matrix_code = 9


@pytest.mark.parametrize("bd", [8, 10])
def test_cdef_copy_matches_jax_package(bd):
    """The port's numpy CDEF (the decoder's) against its original: the
    tables and cdef_frame's planes at several strength pairs."""
    for name in ("DIRECTIONS", "PRI_TAPS", "SEC_TAPS", "DIV_TABLE"):
        np.testing.assert_array_equal(getattr(cdef, name),
                                      getattr(j_cdef, name))
    assert cdef.CDEF_VERY_LARGE == j_cdef.CDEF_VERY_LARGE
    rng = np.random.default_rng(bd)
    mx = (1 << bd) - 1
    base = np.kron(rng.integers(0, mx + 1, (12, 16)), np.ones((8, 8), int))
    y = np.clip(base + rng.integers(-20, 21, base.shape), 0, mx)
    u = np.clip(base[::2, ::2] + rng.integers(-20, 21, (48, 64)), 0, mx)
    v = np.clip(u + rng.integers(-9, 10, u.shape), 0, mx)
    skips4 = rng.random((24, 32)) < 0.3
    for st in ((1, 0, 1, 0), (4, 2, 2, 1), (12, 4, 8, 2), (0, 2, 0, 1)):
        kw = dict(y_pri=st[0], y_sec=st[1], uv_pri=st[2], uv_sec=st[3],
                  damping=4, bit_depth=bd, th=88, tw=120)
        got = cdef.cdef_frame((y, u, v), skips4, **kw)
        want = j_cdef.cdef_frame((y, u, v), skips4, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


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


@pytest.mark.parametrize("w,h,golden", [(64, 64, False), (96, 80, False),
                                        (128, 128, True), (96, 80, True)])
def test_tile_writer_matches_jax_package(w, h, golden, monkeypatch):
    """The port's native tile writer, header writer and OBU framing give
    the same frame bytes as the JAX package's modules on the same
    device outputs: key + P on grainy content, and the clean flash GOP
    with GOLDEN modes in the tiles, the GOLDEN slot and filter levels in
    the headers."""
    if golden:
        eng, pend, _ = _port_encode(w, h, 3, 0, frames=_flash_gop(w, h),
                                    golden=True)
        assert int(pend[2][11][14].sum()) > 0 and pend[2][14] > 0
    else:
        eng, pend, _ = _port_encode(w, h, 2, 3 * w + h)
    got = [eng._finalize(p) for p in pend]
    monkeypatch.setattr(spec_engine, "native", _jax_native())
    monkeypatch.setattr(spec_engine, "W", j_writer)
    monkeypatch.setattr(spec_engine, "obu_mod", j_obu)
    want = [eng._finalize(p) for p in pend]
    assert got == want
    assert [k for _, k in got] == [True, False, False][:len(pend)]


@pytest.mark.parametrize("filters", [False, True], ids=["plain", "cdef_lr"])
def test_host_reference_encoder_matches_jax_package(filters):
    """encode_stream_host (the numpy reference encoder, Python tile
    writer): the copy's temporal units and recons equal the original's
    on a 64x64 3-frame clip, with in-loop CDEF and a luma Wiener unit or
    without them; the stream decodes to its recons."""
    frames = [(f.y, f.u, f.v) for f in (testsrc.testsrc2(64, 64, i)
                                        for i in range(3))]
    kw = {}
    if filters:
        kw = dict(cdef=(4, 2, 1, 1, 0),
                  lr={"types": (lr.RESTORE_WIENER, 0, 0), "size": 64,
                      "decisions": {(0, 0, 0): ("wiener", [3, -7, 15],
                                                [-2, 5, 30])}})
    want_tus, want_rec = j_encode.encode_stream_host(frames, 96, **kw)
    tus, rec = encode.encode_stream_host(frames, 96, **kw)
    assert tus == want_tus
    for got, want in zip(rec, want_rec):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for got, want in zip(decoder.decode_stream(tus), rec):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a, np.int64),
                                          np.asarray(b, np.int64))


def test_legacy_host_copies_match_jax_package():
    """The private av1tpu profile's host copies give their originals'
    bytes: the quantizer tables, the bit writer/reader, the OBU layer
    (sequence and frame headers, frame OBUs with 1 and 4 tiles, parsing,
    the av1C record) and the native tile codec (intra and inter tiles,
    one and two references, 16- and 32-px blocks), encode and decode."""
    from av1tpu.encoder import quant as j_quant
    from av1tpu.encoder.entropy import bitio as j_bitio
    from av1tpu.legacy import entropy_tile as j_tile
    from av1tpu.media import obu as j_obu2
    from av1tpu_torch.encoder import quant
    from av1tpu_torch.encoder.entropy import bitio
    from av1tpu_torch.legacy import entropy_tile as tile
    from av1tpu_torch.media import obu as obu2
    for bd in (8, 10):
        np.testing.assert_array_equal(quant.ac_quant_table(bd),
                                      j_quant.ac_quant_table(bd))
        np.testing.assert_array_equal(quant.dc_quant_table(bd),
                                      j_quant.dc_quant_table(bd))
    writers = []
    for mod in (bitio, j_bitio):
        w = mod.BitWriter()
        for v, n in ((5, 3), (0, 1), (300, 9), (1, 1)):
            w.f(v, n)
        w.uvlc(37)
        w.ns(5, 7)
        w.su(-3 & 0xF, 4)
        w.trailing_bits()
        writers.append(w.bytes() + mod.write_leb128(123456))
    assert writers[0] == writers[1]
    r = bitio.BitReader(writers[0])
    assert [r.f(3), r.f(1), r.f(9), r.f(1), r.uvlc(), r.ns(7)] == \
        [5, 0, 300, 1, 37, 5]
    rng = np.random.default_rng(4)
    for w, h, bd in ((160, 96, 8), (1920, 1080, 10)):
        sh = obu2.SequenceHeader(width=w, height=h, bit_depth=bd,
                                 color_primaries=9, color_transfer=16,
                                 color_matrix=9)
        jsh = j_obu2.SequenceHeader(width=w, height=h, bit_depth=bd,
                                    color_primaries=9, color_transfer=16,
                                    color_matrix=9)
        assert sh.write() == jsh.write()
        assert obu2.av1c_record(sh) == j_obu2.av1c_record(jsh)
        assert obu2.SequenceHeader.parse(sh.write()) == sh
        tiles = [bytes(rng.integers(0, 256, k, dtype=np.uint8))
                 for k in (0, 5, 300, 2)]
        for kw in (dict(frame_type=obu2.KEY_FRAME, lr_mode=2),
                   dict(frame_type=obu2.INTER_FRAME, two_ref=True,
                        refresh=False, cdef_on=False, tile_rows_log2=2)):
            fh = obu2.FrameHeader(base_q_idx=77, width=w, height=h,
                                  luma_block_log2=5, **kw)
            jfh = j_obu2.FrameHeader(base_q_idx=77, width=w, height=h,
                                     luma_block_log2=5, **kw)
            for td in (tiles, tiles[2]):
                a = obu2.write_frame_obu(fh, td)
                assert a == j_obu2.write_frame_obu(jfh, td)
                ((typ, data),) = obu2.parse_obus(a)
                got, n = obu2.FrameHeader.parse(data)
                assert typ == obu2.OBU_FRAME and got == fh
                if isinstance(td, list):
                    assert obu2.split_tiles(data[n:], 4) == tiles
    for n, B in ((16, 12), (32, 5)):
        c = n // 2
        lv = [np.where(rng.random((B, k * k)) < 0.2,
                       rng.integers(-900, 900, (B, k * k)), 0)
              for k in (n, c, c)]
        skips = (rng.random(B) < 0.3).astype(np.uint8)
        for i in np.nonzero(skips)[0]:
            for a in lv:
                a[i] = 0
        modes = rng.integers(0, 11, (2, B)).astype(np.uint8)
        a = tile.encode_tile_intra(skips, *modes, *lv, n, c)
        assert a == j_tile.encode_tile_intra(skips, *modes, *lv, n, c)
        for got, want in zip(tile.decode_tile_intra(a, B, n, c),
                             (skips, *modes, *lv)):
            np.testing.assert_array_equal(got, want)
        mvs = rng.integers(-200, 200, (B, 2)).astype(np.int32)
        txs = rng.integers(0, 3, B).astype(np.uint8)
        for refs in (None, rng.integers(0, 2, B).astype(np.uint8)):
            a = tile.encode_tile_inter(skips, mvs, *lv, n, c, refs=refs,
                                       txs=txs)
            assert a == j_tile.encode_tile_inter(skips, mvs, *lv, n, c,
                                                 refs=refs, txs=txs)
            got = tile.decode_tile_inter(a, B, n, c,
                                         use_refs=refs is not None)
            assert all(np.array_equal(g, x)
                       for g, x in zip(got, j_tile.decode_tile_inter(
                           a, B, n, c, use_refs=refs is not None)))
            np.testing.assert_array_equal(got[1], mvs)
