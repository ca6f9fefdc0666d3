"""RefFrameSignBias in av1tpu_torch's MV stacks (spec 7.10.2.12), on the
CPU and with no JAX program.

Order hints have 7 bits, so from the 65th frame after a key, that key,
which GOLDEN reads, is a future frame to a decoder: RefFrameSignBias
[GOLDEN] is 1 while LAST's is 0, and the extra search of a block's MV
stack negates a candidate whose reference's bias differs from the
block's.  The port's three stacks follow that rule: the native tile
writer's, ``mvrefs.find_mv_stack`` as the Python writer and the decoder
use it, and the decoder's header state that derives the bias.

- Both writers' stacks against ``reference/spec_mvstack.py`` (written
  from the spec) on seeded random grids of 32x32 and split 16x16 blocks
  coding LAST, GOLDEN or intra, over a whole cycle of hints: the Python
  stack block for block, the native writer by its tile bytes and its
  counts.
- A GOLDEN stream of 132 frames of the benchmark's grain traffic
  decodes in libaom (the benchmark's ``aomdec``) and in the port's
  decoder to the encoder's reconstruction past frames 65 and 128; the
  writer's counters record no negation before frame 65 and some after.
- A LAST-only stream of the first 80 of those frames keeps the bytes it
  had before the writer honoured the sign bias, decodes in libaom, and
  negates nothing.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from av1tpu_torch import spec_engine as SE
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.specav1 import decoder, mvrefs, native
from av1tpu_torch.specav1 import tile as T
from av1tpu_torch.specav1 import writer as W
from av1tpu_torch.specav1.cdfs import FrameContext
from av1tpu_torch.utils import spans
from benchmark import aomdec, gen
from reference import spec_mvstack as ref

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QIDX = 96
# an inter frame's ref_frame_idx with GOLDEN on (spec_engine._ref_slots)
GOLDEN_SLOTS = (0, 0, 0, 1, 0, 0, 0)
# frame numbers after a key at frame 0 (hint 0): GOLDEN reads as future
# for (n & 127) in 65..127
FRAMES = (1, 2, 64, 65, 66, 100, 127, 128, 129, 192, 193, 255)
SIZES = ((128, 128), (192, 88), (160, 96))
QUADS = ((0, 0), (0, 4), (4, 0), (4, 4))


def _sign_bias(n: int) -> list:
    """Frame n's RefFrameSignBias, its LAST the frame before and its
    GOLDEN the key at frame 0, by the reference's derivation."""
    slots = [0] * 8
    slots[0] = (n - 1) & 127
    return ref.ref_frame_sign_bias(n & 127, slots, GOLDEN_SLOTS)


def _layout(rng, w, h):
    """A random inter frame on the writer's grid: 32x32 blocks coding
    intra (0), LAST (1) or GOLDEN (4), some split into four 16x16 inter
    blocks of their own vectors; vectors from a small even set, so that
    candidates repeat and stacks run short."""
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3)
    gh, gw = (mi_rows + 7) // 8, (mi_cols + 7) // 8
    modes = rng.choice(np.array([0, 1, 4], np.int32), (gh, gw),
                       p=[0.15, 0.45, 0.4]).astype(np.int32)
    splits = ((rng.random((gh, gw)) < 0.4) & (modes != 0)).astype(np.int32)
    mvs = (rng.integers(-3, 4, (gh, gw, 2)) * 2).astype(np.int32)
    mvs16 = (rng.integers(-3, 4, (gh, gw, 4, 2)) * 2).astype(np.int32)
    skips = (rng.random((gh, gw)) < 0.5).astype(np.int32)
    skips16 = (rng.random((gh, gw, 4)) < 0.5).astype(np.int32)
    return mi_cols, mi_rows, modes, mvs, skips, splits, mvs16, skips16


def _python_tile(mi_cols, mi_rows, lay, sign_bias):
    """The tile of ``lay`` from the Python writer, each block's MV stack
    taken from the reference and held, field by field, to
    ``mvrefs.find_mv_stack`` on the writer's own grid.  Returns the
    bytes and the counts (inter blocks, GOLDEN blocks, negations)."""
    _, _, modes, mvs, skips, splits, mvs16, skips16 = lay
    tw = W.TileWriter(FrameContext(QIDX), mi_cols, mi_rows, QIDX,
                      sign_bias=sign_bias)
    mi = ref.ModeInfo(mi_rows, mi_cols)
    counts = np.zeros(3, np.int64)
    zeros = {n: np.zeros((n, n), np.int64) for n in (8, 16, 32)}

    def coeffs(r, c, b4, is_inter):
        ytx, ctx = (T.TX_32X32, T.TX_16X16) if b4 == 8 else (T.TX_16X16,
                                                             T.TX_8X8)
        tw.coeffs(0, c * 4, r * 4, ytx, zeros[b4 * 4], is_inter=is_inter)
        for p in (1, 2):
            tw.coeffs(p, c * 2, r * 2, ctx, zeros[b4 * 2],
                      is_inter=is_inter)

    def inter(r, c, bsize, ref_frame, mv, skip):
        b4 = T.BLOCK_SIZES[bsize][0]
        want = ref.find_mv_stack(mi, r, c, b4, b4, ref_frame, sign_bias)
        got = tw.mv_stack(r, c, bsize, ref_frame)
        n = want.num_mv_found
        assert got.num_mv_found == n
        assert got.mvs[:n] == want.ref_stack_mv
        assert got.weights[:n] == want.weight_stack
        assert (got.new_mv_ctx, got.ref_mv_ctx, got.zero_mv_ctx) == (
            want.new_mv_context, want.ref_mv_context, want.zero_mv_context)
        assert [got.drl_ctx(i) for i in range(n - 1)] == \
            want.drl_ctx_stack[:n - 1]
        assert got.flips == want.flips
        stack = mvrefs.MvStackResult(
            want.ref_stack_mv, want.weight_stack, n, want.new_mv_context,
            want.ref_mv_context, want.zero_mv_context, want.flips)
        mv = (int(mv[0]), int(mv[1]))
        y_mode = (T.NEARESTMV if mv == stack.ref_mv(0) else
                  T.GLOBALMV if mv == (0, 0) else T.NEWMV)
        tw.block_inter(r, c, bsize, skip, ref_frame, y_mode, mv, stack)
        mi.decode_block(r, c, b4, b4, ref_frame, mv, y_mode == T.NEWMV)
        counts[:] += (1, ref_frame == ref.GOLDEN_FRAME, want.flips)
        if not skip:
            coeffs(r, c, b4, True)

    for sb_r in range(0, mi_rows, 16):
        tw.start_sb_row(sb_r)
        for sb_c in range(0, mi_cols, 16):
            tw.partition(sb_r, sb_c, T.BLOCK_64X64, T.PARTITION_SPLIT)
            for dr, dc in ((0, 0), (0, 8), (8, 0), (8, 8)):
                br, bc = sb_r + dr, sb_c + dc
                if br >= mi_rows or bc >= mi_cols:
                    continue
                gr, gc = br // 8, bc // 8
                mode, skip = int(modes[gr, gc]), int(skips[gr, gc])
                if splits[gr, gc]:
                    tw.partition(br, bc, T.BLOCK_32X32, T.PARTITION_SPLIT)
                    for q, (qr, qc) in enumerate(QUADS):
                        r, c = br + qr, bc + qc
                        if r >= mi_rows or c >= mi_cols:
                            continue
                        tw.partition(r, c, T.BLOCK_16X16, T.PARTITION_NONE)
                        inter(r, c, T.BLOCK_16X16, mode, mvs16[gr, gc, q],
                              int(skips16[gr, gc, q]))
                        tw.update_partition_ctx(r, c, T.BLOCK_16X16)
                    continue
                tw.partition(br, bc, T.BLOCK_32X32, T.PARTITION_NONE)
                if mode:
                    inter(br, bc, T.BLOCK_32X32, mode, mvs[gr, gc], skip)
                else:
                    tw.block_intra_interframe(br, bc, T.BLOCK_32X32, skip,
                                              T.DC_PRED, T.DC_PRED)
                    mi.decode_block(br, bc, 8, 8, ref.INTRA_FRAME)
                    if not skip:
                        coeffs(br, bc, 8, False)
                tw.update_partition_ctx(br, bc, T.BLOCK_32X32)
    return bytes(tw.finish()), counts


@pytest.mark.parametrize("n", FRAMES)
@pytest.mark.parametrize("seed", range(len(SIZES)))
def test_stacks_follow_spec_reference(seed, n):
    """Frame n of a GOP on a random grid: the Python stack equals the
    reference's on every block (candidates, weights, contexts,
    negations); the native writer, given the frame's sign bias, writes
    the tile the Python writer writes from the reference's stacks, and
    counts what the reference counts.  Negations happen exactly where
    GOLDEN reads as future."""
    w, h = SIZES[seed]
    bias = _sign_bias(n)
    assert list(W.ref_frame_sign_bias(n & 127, [(n - 1) & 127] + [0] * 7,
                                      GOLDEN_SLOTS)) == bias
    assert bias[ref.GOLDEN_FRAME] == int(65 <= (n & 127) <= 127)
    assert bias[ref.LAST_FRAME] == 0
    lay = _layout(np.random.default_rng([seed, n]), w, h)
    mi_cols, mi_rows = lay[:2]
    want, want_counts = _python_tile(mi_cols, mi_rows, lay, bias)
    levels = [np.zeros((mi_rows * 4 + 64, mi_cols * 4 + 64), np.int32)]
    levels += [np.zeros((mi_rows * 2 + 32, mi_cols * 2 + 32), np.int32)] * 2
    counts = np.zeros(3, np.int64)
    got = native.encode_inter32_tile(
        QIDX, mi_cols, mi_rows, *lay[2:5], *levels, splits=lay[5],
        mvs16=lay[6], skips16=lay[7], sign_bias=bias, counts=counts)
    assert got == want
    assert counts.tolist() == want_counts.tolist()
    assert counts[1] > 0 and counts[0] > counts[1]
    assert (counts[2] > 0) == bool(bias[ref.GOLDEN_FRAME])


# --- whole streams ------------------------------------------------------------

SIZE = (128, 64)
SEED = 3000000001
N_GOLDEN, N_LAST = 132, 80
# sha256 of the LAST-only stream's payloads as the writer wrote them before
# it honoured the sign bias (the JAX package's writer's rule)
LAST_ONLY_SHA256 = \
    "386a68c9f2d1407777c5017683cee352d819f93b73826c04341d0c1c1a63c77b"


def _stream(golden: bool, n: int):
    """(payloads, recons, MV counter spans) of the grain traffic's first
    n frames at SIZE in the daemon's default configuration (keyint past
    the stream), GOLDEN on or off, with the tracer on."""
    with open(os.path.join(ROOT, "benchmark", "traffic", "grain-p.json")) as f:
        src = gen.Source(json.load(f), *SIZE, SEED)
    frames = [src.frame(i) for i in range(n)]
    eng = SE.SpecTorchEngine(TpuEncoderConfig(keyint=10 ** 6, golden=golden),
                             device="cpu")
    spans.drain()
    spans.enable()
    try:
        payloads, recons, _ = R.spied_stream(eng, frames, QIDX)
    finally:
        spans.disable()
        recorded = spans.drain()
    mv = [s for s in recorded if s.name in SE.MV_COUNTS]
    return payloads, recons, mv


def _per_frame(mv):
    """{counter: [[n of each frame of a dispatch], ...]}, the dispatches
    in item order (the order of a chunk's frames is the order their
    spans ended, which no caller reads)."""
    items = sorted({s.item for s in mv})
    out = {}
    for name in SE.MV_COUNTS:
        out[name] = [[s.n for s in mv if s.name == name and s.item == it]
                     for it in items]
    return out


def _assert_decodes(payloads, recons, port_decoder=True):
    """libaom, and the port's decoder unless told not to, decode the
    stream to the reconstructions."""
    assert len(payloads) == len(recons)
    with aomdec.Decoder() as dec:
        decoded = [[f for p in payloads for f in dec.decode(bytes(p))]]
    if port_decoder:
        decoded.append(decoder.decode_stream(payloads))
    for got in decoded:
        assert len(got) == len(recons)
        for i, (g, r) in enumerate(zip(got, recons)):
            for pl in range(3):
                a = np.asarray(g[pl], np.int64)
                hh, ww = a.shape
                np.testing.assert_array_equal(
                    a, r[pl][:hh, :ww].astype(np.int64),
                    err_msg=f"frame {i} plane {pl}")


def test_golden_stream_past_frame_128_decodes_in_libaom():
    """GOLDEN on, 132 frames: libaom and the port's decoder reproduce every
    reconstruction, frames 65-127 (GOLDEN a future frame) and 128-131
    (past again) included; the writer's counters: GOLDEN blocks in some
    chunk, negations in none of frames 1-64 and in some of 65-128."""
    payloads, recons, mv = _stream(True, N_GOLDEN)
    _assert_decodes(payloads, recons)
    per = _per_frame(mv)
    chunks = per["mv.signbias_flips"]
    # chunk j holds frames 8j + 1 .. 8j + 8; frames 129-131 go one a
    # dispatch at the stream's end
    assert [len(c) for c in chunks] == [8] * 16 + [1] * 3
    assert sum(map(sum, chunks[:8])) == 0
    assert sum(map(sum, chunks[8:16])) > 0
    assert sum(map(sum, chunks[16:])) == 0
    golden = sum(map(sum, per["mv.golden_blocks"]))
    assert 0 < golden < sum(map(sum, per["mv.inter_blocks"]))


def test_last_only_stream_keeps_its_bytes():
    """GOLDEN off, 80 frames: the bytes the writer wrote before it
    honoured the sign bias (every reference reads slot 0, the frame
    before, so no bias differs), libaom reproduces every reconstruction,
    and the counters record no GOLDEN block and no negation."""
    payloads, recons, mv = _stream(False, N_LAST)
    assert hashlib.sha256(b"".join(payloads)).hexdigest() == \
        LAST_ONLY_SHA256
    _assert_decodes(payloads, recons, port_decoder=False)
    per = _per_frame(mv)
    assert sum(map(len, per["mv.inter_blocks"])) == N_LAST - 1
    assert sum(map(sum, per["mv.inter_blocks"])) > 0
    assert sum(map(sum, per["mv.golden_blocks"])) == 0
    assert sum(map(sum, per["mv.signbias_flips"])) == 0
