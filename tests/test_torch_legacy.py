"""The private av1tpu profile's primitives in the port against the JAX
package's, on the CPU (inputs made from a seed with numpy).

Two items, so that the file is handed out late beside the JAX package's
slow tail.  Normative arithmetic is bit-exact: the inverse transforms
(DCT, ADST and IDTX, the profile's alphabet, at 4-32), dequantization,
intra prediction, subpel MC, the deblocking filter, CDEF, loop
restoration and the sparse level pack.  The float32 forward transform
sums in the reference's order, so it and the decisions built on it
(quantized levels, subpel_refine, the CDEF gate, the restoration choice,
the mode SSE) are exact here too; the forward transform is also held to
the looser contract of a float port (1e-4 relative, 99.9% of levels).
Each JAX function compiles once per shape and set of static arguments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from av1tpu.encoder import quant as j_quant
from av1tpu.encoder.kernels import cdef as j_cdef
from av1tpu.encoder.kernels import deblock as j_deblock
from av1tpu.encoder.kernels import intra as j_intra
from av1tpu.encoder.kernels import mc as j_mc
from av1tpu.encoder.kernels import motion as j_motion
from av1tpu.encoder.kernels import restoration as j_lr
from av1tpu.encoder.kernels import transforms as j_tx
from av1tpu.legacy.core import inter_frame as j_inter
from av1tpu.legacy.core import intra_frame as j_intra_frame
from av1tpu_torch.encoder import quant
from av1tpu_torch.encoder.kernels import (cdef, deblock, intra, mc, motion,
                                          restoration)
from av1tpu_torch.encoder.kernels import transforms as tx
from av1tpu_torch.legacy.core import inter_frame, intra_frame


def _t(a):
    return torch.as_tensor(np.array(a))


_jits: dict = {}


def _jit(fn, *static):
    """fn jitted once per module (its static arguments by position), so
    that each JAX function compiles one program per shape."""
    key = (fn, static)
    if key not in _jits:
        _jits[key] = jax.jit(fn, static_argnums=static)
    return _jits[key]


def _smooth_plane(rng, h, w, bd):
    """Piecewise-smooth content with edges and texture (integrated
    noise), so that the filters' and the predictors' branches all
    fire."""
    p = np.cumsum(np.cumsum(rng.integers(-3, 4, (h, w)), 0), 1)
    p = p - p.min()
    p = p * ((1 << bd) - 1) // max(1, p.max())
    p[h // 3:, w // 2:] = ((1 << bd) - 1) - p[h // 3:, w // 2:]
    return p.astype(np.int32)


TX_TYPES = (j_tx.DCT_DCT, j_tx.ADST_ADST, j_tx.IDTX)


def test_normative_primitives_match_jax():
    """Bit-exact at 8 and 10 bits: inv_txfm and dequantize_block,
    predict_mode_v2 over all 11 modes, the subpel luma and chroma MC,
    deblock_plane, cdef_plane (luma and chroma), apply_restoration
    (every preset), over qindexes from off to strong; and the sparse
    level pack (under and over its capacity) with its inverse."""
    rng = np.random.default_rng(0)
    inv = _jit(j_tx.inv_txfm, 1)
    for n in (4, 8, 16, 32):
        for t in TX_TYPES:
            c = rng.integers(-5000, 5000, (6, n, n)).astype(np.int32)
            c[0] = rng.integers(-40000, 40000, (n, n))  # the clamps
            np.testing.assert_array_equal(tx.inv_txfm(_t(c), t).numpy(),
                                          np.asarray(inv(jnp.asarray(c), t)))
        lv = rng.integers(-50, 50, (6, n, n)).astype(np.int32)
        for bd, q in ((8, 96), (10, 30)):
            dc, ac = j_quant.dc_q(q, bd), j_quant.ac_q(q, bd)
            assert (quant.dc_q(q, bd), quant.ac_q(q, bd)) == (dc, ac)
            np.testing.assert_array_equal(
                quant.dequantize_block(_t(lv), dc, ac).numpy(),
                np.asarray(_jit(j_quant.dequantize_block)(
                    jnp.asarray(lv), dc, ac)))
    for bd in (8, 10):
        np.testing.assert_array_equal(quant.ac_quant_table(bd),
                                      j_quant.ac_quant_table(bd))
        np.testing.assert_array_equal(quant.dc_quant_table(bd),
                                      j_quant.dc_quant_table(bd))
        mx = (1 << bd) - 1
        for n in (8, 16, 32):
            B = 44
            ab = rng.integers(0, mx + 1, (B, 2 * n))
            lf = rng.integers(0, mx + 1, (B, n))
            ab[:4] = ab[:4, :1]            # flat neighbours: ties, DC
            lf[:4] = ab[:4, :1]
            co = rng.integers(0, mx + 1, B)
            md = np.arange(B) % intra.N_INTRA_MODES_V2
            np.testing.assert_array_equal(
                intra.predict_mode_v2(_t(ab), _t(lf), _t(co), _t(md),
                                      n).numpy(),
                np.asarray(_jit(j_intra.predict_mode_v2, 4)(
                    jnp.asarray(ab), jnp.asarray(lf), jnp.asarray(co),
                    jnp.asarray(md), n)))
        ref = _smooth_plane(rng, 64, 96, bd)
        ref_pad = np.pad(ref, 64, mode="edge")
        n = 16
        pos = j_motion.block_positions(64, 96, n)
        mv_q = rng.integers(-60, 60, (pos.shape[0], 2)).astype(np.int32)
        np.testing.assert_array_equal(
            mc.predict_subpel_luma(_t(ref_pad), _t(pos), _t(mv_q), n, 64,
                                   mx).numpy(),
            np.asarray(_jit(j_mc.predict_subpel_luma, 3, 4, 5)(
                jnp.asarray(ref_pad), jnp.asarray(pos), jnp.asarray(mv_q), n,
                64, mx)))
        cpad = np.pad(ref[::2, ::2], 32, mode="edge")
        cpos = j_motion.block_positions(32, 48, n // 2)
        np.testing.assert_array_equal(
            mc.predict_subpel_chroma(_t(cpad), _t(cpos), _t(mv_q), n // 2,
                                     32, mx).numpy(),
            np.asarray(_jit(j_mc.predict_subpel_chroma, 3, 4, 5)(
                jnp.asarray(cpad), jnp.asarray(cpos), jnp.asarray(mv_q),
                n // 2, 32, mx)))
        rec = np.clip(ref + rng.integers(-9, 10, ref.shape) * (bd - 7), 0,
                      mx).astype(np.int32)
        for q in (20, 96, 230):
            for n in (8, 16):
                np.testing.assert_array_equal(
                    deblock.deblock_plane(_t(rec), n, q, bd).numpy(),
                    np.asarray(_jit(j_deblock.deblock_plane, 1, 3)(
                        jnp.asarray(rec), n, q, bd)))
            for chroma in (False, True):
                np.testing.assert_array_equal(
                    cdef.cdef_plane(_t(rec), q, bd, chroma).numpy(),
                    np.asarray(_jit(j_cdef.cdef_plane, 2, 3)(
                        jnp.asarray(rec), q, bd, chroma)))
        for m in range(restoration.N_MODES):
            np.testing.assert_array_equal(
                restoration.apply_restoration(_t(rec), m, mx).numpy(),
                np.asarray(_jit(j_lr.apply_restoration, 1, 2)(
                    jnp.asarray(rec), m, mx)))
    shapes = [(60, 256), (60, 64), (60, 64)]
    for density in (0.02, 0.2):
        lvs = [np.where(rng.random(s) < density,
                        rng.integers(-300, 300, s), 0).astype(np.int16)
               for s in shapes]
        want = _jit(j_inter.sparse_pack_levels)(*map(jnp.asarray, lvs))
        got = inter_frame.sparse_pack_levels(*map(_t, lvs))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        back = inter_frame.sparse_unpack_levels(*(g.numpy() for g in got),
                                                shapes)
        if density < 1 / inter_frame.SPARSE_CAP_FRACTION:
            for a, b in zip(back, lvs):
                np.testing.assert_array_equal(a, b)
        else:
            assert back is None


def test_float_decisions_match_jax():
    """The float32 paths, exact on these inputs: fwd_txfm at 4-32 (and
    within 1e-4 relative) and the profile's quantizer on it (levels
    agreeing on at least 99.9%, and all), _mode_sse and its argmin,
    subpel_refine (the 7x7 quarter-pel grid and its 1/4 acceptance), the
    CDEF gate and the restoration choice (one and two tile stripes), at
    8 and 10 bits."""
    rng = np.random.default_rng(1)
    fwd = _jit(j_tx.fwd_txfm, 1)
    for n in (4, 8, 16, 32):
        for t in TX_TYPES:
            r = rng.integers(-255, 256, (40, n, n)).astype(np.int32)
            r[1] = 3            # flat blocks: coefficients on the grid
            want = np.asarray(fwd(jnp.asarray(r), t))
            got = tx.fwd_txfm(_t(r), t).numpy()
            assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want).max())
            np.testing.assert_array_equal(got, want)
            for bd, q in ((8, 96), (10, 30), (8, 200)):
                dc, ac = j_quant.dc_q(q, bd), j_quant.ac_q(q, bd)
                lv_w = np.asarray(_jit(j_quant.quantize_block)(
                    jnp.asarray(want), dc, ac))
                lv_g = quant.quantize_block(_t(got), dc, ac).numpy()
                assert np.mean(lv_g == lv_w) >= 0.999
                np.testing.assert_array_equal(lv_g, lv_w)
    for bd in (8, 10):
        mx = (1 << bd) - 1
        plane = _smooth_plane(rng, 64, 96, bd)
        for n in (8, 16):
            want = np.asarray(_jit(j_intra_frame._mode_sse, 1, 2)(
                jnp.asarray(plane), n, bd))
            got = intra_frame._mode_sse(_t(plane)[None], n, bd)[0].numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                intra_frame.decide_modes(_t(plane)[None], n, bd)[0].numpy(),
                want.argmin(1))
        # subpel refinement on a padded reference whose content is the
        # source moved by a sub-pel amount (blur of a shift)
        src = _smooth_plane(rng, 64, 96, bd)
        ref = np.roll(src, (1, -2), (0, 1))
        ref = (ref + np.roll(ref, 1, 1) + 1) // 2
        ref_pad = np.pad(ref, 64, mode="edge")
        n = 16
        pos = j_motion.block_positions(64, 96, n)
        mv_full = rng.integers(-3, 4, (pos.shape[0], 2)).astype(np.int32)
        mv_full[:4] = (-1, 2)
        blocks = (src.reshape(4, n, 6, n).transpose(0, 2, 1, 3)
                  .reshape(-1, n, n))
        want = np.asarray(_jit(j_motion.subpel_refine, 4, 5, 6)(
            jnp.asarray(blocks), jnp.asarray(ref_pad), jnp.asarray(pos),
            jnp.asarray(mv_full), n, 64, mx))
        got = motion.subpel_refine(_t(blocks), _t(ref_pad), _t(pos),
                                   _t(mv_full), n, maxval=mx).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got != mv_full * 4).any() and (got == mv_full * 4).any()
        rec = np.clip(src + rng.integers(-9, 10, src.shape) * (bd - 7), 0,
                      mx).astype(np.int32)
        for q in (20, 96, 230):
            on = cdef.cdef_plane(_t(rec), q, bd)
            for a, b in ((rec, on.numpy()), (on.numpy(), rec)):
                assert bool(cdef.cdef_gate(_t(src), _t(a), _t(b))) == bool(
                    _jit(j_cdef.cdef_gate)(jnp.asarray(src), jnp.asarray(a),
                                           jnp.asarray(b)))
        for tiles in (1, 2):
            for r in (rec, src, np.roll(src, 1, 1)):
                assert restoration.choose_mode(_t(src), _t(r), mx,
                                               tiles) == int(
                    _jit(j_lr.choose_mode, 2, 3)(
                        jnp.asarray(src), jnp.asarray(r), mx, tiles))
