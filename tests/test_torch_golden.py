"""PyTorch port (av1tpu_torch) vs the JAX package: the two-reference
(LAST / GOLDEN) P-frame path.

The same seeded numpy inputs go through the JAX function (on the CPU:
the two-plane gathers through their vmap(dynamic_slice) path, Pallas K2
in interpret mode) and through the port's counterpart (the plain PyTorch
version beside each CUDA kernel).  Kernels and primitives are integer,
or float32 whose every sum stays below 2^24, so equality is exact.  The
frame encoder decides in float32 in places (forward transforms), so it
must agree on at least 99% of blocks (every block, at these sizes) with
``refsel`` exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.encoder.kernels import motion as jmotion
from av1tpu.encoder.kernels import pallas_gather, pallas_motion
from av1tpu.specav1 import jax_inter
from av1tpu_torch.encoder.kernels import gather, motion, refine
from av1tpu_torch.spec_engine import state_from_numpy
from av1tpu_torch.specav1 import torch_inter
from av1tpu_torch.utils.cleansrc import clean_frame

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# the golden path's windows: qpel 41/25, split refine regions 32, chroma
# MC 23/15
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("W", [41, 32, 25, 23, 15])
def test_gather_windows2_matches_jax(W, bd):
    """Against gather_windows_ref2 (stacked planes) and against
    make_wide2 + gather_windows_wide (the form the frame encoder uses);
    the plane width is no multiple of 128, so the wide form pads."""
    rng = np.random.default_rng(W * 10 + bd)
    p0, p1 = (rng.integers(0, 1 << bd, (112, 144)).astype(np.int32)
              for _ in range(2))
    B = 37
    oy = rng.integers(0, 112 - W + 1, B).astype(np.int32)
    ox = rng.integers(0, 144 - W + 1, B).astype(np.int32)
    ri = rng.integers(0, 2, B).astype(np.int32)
    assert 0 < ri.sum() < B
    got = gather.gather_windows2(_t(p0), _t(p1), _t(ri), _t(oy), _t(ox), W)
    assert got.dtype == torch.int32 and got.shape == (B, W, W)
    want = pallas_gather.gather_windows_ref2(
        jnp.stack(_j(p0, p1)), *_j(ri, oy, ox), W)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    wide, off = pallas_gather.make_wide2(*_j(p0, p1))
    want = pallas_gather.gather_windows_wide(wide, off, *_j(ri, oy, ox), W)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    # int16 planes (10-bit values fit) give the same windows
    got16 = gather.gather_windows2(_t(p0.astype(np.int16)),
                                   _t(p1.astype(np.int16)), _t(ri), _t(oy),
                                   _t(ox), W)
    assert torch.equal(got16, got)


def test_gather_windows2_clamps_like_one_plane():
    """Origins clamp into a single plane and a selector outside {0, 1}
    clamps to it, as the CUDA entry does."""
    rng = np.random.default_rng(3)
    p0, p1 = (_t(rng.integers(0, 255, (40, 48)).astype(np.int32))
              for _ in range(2))
    oy = torch.tensor([-5, 0, 39, 200], dtype=torch.int32)
    ox = torch.tensor([-1, 47, 30, 7], dtype=torch.int32)
    for r, plane in ((-3, p0), (0, p0), (1, p1), (7, p1)):
        ri = torch.full((4,), r, dtype=torch.int32)
        assert torch.equal(
            gather.gather_windows2(p0, p1, ri, oy, ox, 9),
            gather.gather_windows_plain(plane, oy, ox, 9))


def _two_refs(rng, hp, wp, pad):
    """Two unlike padded reference planes with values below 128."""
    out = []
    for _ in range(2):
        ref = rng.integers(0, 120, (hp, wp)).astype(np.int32)
        out.append(np.pad(ref, pad, mode="edge"))
    return out


@pytest.mark.parametrize("n", [16, 32])
def test_refine_around_seeds2_matches_jax(n):
    """K2 plain over regions from each block's selected plane vs the
    Pallas kernel (interpret mode) over the make_wide2 pair: exact SSDs
    and MVs.  Every SSD is below 2^24 (n^2 * 127^2), where the
    reference's float32 sums are exact."""
    rng = np.random.default_rng(n + 1)
    hp, wp, pad = 96, 160, 64
    r0, r1 = _two_refs(rng, hp, wp, pad)
    pos = motion.block_positions(hp, wp, n)
    B = pos.shape[0]
    seeds = rng.integers(-12, 13, (B, 2)).astype(np.int32)
    ri = rng.integers(0, 2, B).astype(np.int32)
    # blocks cut from the selected reference near their seeds, plus noise
    blocks = np.stack([
        (r1 if r else r0)[p[0] + pad + s[0] + d[0]:
                          p[0] + pad + s[0] + d[0] + n,
                          p[1] + pad + s[1] + d[1]:
                          p[1] + pad + s[1] + d[1] + n]
        for p, s, d, r in zip(pos, seeds, rng.integers(-6, 7, (B, 2)), ri)])
    blocks = np.clip(blocks + rng.integers(-4, 5, blocks.shape), 0, 127)
    assert n * n * 127 ** 2 < 2 ** 24
    refs3 = pallas_gather.make_wide2(*_j(r0, r1)) + (r0.shape[1],)
    mv_j, ssd_j = pallas_motion.refine_around_seeds2(
        jnp.asarray(blocks), refs3, *_j(ri, pos, seeds), n, 8, pad)
    mv_t, ssd_t = refine.refine_around_seeds2(
        _t(blocks.astype(np.int32)), _t(r0), _t(r1), _t(ri), _t(pos),
        _t(seeds), n, 8, pad)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(ssd_t.numpy(), np.asarray(ssd_j))
    # the search found the planted offsets on both planes
    assert (np.abs(mv_t.numpy() - seeds) <= 8).all()
    assert (ssd_t.numpy() < n * n * 40).all()


@pytest.mark.parametrize("n", [16, 32])
def test_gather_blocks_matches_jax(n):
    rng = np.random.default_rng(n + 2)
    hp, wp, pad = 64, 96, 64
    ref_pad = _two_refs(rng, hp, wp, pad)[0]
    pos = motion.block_positions(hp, wp, n)
    # full-pel MVs that reach past the pad on every side (clamped)
    mvs = rng.integers(-90, 91, (pos.shape[0], 2)).astype(np.int32)
    want = jmotion.gather_blocks(*_j(ref_pad, pos, mvs), n)
    got = motion.gather_blocks(_t(ref_pad), _t(pos), _t(mvs), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _blocky(rng, hp, wp, bd, pad):
    ref = rng.integers(0, 1 << bd, (hp // 8, wp // 8))
    ref = np.kron(ref, np.ones((8, 8), np.int64))
    ref = np.clip(ref + rng.integers(-9, 10, ref.shape), 0, (1 << bd) - 1)
    return np.pad(ref.astype(np.int32), pad, mode="edge")


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size,ss", [(16, 1), (8, 1), (32, 0)])
def test_mc_blocks2_matches_jax(size, ss, bd):
    rng = np.random.default_rng(size + bd + 40)
    hp, wp = 64, 96
    pad = 64 >> ss
    r0, r1 = (_blocky(rng, hp, wp, bd, pad) for _ in range(2))
    pos = motion.block_positions(hp, wp, size)
    B = pos.shape[0]
    mvs = rng.integers(-60, 61, (B, 2)).astype(np.int32)
    ri = rng.integers(0, 2, B).astype(np.int32)
    refs3 = pallas_gather.make_wide2(*_j(r0, r1)) + (r0.shape[1],)
    want = jax_inter._mc_blocks2(refs3, *_j(pos, mvs, ri), size, ss, bd)
    got, = torch_inter._mc_blocks((_t(r0),), _t(pos), _t(mvs), size, ss,
                                  bd, (_t(r1),), _t(ri))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a block on plane 0 equals the one-plane MC of plane 0
    one, = torch_inter._mc_blocks((_t(r0),), _t(pos), _t(mvs), size, ss, bd)
    sel = ri == 0
    assert sel.any() and torch.equal(got[_t(sel)], one[_t(sel)])


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", [16, 32])
def test_qpel_refine9_golden_matches_jax(size, bd):
    """Exact predictions and chosen MVs with a per-block reference."""
    rng = np.random.default_rng(size * 5 + bd)
    hp, wp = 64, 96
    r0, r1 = (_blocky(rng, hp, wp, bd, 64) for _ in range(2))
    pos = motion.block_positions(hp, wp, size)
    B = pos.shape[0]
    ri = rng.integers(0, 2, B).astype(np.int32)
    mv8 = rng.integers(-40, 41, (B, 2)).astype(np.int32) * 8
    mv8[ri == 1] = 0            # GOLDEN blocks restart from the zero MV
    src = np.stack([(r1 if r else r0)[p[0] + 64 + m[0] // 8 + 1:
                                      p[0] + 64 + m[0] // 8 + 1 + size,
                                      p[1] + 64 + m[1] // 8:
                                      p[1] + 64 + m[1] // 8 + size]
                    for p, m, r in zip(pos, mv8, ri)])
    refs3 = pallas_gather.make_wide2(*_j(r0, r1)) + (r0.shape[1],)
    mv_j, pred_j = jax_inter._qpel_refine9(
        jnp.asarray(src), refs3, *_j(pos, mv8, ri), size, bd, golden=True)
    mv_t, pred_t = torch_inter._qpel_refine9(
        _t(src), _t(r0), _t(pos), _t(mv8), size, bd, _t(r1), _t(ri))
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))


def _padded(f, s=64):
    h, w = f.y.shape
    ph, pw = (h + s - 1) // s * s, (w + s - 1) // s * s
    return tuple(np.pad(p, ((0, (ph - h) // d), (0, (pw - w) // d)),
                        mode="edge")
                 for p, d in ((f.y, 1), (f.u, 2), (f.v, 2)))


def golden_case(w, h, bd=8):
    """(src, last, golden) SB-padded planes: GOLDEN is the scene the
    source continues, LAST a mix of that scene (left half, shifted) and
    another one (right half), so both references win blocks."""
    gld = _padded(clean_frame(w, h, 0, 0, bd))
    src = _padded(clean_frame(w, h, 1, 0, bd))
    near, far = _padded(clean_frame(w, h, 3, 0, bd)), _padded(
        clean_frame(w, h, 5, 1, bd))
    last = tuple(np.concatenate([a[:, :a.shape[1] // 2],
                                 b[:, b.shape[1] // 2:]], 1)
                 for a, b in zip(near, far))
    return src, [p.astype(np.int32) for p in last], \
        [p.astype(np.int32) for p in gld]


def block_agreement(ref, got, grids, luma, chroma, gh, gw):
    """Fraction of the gh x gw 32x32 blocks on which every grid entry
    and every pixel of the luma/chroma planes agree."""
    nb = gh * gw
    ok = np.ones(nb, bool)
    for i in grids:
        a, b = np.asarray(ref[i]).reshape(nb, -1), got[i].reshape(nb, -1)
        ok &= (a == b).all(1)
    for idx, n in ((luma, 32), (chroma, 16)):
        for i in idx:
            eq = (np.asarray(ref[i]) == got[i])[:gh * n, :gw * n]
            ok &= eq.reshape(gh, n, gw, n).all((1, 3)).reshape(-1)
    return ok.mean()


@pytest.mark.parametrize("w,h", [(128, 64), (128, 144)])
def test_inter_frame_golden_matches_jax(w, h):
    """P-frame encoder with golden=True, all 16 outputs; 144 rows take
    the 16-px bottom-strip path.  The largest block SSD of these inputs
    is asserted below 2^24, where the reference's float32 golden sums
    are exact (above it the port's exact sums could part from them)."""
    src, last, gld = golden_case(w, h)
    ph, pw = src[0].shape
    d = src[0].astype(np.int64) - gld[0]
    big = (d * d).reshape(ph // 32, 32, pw // 32, 32).sum((1, 3)).max()
    assert big < 2 ** 24, big
    want = jax_inter._encode_frame(*_j(*src), *_j(*last), 96, 8, th=h, tw=w,
                                   golden=True, gld_y=jnp.asarray(gld[0]),
                                   gld_u=jnp.asarray(gld[1]),
                                   gld_v=jnp.asarray(gld[2]))
    got = torch_inter.encode_frame(
        *(_t(p) for p in src), *state_from_numpy(*last, "cpu"), 96, 8, th=h,
        tw=w, gld=state_from_numpy(*gld, "cpu"))
    got = [t.numpy() for t in got]
    assert len(got) == len(want) == 16
    for a, b in zip(want, got):
        assert np.asarray(a).shape == b.shape
    np.testing.assert_array_equal(got[14], np.asarray(want[14]))   # refsel
    assert 0 < got[14].sum() < got[14].size, "one reference won every block"
    assert block_agreement(want, got, (0, 1, 11, 12, 13), (2, 5),
                           (3, 4, 6, 7), ph // 32, pw // 32) >= 0.99
    for i in (8, 9, 10, 15):        # strip, cdefs, lr, lr taps
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    # a GOLDEN block's 32x32 MV is within the quarter-pel ring of zero
    assert (np.abs(got[0][got[14] == 1]) <= 2).all()


def test_golden_wrappers_count_only_cuda_launches():
    """On CPU tensors the two-plane wrapper takes the plain version and
    counts no kernel launch."""
    n0 = gather.gather_windows2.launches
    plane = torch.arange(64 * 64, dtype=torch.int32).reshape(64, 64)
    idx = torch.tensor([0, 3], dtype=torch.int32)
    gather.gather_windows2(plane, plane + 1, idx.clamp(0, 1), idx, idx, 32)
    assert gather.gather_windows2.launches == n0
