"""PyTorch port (av1tpu_torch) vs the JAX package: CDEF.

The direction search, the filter apply with given strengths and the
frame-level strength search of ``specav1/torch_cdef.py`` against
``av1tpu/specav1/jax_cdef.py``, and ``torch_inter.build_skip8`` against
``jax_inter.build_skip8``, on the same seeded numpy planes.  All integer
arithmetic: every output is held exactly.  The search's decision sums
(each candidate's SSE delta) are exact in both packages while they stay
below 2**24, which the search test asserts for its inputs.

The file holds five test items (loops over bit depths and strength
pairs inside them): the test scheduler starts files with few items
last, beside the suite's longest files, instead of before them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.specav1 import jax_cdef, jax_inter
from av1tpu_torch.specav1 import torch_cdef, torch_inter

torch.set_num_threads(1)

# a 16-px strip geometry (144 % 32 == 16) whose width is not a multiple
# of 64, inside the engine's padded planes
PH, PW, TH, TW = 192, 256, 144, 200


def _planes(bd, seed):
    """(rec y, u, v, src y, u, v, skip8): blocky sources with edges in
    several directions, and recons with coding noise on top."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    s = 1 << (bd - 8)
    yy, xx = np.mgrid[0:PH, 0:PW]
    src = 40 * s + (((yy + 2 * xx) // 11) % 5) * 30 * s \
        + np.kron(rng.integers(0, 60 * s, (PH // 16, PW // 16)),
                  np.ones((16, 16), np.int64))
    src_c = [np.kron(rng.integers(20 * s, 200 * s, (PH // 16, PW // 16)),
                     np.ones((8, 8), np.int64)) + ((xx[::2, ::2] // 7) % 3)
             * 9 * s for _ in range(2)]
    srcs = [np.clip(p, 0, mx).astype(np.int32) for p in [src] + src_c]
    recs = [np.clip(p + rng.integers(-9 * s, 10 * s, p.shape), 0,
                    mx).astype(np.int32) for p in srcs]
    # flat and extreme units for the direction search
    recs[0][:8, :8] = 0
    recs[0][8:16, :8] = mx
    recs[0][:8, 8:16] = 77 * s
    skip8 = (rng.random((PH // 8, PW // 8)) < 0.3).astype(np.int32)
    return recs + srcs + [skip8]


def test_find_dir_matches_jax():
    """Direction and variance of random, flat, saturated and directional
    8x8 blocks, 8- and 10-bit."""
    for bd in (8, 10):
        _find_dir_case(bd)


def _find_dir_case(bd):
    rng = np.random.default_rng(bd)
    mx = (1 << bd) - 1
    blk = rng.integers(0, mx + 1, (300, 8, 8)).astype(np.int32)
    blk[0], blk[1], blk[2] = 0, mx, 77
    blk[3] = np.where(np.arange(8)[None, :] < 4, 0, mx)
    blk[4] = np.where(np.add.outer(np.arange(8), np.arange(8)) < 8, mx, 0)
    i, j = np.mgrid[0:8, 0:8]
    for k in range(5, 300, 7):      # line patterns in many directions
        blk[k] = ((i * (k % 5) + j * (k % 3) + k) % 4 * mx // 3)
    want = jax_cdef.find_dir(jnp.asarray(blk), bd - 8)
    got = torch_cdef.find_dir(torch.from_numpy(blk), bd - 8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert len(set(got[0].tolist())) == 8, "not every direction found"


# every Y candidate, each with a UV candidate (all seven appear), plus a
# plane class with pri == 0 and sec > 0 (direction 0 on the decode side)
_PAIRS = [(y, jax_cdef.UV_CANDIDATES[k % 7])
          for k, y in enumerate(jax_cdef.Y_CANDIDATES)] + [((0, 2), (0, 1))]


def test_cdef_apply_matches_jax():
    """Apply with given strengths and damping, skip mask on, for every
    pair of _PAIRS at 8 and 10 bits."""
    for bd in (8, 10):
        for ystr, uvstr in _PAIRS:
            _cdef_apply_case(bd, ystr, uvstr)


def _cdef_apply_case(bd, ystr, uvstr):
    pl = _planes(bd, 11)
    rec, skip8 = pl[:3], pl[6]
    for damping in (3, 6):
        want = jax_cdef.cdef_apply(*(jnp.asarray(p) for p in rec),
                                   jnp.asarray(skip8), *ystr, *uvstr,
                                   damping, bit_depth=bd, th=TH, tw=TW)
        got = torch_cdef.cdef_apply(*(torch.from_numpy(p) for p in rec),
                                    torch.from_numpy(skip8), *ystr, *uvstr,
                                    damping, bit_depth=bd, th=TH, tw=TW)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(w),
                err_msg=f"{bd}-bit {ystr} {uvstr} damping {damping}")
    if ystr != (0, 0):
        assert (got[0].numpy() != rec[0]).any(), "the filter did nothing"


def _search_sse_totals(pl, bd, damping):
    """Each candidate's SSE delta over the search's unit subsample, as
    the port's exact apply gives it: (Y totals, U+V totals)."""
    rec, src, skip8 = pl[:3], pl[3:6], pl[6]

    def sub(p, blk):
        r = (np.arange(p.shape[0]) // blk) % 4 == 0
        c = (np.arange(p.shape[1]) // blk) % 4 == 0
        return p[np.ix_(r, c)].astype(np.int64)

    fh8, fw8 = -(-TH // 8) * 8, -(-TW // 8) * 8
    tot = {"y": [], "uv": []}
    for cands, cls in ((jax_cdef.Y_CANDIDATES, "y"),
                       (jax_cdef.UV_CANDIDATES, "uv")):
        for pri, sec in cands:
            strengths = (pri, sec, 0, 0) if cls == "y" else (0, 0, pri, sec)
            out = torch_cdef.cdef_apply(
                *(torch.from_numpy(p) for p in rec), torch.from_numpy(skip8),
                *strengths, damping, bit_depth=bd, th=TH, tw=TW)
            planes = (0,) if cls == "y" else (1, 2)
            t = 0
            for i in planes:
                h, w = (fh8, fw8) if i == 0 else (fh8 // 2, fw8 // 2)
                blk = 8 if i == 0 else 4
                f = sub(out[i].numpy()[:h, :w], blk)
                x = sub(rec[i][:h, :w], blk)
                s = sub(src[i][:h, :w], blk)
                t += int(((f - s) ** 2 - (x - s) ** 2).sum())
            tot[cls].append(t)
    return tot


@pytest.mark.parametrize("bd", [8, 10])
def test_cdef_search_apply_matches_jax(bd):
    """Frame strengths and filtered planes, exact; every candidate's
    SSE total is below 2**24, where the reference's float32 total is
    exact too."""
    pl = _planes(bd, 5)
    damping = 4
    want = jax_cdef.cdef_search_apply(*(jnp.asarray(p) for p in pl), damping,
                                      bit_depth=bd, th=TH, tw=TW)
    got = torch_cdef.cdef_search_apply(*(torch.from_numpy(p) for p in pl),
                                       damping, bit_depth=bd, th=TH, tw=TW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    strengths = got[3].tolist()
    assert strengths[0] > 0 and strengths[2] > 0, strengths
    tot = _search_sse_totals(pl, bd, damping)
    assert max(abs(t) for t in tot["y"] + tot["uv"]) < 2 ** 24, tot
    # the search's pick is the first minimum of the exact totals
    for cls, cands, k in (("y", jax_cdef.Y_CANDIDATES, 0),
                          ("uv", jax_cdef.UV_CANDIDATES, 2)):
        best = cands[int(np.argmin(tot[cls]))]
        assert tuple(strengths[k:k + 2]) == best, (cls, tot[cls], strengths)


def test_build_skip8_matches_jax():
    """The per-8x8 skip grid from the block skips, the split blocks'
    quadrant skips and the 16-px strip's block skips, each with and
    without the other."""
    for split, th in ((False, 128), (True, 128), (False, 144), (True, 144)):
        _build_skip8_case(split, th)


def _build_skip8_case(split, th):
    rng = np.random.default_rng(th + split)
    gh, gw = 192 // 32, 256 // 32
    skip = rng.integers(0, 2, (gh, gw)).astype(np.int32)
    strip = rng.integers(0, 2, (2 * gw,)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if split:
        sp = rng.integers(0, 2, (gh * gw,)).astype(np.int32)
        s16 = rng.integers(0, 2, (gh * gw, 4)).astype(np.int32)
        kw_j = dict(split=jnp.asarray(sp), skip16=jnp.asarray(s16))
        kw_t = dict(split=torch.from_numpy(sp), skip16=torch.from_numpy(s16))
    want = jax_inter.build_skip8(jnp.asarray(skip), jnp.asarray(strip), th,
                                 TW, 256, **kw_j)
    got = torch_inter.build_skip8(torch.from_numpy(skip),
                                  torch.from_numpy(strip), th, TW, 256,
                                  **kw_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
