"""PyTorch port (av1tpu_torch) vs the JAX package: the deblocking loop
filter (spec 7.14) and the encoders' filtered outputs.

All of it is integer arithmetic, so every comparison is exact; only the
P-frame encoder around the filter decides in float32 in places, and
there the blocks must agree at 99% (every block, at this size).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.specav1 import jax_inter
from av1tpu.specav1 import loopfilter as jlf
from av1tpu_torch.spec_engine import lf_levels, state_from_numpy
from av1tpu_torch.specav1 import loopfilter, torch_inter
from test_torch_golden import block_agreement, golden_case

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edge_lines(bd, n=600):
    """(n, 7) P and Q samples around an edge: flat on both sides with a
    small step (the wide filters), near flat, ramps, and random lines."""
    rng = np.random.default_rng(bd)
    mx = (1 << bd) - 1
    s = 1 << (bd - 8)
    base = rng.integers(20 * s, mx - 20 * s, (n, 1))
    step = rng.integers(-6 * s, 7 * s, (n, 1))
    kind = np.arange(n) % 4
    wob = rng.integers(-1, 2, (n, 14)) * s * (kind[:, None] == 1) + \
        rng.integers(-4 * s, 4 * s + 1, (n, 14)) * (kind[:, None] == 2)
    line = base + np.concatenate([np.zeros((n, 7), int),
                                  np.repeat(step, 7, 1)], 1) + wob
    rnd = rng.integers(0, mx + 1, (n, 14))
    line = np.where(kind[:, None] == 3, rnd, line)
    line = np.clip(line, 0, mx).astype(np.int32)
    return line[:, :7], line[:, 7:]


@functools.lru_cache(maxsize=None)
def _jax_taps(size, bd, level):
    """The JAX package's jnp and numpy forms on the shared lines."""
    P, Q = _edge_lines(bd)
    th = jlf.thresholds(level)
    a = jlf._filter_taps(jnp.asarray(P), jnp.asarray(Q), *th, size, bd)
    b = jlf._filter_taps(P, Q, *th, size, bd, xp=np)
    return [np.asarray(x) for x in a], [np.asarray(x) for x in b]


@pytest.mark.parametrize("form", ["torch", "numpy"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", [4, 6, 8, 14])
def test_filter_taps_matches_jax(size, bd, form):
    """One statement of the tap formulas, on torch tensors (encoders)
    and on numpy arrays (decoder), against the JAX package's jnp and
    numpy forms, at a low and a high level."""
    P, Q = _edge_lines(bd)
    changed = 0
    for level in (3, 40):
        th = loopfilter.thresholds(level)
        assert th == jlf.thresholds(level)
        if form == "torch":
            nP, nQ = loopfilter._filter_taps(_t(P), _t(Q), *th, size, bd,
                                             torch)
            assert nP.dtype == torch.int32
            nP, nQ = nP.numpy(), nQ.numpy()
        else:
            nP, nQ = loopfilter._filter_taps(P, Q, *th, size, bd, np)
        for want in _jax_taps(size, bd, level):
            np.testing.assert_array_equal(nP, want[0])
            np.testing.assert_array_equal(nQ, want[1])
        changed += int((nP != P).any(1).sum())
    assert changed > 100, "the lines never trigger the filter"


def _blocky_planes(rng, h, w, bd):
    """Planes of constant 16x16 (luma) / 8x8 (chroma) tiles plus a little
    noise on half of them: flat edges and busy edges."""
    mx = (1 << bd) - 1
    s = 1 << (bd - 8)
    out = []
    for hh, ww, n in ((h, w, 16), (h // 2, w // 2, 8), (h // 2, w // 2, 8)):
        tiles = rng.integers(100 * s, 108 * s, (hh // n, ww // n))
        p = np.kron(tiles, np.ones((n, n), np.int64))
        p = p + rng.integers(-6 * s, 7 * s, tiles.shape).repeat(n, 0) \
            .repeat(n, 1) * (np.arange(ww) % n > n // 2)
        busy = rng.integers(0, 2, tiles.shape).repeat(n, 0).repeat(n, 1)
        p = p + busy * rng.integers(-3 * s, 3 * s + 1, p.shape)
        out.append(np.clip(p, 0, mx).astype(np.int32))
    return out


# (mode, th, tw): the coded dims sit inside the 128x128 planes, so the
# bounds on the edges count
_MODES = {"uniform": (128, 120), "split": (96, 128), "strip": (112, 128)}


@pytest.mark.parametrize("bd,level", [(8, 0), (8, 1), (8, 17), (8, 63),
                                      (10, 17)])
@pytest.mark.parametrize("mode", list(_MODES))
def test_deblock_frame_matches_jax(mode, bd, level):
    """deblock_frame on the uniform grid, with a random split grid, and
    with the strip rows (th % 32 == 16, with a split grid too)."""
    th, tw = _MODES[mode]
    rng = np.random.default_rng(len(mode) * 100 + bd + level)
    y, u, v = _blocky_planes(rng, 128, 128, bd)
    split = None
    if mode != "uniform":
        split = rng.integers(0, 2, (4, 4)).astype(np.int32)
        assert 0 < split.sum() < 16
    strip = mode == "strip"
    luv = max(level - 5, 0) if level else 0
    want = jlf.deblock_frame(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.int32(level),
        jnp.int32(luv), jnp.int32(luv), bd, th, tw,
        split=None if split is None else jnp.asarray(split), strip=strip)
    got = loopfilter.deblock_frame(
        _t(y), _t(u), _t(v), level, luv, luv, bd, th, tw,
        split=None if split is None else _t(split), strip=strip)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    if level == 0:
        assert torch.equal(got[0], _t(y))
    else:
        assert (got[0].numpy() != y).sum() > (50 if level > 1 else 0)
    if mode == "strip" and level:
        # strip=True alone builds a zero split grid
        want = jlf.deblock_frame(jnp.asarray(y), jnp.asarray(u),
                                 jnp.asarray(v), jnp.int32(level),
                                 jnp.int32(luv), jnp.int32(luv), bd, th, tw,
                                 strip=True)
        got = loopfilter.deblock_frame(_t(y), _t(u), _t(v), level, luv, luv,
                                       bd, th, tw, strip=True)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_deblock_frame_distinct_chroma_levels():
    """U and V at different levels take a pass each instead of one pass
    over the stacked pair; same values as the JAX package's either way."""
    rng = np.random.default_rng(77)
    y, u, v = _blocky_planes(rng, 128, 128, 8)
    split = rng.integers(0, 2, (4, 4)).astype(np.int32)
    want = jlf.deblock_frame(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.int32(20),
        jnp.int32(9), jnp.int32(31), 8, 112, 128, split=jnp.asarray(split),
        strip=True)
    got = loopfilter.deblock_frame(_t(y), _t(u), _t(v), 20, 9, 31, 8, 112,
                                   128, split=_t(split), strip=True)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert not torch.equal(got[1], _t(u)) and not torch.equal(got[2], _t(v))


@pytest.mark.parametrize("bd", [8, 10])
def test_general_deblock_matches_jax(bd):
    """The decoder's numpy path from per-4x4 grids (uniform 32x32 blocks,
    a few split into 16x16, random skip/inter flags, different vertical
    and horizontal levels) against the JAX package's, and against the
    encoder-side deblock_frame where the two describe one grid."""
    rng = np.random.default_rng(bd)
    h = w = 128
    planes = _blocky_planes(rng, h, w, bd)
    split = rng.integers(0, 2, (4, 4)).astype(np.int32)
    n4 = np.where(split.repeat(8, 0).repeat(8, 1) == 1, 4, 8).astype(
        np.int32)
    skips = rng.integers(0, 2, (4, 4)).repeat(8, 0).repeat(8, 1)
    inter = rng.integers(0, 2, (4, 4)).repeat(8, 0).repeat(8, 1)
    uv = np.maximum(n4[1::2, 1::2] >> 1, 1)
    args = (0, n4, n4, n4, n4, skips, inter, uv, uv, bd)
    got = loopfilter.deblock_frame_general(planes, (9, 14, 6, 11), *args)
    want = jlf.deblock_frame_general(planes, (9, 14, 6, 11), *args)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert (got[0] != planes[0]).sum() > 50
    # one level per plane, every edge a block edge: the encoder's filter
    got = loopfilter.deblock_frame_general(planes, (12, 12, 7, 7), *args)
    enc = loopfilter.deblock_frame(*(_t(p) for p in planes), 12, 7, 7, bd,
                                   h, w, split=_t(split))
    for g, e in zip(got, enc):
        np.testing.assert_array_equal(g, e.numpy())


def test_lf_levels_match_jax():
    from av1tpu.spec_engine import lf_levels as j_lf_levels
    for bd in (8, 10):
        for q in range(0, 256, 5):
            assert lf_levels(q, bd) == j_lf_levels(q, bd)
    assert lf_levels(96, 8) == (12, 12)


@pytest.mark.parametrize("w,h,bd", [(128, 144, 8), (128, 64, 10)])
def test_inter_frame_deblock_matches_jax(w, h, bd):
    """P-frame encoder with golden=True and deblock=True: the filter
    runs over the uniform grid, the RD-chosen split grid and (144 rows)
    the 16-px strip, on the recon both encoders return; 8 and 10 bits."""
    src, last, gld = golden_case(w, h, bd)
    ph, pw = src[0].shape
    lfy, lfuv = lf_levels(96, bd)
    want = jax_inter._encode_frame(
        *(jnp.asarray(p) for p in src), *(jnp.asarray(p) for p in last), 96,
        bd, th=h, tw=w, lf_y=jnp.int32(lfy), lf_uv=jnp.int32(lfuv),
        deblock=True, golden=True, gld_y=jnp.asarray(gld[0]),
        gld_u=jnp.asarray(gld[1]), gld_v=jnp.asarray(gld[2]))
    dt = np.uint8 if bd == 8 else np.int16
    args = (*(_t(p.astype(dt)) for p in src),
            *state_from_numpy(*last, "cpu"), 96, bd)
    kw = dict(th=h, tw=w, gld=state_from_numpy(*gld, "cpu"))
    got = [t.numpy() for t in torch_inter.encode_frame(
        *args, **kw, lf_y=lfy, lf_uv=lfuv, deblock=True)]
    np.testing.assert_array_equal(got[14], np.asarray(want[14]))
    assert block_agreement(want, got, (0, 1, 11, 12, 13), (2,), (3, 4),
                           ph // 32, pw // 32) >= 0.99
    for i in (5, 6, 7):             # the filtered recon, whole planes
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    plain = torch_inter.encode_frame(*args, **kw)
    assert (plain[5].numpy() != got[5]).sum() > 50, "the filter did nothing"
    for i in (0, 1, 2, 3, 4, 11, 12, 13, 14):   # decisions are unfiltered
        np.testing.assert_array_equal(plain[i].numpy(), got[i])
