"""PyTorch port (av1tpu_torch) vs the JAX package: loop restoration.

``specav1/torch_lr.py`` against ``av1tpu/specav1/jax_lr.py`` on the same
seeded numpy planes, the port's tile writer with the restoration-unit
syntax against the JAX package's, and the port's decoder on a stream
with CDEF and LR on.

Tolerances: the Wiener apply is integer arithmetic and is held exactly.
The search's solved taps and per-unit choices come from float32 normal
equations and a float32 3x3 solve: the port sums every term exactly
before one conversion to float32, the reference in float32, so the two
can differ where the reference's sums rounded; the test requires 99% of
the units to agree on choice and taps (exact is expected, and the rate
is printed), and the planes to agree exactly on every unit that agrees.

The file holds five test items (loops over bit depths, presets and
sizes inside them): the test scheduler starts files with few items
last, beside the suite's longest files, instead of before them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.specav1 import jax_lr
from av1tpu.specav1 import native as j_native
from av1tpu_torch import spec_engine
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.specav1 import decoder, torch_lr
from av1tpu_torch.specav1 import lr as lr_mod
from av1tpu_torch.utils import testsrc

torch.set_num_threads(1)


def _planes(h, w, bd, seed, noise=12):
    """(post-CDEF rec, pre-CDEF rec, source): a smooth source with edges,
    a recon with coding noise, and a pre-CDEF plane a little off it."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    s = 1 << (bd - 8)
    yy, xx = np.mgrid[0:h, 0:w]
    src = 60 * s + (yy * 2 + xx) * s // 3 % (120 * s) \
        + np.kron(rng.integers(0, 50 * s, (h // 8 + 1, w // 8 + 1)),
                  np.ones((8, 8), np.int64))[:h, :w]
    src = np.clip(src, 0, mx).astype(np.int32)
    rec = np.clip(src + rng.integers(-noise * s, noise * s + 1, src.shape),
                  0, mx).astype(np.int32)
    pre = np.clip(rec + rng.integers(-3 * s, 3 * s + 1, src.shape), 0,
                  mx).astype(np.int32)
    return rec, pre, src


def test_wiener_apply_matches_jax():
    """Each preset on 136x264, 8- and 10-bit: three stripes with their
    pre-CDEF boundary rows, the last RU row and column merged (136 and
    264 are under 1.5 units of 256); the port filters all presets in one
    batched pass, and alone a preset gives the same plane.  The presets,
    tap ranges and stripe row plans are the reference's."""
    h, w = 136, 264
    for bd in (8, 10):
        rec, pre, _ = _planes(h, w, bd, 3)
        batch = torch_lr.wiener_apply(torch.from_numpy(rec),
                                      torch.from_numpy(pre),
                                      torch_lr.PRESETS, h, w, 0, bd)
        for k, taps in enumerate(jax_lr.PRESETS):
            want = jax_lr.wiener_apply(jnp.asarray(rec), jnp.asarray(pre),
                                       taps, h, w, 0, bd)
            msg = f"{bd}-bit preset {taps}"
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(want),
                                          err_msg=msg)
            one = torch_lr.wiener_apply(torch.from_numpy(rec),
                                        torch.from_numpy(pre), [taps], h, w,
                                        0, bd)
            np.testing.assert_array_equal(one[0].numpy(), np.asarray(want),
                                          err_msg=msg)
    assert torch_lr.PRESETS == jax_lr.PRESETS
    assert torch_lr.TAPS_MIN == jax_lr.TAPS_MIN
    assert torch_lr.TAPS_MAX == jax_lr.TAPS_MAX
    for nh in (136, 144, 264, 720):
        idx, pre = torch_lr._stripe_row_plan(nh, 0)
        jidx, jpre = jax_lr._stripe_row_plan(nh, 0)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(pre, jpre)


def test_lr_search_apply_matches_jax():
    """2 x 2 units at 8 bits, where presets win, and 2 x 3 at 10 bits,
    where the solved taps win; the last row and column merged."""
    for bd, h, w, noise in ((8, 400, 520, 12), (10, 520, 776, 5)):
        _lr_search_case(bd, h, w, noise)


def _lr_search_case(bd, h, w, noise):
    rec, pre, src = _planes(h, w, bd, h + bd, noise)
    want = [np.asarray(a) for a in jax_lr.lr_search_apply(
        jnp.asarray(rec), jnp.asarray(pre), jnp.asarray(src), bit_depth=bd,
        th=h, tw=w)]
    got = [t.numpy() for t in torch_lr.lr_search_apply(
        torch.from_numpy(rec), torch.from_numpy(pre), torch.from_numpy(src),
        bit_depth=bd, th=h, tw=w)]
    assert [g.shape for g in got] == [a.shape for a in want]
    agree = (got[1] == want[1]) & (got[2] == want[2]).all(1)
    print(f"LR {h}x{w} {bd}-bit: {agree.mean():.4f} of {agree.size} units "
          f"agree; choices {got[1].tolist()}")
    assert agree.mean() >= 0.99
    assert (got[1] >= 0).any(), "no unit turned on"
    urows = lr_mod.count_units_in_frame(256, h)
    ucols = lr_mod.count_units_in_frame(256, w)
    assert agree.size == urows * ucols
    ur = np.minimum((np.arange(h) + lr_mod.RESTORATION_UNIT_OFFSET) // 256,
                    urows - 1)
    uc = np.minimum(np.arange(w) // 256, ucols - 1)
    ok = agree[ur[:, None] * ucols + uc[None, :]]
    np.testing.assert_array_equal(got[0][:h, :w][ok], want[0][:h, :w][ok])


def _grainy(w, h, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = testsrc.testsrc2(w, h, i)
        y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                    0, 255).astype(np.uint8)
        out.append(testsrc.Frame(y=y, u=f.u, v=f.v))
    return out


@functools.lru_cache(maxsize=None)
def _default_encode(w, h):
    """(engine, pending frames, recons) of a grainy key + 2 P encoded on
    the CPU by the port in the daemon's default config apart from
    chunking: golden, CDEF, LR."""
    eng = spec_engine.SpecTorchEngine(TpuEncoderConfig(chunk=1),
                                      device="cpu")
    eng.start_stream()
    pend, recons = [], []
    for i, f in enumerate(_grainy(w, h, 3, w + h)):
        pend.append(eng._submit(f, 96, is_key=(i == 0)))
        recons.append(eng._ref)
    return eng, pend, recons


@pytest.mark.parametrize("w,h", [(128, 144), (392, 520)])
def test_tile_writer_lr_matches_jax_package(w, h, monkeypatch):
    """The port's native tile writer with restoration units on gives the
    JAX package's writer's bytes, key and P: one unit in one tile, and
    2 x 2 units over four tile rows (520 rows)."""
    eng, pend, _ = _default_encode(w, h)
    lr_on = [int((p[11][17 if i == 0 else 10] >= 0).sum())
             for i, p in enumerate(pend)]
    assert sum(lr_on) > 0, "no restoration unit turned on"
    got = [eng._finalize(p) for p in pend]
    monkeypatch.setattr(spec_engine, "native", j_native)
    want = [eng._finalize(p) for p in pend]
    assert got == want


def test_decoder_reproduces_cdef_lr_stream():
    """A grainy key + 2 P with CDEF and LR on decodes in the port's
    decoder to the encoder's recon.  LR reads the post-deblock, pre-CDEF
    planes at its stripe boundaries: fed the CDEF output there instead
    (what the decoder did while it refused CDEF), it loses the recon."""
    eng, pend, recons = _default_encode(128, 144)
    payloads = [eng._finalize(p)[0] for p in pend]
    cdefs = [p[11][16 if i == 0 else 9].tolist() for i, p in enumerate(pend)]
    lrs = [int((p[11][17 if i == 0 else 10] >= 0).sum())
           for i, p in enumerate(pend)]
    assert any(map(any, cdefs)) and sum(lrs) > 0, (cdefs, lrs)
    dec = decoder.decode_stream(payloads)
    for d, r in zip(dec, recons):
        for pl in range(3):
            hh, ww = d[pl].shape
            np.testing.assert_array_equal(np.asarray(d[pl], np.int64),
                                          r[pl][:hh, :ww])
    orig = lr_mod.apply_lr_frame

    def post_cdef_source(state, planes, pre, *a):
        return orig(state, planes, planes, *a)

    lr_mod.apply_lr_frame = post_cdef_source
    try:
        bad = decoder.decode_stream(payloads)
    finally:
        lr_mod.apply_lr_frame = orig
    assert any(not np.array_equal(np.asarray(d[0], np.int64),
                                  r[0][:d[0].shape[0], :d[0].shape[1]])
               for d, r in zip(bad, recons))
