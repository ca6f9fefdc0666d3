"""PyTorch port (av1tpu_torch) vs the JAX package: K1's plane dimension
(U and V in one launch) and the U+V chroma motion compensation.

The same seeded numpy inputs go through the JAX function (on the CPU:
K1 through its vmap(dynamic_slice) path) and through the port's plain
PyTorch version, plane by plane.  Everything here is integer, so
equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.encoder.kernels import pallas_gather
from av1tpu.specav1 import jax_inter
from av1tpu_torch.encoder.kernels import gather, motion
from av1tpu_torch.specav1 import torch_inter

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("W", [41, 23, 15])
def test_gather_uv_matches_jax_per_plane(W, bd):
    """(P, B, W, W) from U and V in one call: plane j of the one-plane
    form equals pallas_gather.gather_windows on plane j, and plane j of
    the two-plane form equals gather_windows_ref2 and make_wide2 +
    gather_windows_wide on that plane's (LAST, GOLDEN) pair."""
    rng = np.random.default_rng(W * 3 + bd)
    lu, lv, gu, gv = (rng.integers(0, 1 << bd, (72, 136)).astype(np.int32)
                      for _ in range(4))
    B = 29
    oy = rng.integers(0, 72 - W + 1, B).astype(np.int32)
    ox = rng.integers(0, 136 - W + 1, B).astype(np.int32)
    ri = rng.integers(0, 2, B).astype(np.int32)
    assert 0 < ri.sum() < B
    one = gather.gather_windows((_t(lu), _t(lv)), _t(oy), _t(ox), W)
    two = gather.gather_windows2((_t(lu), _t(lv)), (_t(gu), _t(gv)), _t(ri),
                                 _t(oy), _t(ox), W)
    assert one.shape == two.shape == (2, B, W, W)
    assert one.dtype == two.dtype == torch.int32
    for j, (last, gold) in enumerate(((lu, gu), (lv, gv))):
        want = pallas_gather.gather_windows(*_j(last, oy, ox), W)
        np.testing.assert_array_equal(one[j].numpy(),
                                      np.asarray(want).astype(np.int32))
        want = pallas_gather.gather_windows_ref2(
            jnp.stack(_j(last, gold)), *_j(ri, oy, ox), W)
        np.testing.assert_array_equal(two[j].numpy(),
                                      np.asarray(want).astype(np.int32))
        wide, off = pallas_gather.make_wide2(*_j(last, gold))
        want = pallas_gather.gather_windows_wide(wide, off, *_j(ri, oy, ox),
                                                 W)
        np.testing.assert_array_equal(two[j].numpy(),
                                      np.asarray(want).astype(np.int32))
    # int16 planes give the same windows
    one16 = gather.gather_windows((_t(lu.astype(np.int16)),
                                   _t(lv.astype(np.int16))), _t(oy), _t(ox),
                                  W)
    assert torch.equal(one16, one)


def _blocky(rng, hp, wp, bd, pad):
    ref = rng.integers(0, 1 << bd, (hp // 8, wp // 8))
    ref = np.kron(ref, np.ones((8, 8), np.int64))
    ref = np.clip(ref + rng.integers(-9, 10, ref.shape), 0, (1 << bd) - 1)
    return np.pad(ref.astype(np.int32), pad, mode="edge")


@pytest.mark.parametrize("golden", [False, True], ids=["one-ref", "two-ref"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", [16, 8])
def test_mc_blocks_uv_matches_jax(size, bd, golden):
    """The U+V _mc_blocks (one gather, one 8-tap pass for both planes)
    against jax_inter._mc_blocks (one reference) or _mc_blocks2 (LAST /
    GOLDEN per block) run on U and on V separately."""
    rng = np.random.default_rng(size * 7 + bd + golden)
    hp, wp = 32, 48                       # chroma planes of a 64x96 frame
    pad = 32
    lu, lv, gu, gv = (_blocky(rng, hp, wp, bd, pad) for _ in range(4))
    pos = motion.block_positions(hp, wp, size)
    B = pos.shape[0]
    mvs = rng.integers(-60, 61, (B, 2)).astype(np.int32)
    ri = rng.integers(0, 2, B).astype(np.int32)
    if golden:
        got = torch_inter._mc_blocks((_t(lu), _t(lv)), _t(pos), _t(mvs),
                                     size, 1, bd, (_t(gu), _t(gv)), _t(ri))
    else:
        got = torch_inter._mc_blocks((_t(lu), _t(lv)), _t(pos), _t(mvs),
                                     size, 1, bd)
    assert len(got) == 2
    for pred, last, gold in zip(got, (lu, lv), (gu, gv)):
        if golden:
            refs3 = pallas_gather.make_wide2(*_j(last, gold)) + (wp + 2 * pad,)
            want = jax_inter._mc_blocks2(refs3, *_j(pos, mvs, ri), size, 1,
                                         bd)
        else:
            want = jax_inter._mc_blocks(*_j(last, pos, mvs), size, 1, bd)
        assert pred.dtype == torch.int32 and pred.shape == (B, size, size)
        np.testing.assert_array_equal(pred.numpy(), np.asarray(want))
