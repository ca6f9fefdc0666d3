"""PyTorch port (av1tpu_torch) vs the JAX package, kernel by kernel.

The same seeded numpy inputs go through the JAX function (on the CPU:
Pallas K2 in interpret mode, K1 through its vmap(dynamic_slice) path)
and through the port's counterpart (on the CPU: the plain PyTorch
version beside each CUDA kernel).  All of these are integer, or float32
whose every sum is below 2^24, so equality is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.encoder.kernels import motion as jmotion
from av1tpu.encoder.kernels import pallas_gather, pallas_motion
from av1tpu.specav1 import jax_inter, jax_intra
from av1tpu_torch.encoder.kernels import gather, motion, refine
from av1tpu_torch.specav1 import torch_inter, transforms
from av1tpu_torch.spec_engine import pack_outputs

torch.set_num_threads(1)

# main-path window widths: refine regions 48/32, qpel 41/25, chroma MC 23/15
WIDTHS = (48, 32, 41, 25, 23, 15)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("W", WIDTHS)
def test_gather_windows_matches_jax(W, bd):
    rng = np.random.default_rng(W * 10 + bd)
    plane = rng.integers(0, 1 << bd, (112, 144)).astype(np.int32)
    B = 37
    oy = rng.integers(0, 112 - W + 1, B).astype(np.int32)
    ox = rng.integers(0, 144 - W + 1, B).astype(np.int32)
    want = np.asarray(pallas_gather.gather_windows(
        jnp.asarray(plane), jnp.asarray(oy), jnp.asarray(ox), W))
    got = gather.gather_windows(_t(plane), _t(oy), _t(ox), W)
    assert got.dtype == torch.int32 and got.shape == (B, W, W)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("n", [16, 32])
def test_refine_around_seeds_matches_jax(n):
    """K2 plain + refine_around_seeds vs the Pallas kernel in interpret
    mode: exact SSDs and MVs.  Precondition: every displacement's SSD is
    below 2^24, where the reference's float32 sums are exact."""
    rng = np.random.default_rng(n)
    hp, wp = 96, 160
    ref = rng.integers(0, 120, (hp, wp)).astype(np.int32)
    pad = 64
    ref_pad = np.pad(ref, pad, mode="edge")
    pos = motion.block_positions(hp, wp, n)
    B = pos.shape[0]
    seeds = rng.integers(-12, 13, (B, 2)).astype(np.int32)
    # blocks cut from the reference near their seeds, plus noise
    blocks = np.stack([
        ref_pad[p[0] + pad + s[0] + d[0]:p[0] + pad + s[0] + d[0] + n,
                p[1] + pad + s[1] + d[1]:p[1] + pad + s[1] + d[1] + n]
        for p, s, d in zip(pos, seeds, rng.integers(-6, 7, (B, 2)))])
    blocks = np.clip(blocks + rng.integers(-4, 5, blocks.shape), 0, 127)
    assert n * n * 127 ** 2 < 2 ** 24
    mv_j, ssd_j = pallas_motion.refine_around_seeds(
        jnp.asarray(blocks), jnp.asarray(ref_pad), jnp.asarray(pos),
        jnp.asarray(seeds), n, 8, pad)
    mv_t, ssd_t = refine.refine_around_seeds(
        _t(blocks.astype(np.int32)), _t(ref_pad), _t(pos), _t(seeds), n, 8,
        pad)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(ssd_t.numpy(), np.asarray(ssd_j))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n,row,col", [
    (8, "dct", "dct"), (8, "dct", "adst"), (8, "adst", "dct"),
    (8, "adst", "adst"), (16, "dct", "dct"), (16, "dct", "adst"),
    (16, "adst", "dct"), (16, "adst", "adst"), (32, "dct", "dct")])
def test_inverse_transform_bitexact(n, row, col, bd):
    """Spec integer inverse transforms: exact for random dequantized
    levels (including values that hit the intermediate clamps)."""
    rng = np.random.default_rng(n * 100 + bd)
    B = 12
    dq = rng.integers(-(1 << (bd + 6)), 1 << (bd + 6),
                      (B, n, n)).astype(np.int32)
    dq[:4] //= 64
    pred = rng.integers(0, 1 << bd, (B, n, n)).astype(np.int32)
    want = np.asarray(jax_intra.inv_tx2d_add(
        jnp.asarray(dq), jnp.asarray(pred), bd, row_kind=row,
        col_kind=col))
    got = transforms.inv_tx2d_add(_t(dq), _t(pred), bd, row_kind=row,
                                  col_kind=col)
    np.testing.assert_array_equal(got.numpy(), want)
    if n < 32:
        mixed = transforms.inv_tx2d_add_mixed(
            _t(dq), _t(pred), bd, torch.full((B,), row == "adst"),
            torch.full((B,), col == "adst"))
        np.testing.assert_array_equal(mixed.numpy(), want)
    np.testing.assert_array_equal(transforms._fwd_mat_kind(row, n),
                                  jax_intra._fwd_mat_kind(row, n))


def _ref_plane(rng, hp, wp, bd, pad):
    ref = rng.integers(0, 1 << bd, (hp // 8, wp // 8))
    ref = np.kron(ref, np.ones((8, 8), np.int64))        # blocky texture
    ref = np.clip(ref + rng.integers(-9, 10, ref.shape), 0, (1 << bd) - 1)
    return np.pad(ref.astype(np.int32), pad, mode="edge")


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size,ss", [(16, 1), (8, 1), (32, 0)])
def test_mc_blocks_matches_jax(size, ss, bd):
    rng = np.random.default_rng(size + bd)
    hp, wp = 64, 96
    pad = 64 >> ss
    ref_pad = _ref_plane(rng, hp, wp, bd, pad)
    pos = motion.block_positions(hp, wp, size)
    mvs = rng.integers(-60, 61, (pos.shape[0], 2)).astype(np.int32)
    want = np.asarray(jax_inter._mc_blocks(
        jnp.asarray(ref_pad), jnp.asarray(pos), jnp.asarray(mvs), size, ss,
        bd))
    got, = torch_inter._mc_blocks((_t(ref_pad),), _t(pos), _t(mvs), size,
                                  ss, bd)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", [16, 32])
def test_qpel_refine9_matches_jax(size, bd):
    """Exact predictions and chosen MVs (the reference's band-matrix
    float32 matmuls are exact, so integer 8-tap filtering agrees)."""
    rng = np.random.default_rng(size * 3 + bd)
    hp, wp = 64, 96
    ref_pad = _ref_plane(rng, hp, wp, bd, 64)
    pos = motion.block_positions(hp, wp, size)
    B = pos.shape[0]
    mv8 = rng.integers(-40, 41, (B, 2)).astype(np.int32) * 8
    src = np.stack([ref_pad[p[0] + 64 + m[0] // 8 + 1:
                            p[0] + 64 + m[0] // 8 + 1 + size,
                            p[1] + 64 + m[1] // 8:
                            p[1] + 64 + m[1] // 8 + size]
                    for p, m in zip(pos, mv8)])
    mv_j, pred_j = jax_inter._qpel_refine9(
        jnp.asarray(src), jnp.asarray(ref_pad), jnp.asarray(pos),
        jnp.asarray(mv8), jnp.zeros((B,), jnp.int32), size, bd)
    mv_t, pred_t = torch_inter._qpel_refine9(_t(src), _t(ref_pad), _t(pos),
                                             _t(mv8), size, bd)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))


def test_search_v3_matches_jax():
    """Full-pel search: coarse shift scan + two K2 refines + zero bias.
    The content keeps every float32 sum of the reference below 2^24."""
    rng = np.random.default_rng(5)
    hp, wp = 128, 192
    base = rng.integers(0, 100, (hp // 4, wp // 4))
    frame0 = np.kron(base, np.ones((4, 4), np.int64))
    frame0 = np.clip(frame0 + rng.integers(-3, 4, frame0.shape), 0, 110)
    src = np.roll(frame0, (5, -20), axis=(0, 1))
    src = np.clip(src + rng.integers(-3, 4, src.shape), 0, 110)
    ref_pad = np.pad(frame0.astype(np.int32), 64, mode="edge")
    want = np.asarray(jmotion.search_v3(jnp.asarray(src.astype(np.int32)),
                                        jnp.asarray(ref_pad), 32))
    got = motion.search_v3(_t(src.astype(np.int32)), _t(ref_pad), 32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()


def test_pack_outputs_byte_identical():
    from av1tpu import spec_engine as jse
    rng = np.random.default_rng(9)
    lv = [rng.integers(-3, 4, s) * (rng.random(s) < 0.05)
          for s in ((64, 96), (32, 48), (32, 48))]
    lv = [a.astype(np.int32) for a in lv]
    lv[0][0, 0] = 40000      # saturates to int16
    grids = rng.integers(-5, 5, 77).astype(np.int32)
    for cap in (1000, 50):   # fits / overflows the value capacity
        mj, vj, cj, gj = jax.device_get(jse._pack_outputs(
            *(jnp.asarray(a) for a in lv), jnp.asarray(grids), cap))
        mt, vt, ct, gt = pack_outputs(*(_t(a) for a in lv), _t(grids), cap)
        assert mt.numpy().tobytes() == np.asarray(mj).tobytes()
        assert vt.numpy().tobytes() == np.asarray(vj).tobytes()
        assert int(ct) == int(cj)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_kernel_wrappers_count_only_cuda_launches():
    """On CPU tensors the wrappers take the plain version and count no
    kernel launch."""
    g0, r0 = gather.gather_windows.launches, refine.refine_ssd.launches
    plane = torch.arange(64 * 64, dtype=torch.int32).reshape(64, 64)
    idx = torch.tensor([0, 3], dtype=torch.int32)
    gather.gather_windows(plane, idx, idx, 32)
    refine.refine_ssd(torch.zeros((2, 16, 16), dtype=torch.int32),
                      torch.zeros((2, 32, 32), dtype=torch.int32), 16, 8)
    assert gather.gather_windows.launches == g0
    assert refine.refine_ssd.launches == r0
