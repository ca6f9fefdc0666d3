"""The private av1tpu profile's v1 inter path and its stripe functions in
the PyTorch port (``av1tpu_torch/encoder/kernels/motion.py``'s v1 search,
``legacy/core/inter_frame.py``'s v1 frame, ``legacy/mesh_sharding.py``)
against the JAX package's, on the CPU.

The JAX stripe functions run on the conftest's virtual 8-device mesh; the
port's stripe group is the CPU repeated 8 times.  The shapes are
``tests/test_sharding.py``'s: 512x64 P-frames of 16-px blocks (8 stripes
of 64 rows, the halo depth) and a 256x192 random keyframe (8 stripes of
2 block rows).  Every comparison is exact.  The reference sums SSDs and
gate errors in float32, the port exactly: the tests assert that those
sums stay below 2^24, where float32 is exact too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from av1tpu.encoder import quant as j_quant
from av1tpu.encoder.kernels import motion as j_motion
from av1tpu.legacy import mesh_sharding as j_mesh
from av1tpu.legacy.core import inter_frame as j_if
from av1tpu.utils import testsrc as j_testsrc
from av1tpu_torch.encoder.kernels import motion
from av1tpu_torch.legacy import mesh_sharding as mesh
from av1tpu_torch.legacy.core import inter_frame, intra_frame
from av1tpu_torch.specav1 import stripes

CPU = torch.device("cpu")
GROUP8 = (CPU,) * 8
Q = 96
DC, AC = j_quant.dc_q(Q), j_quant.ac_q(Q)
F24 = 1 << 24


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(got, want, what=""):
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(g, np.int64),
                                  np.asarray(want, np.int64), err_msg=what)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return j_mesh.make_mesh(8)


def _pframes():
    """test_sharding's 512x64 frame pair (testsrc2 frames 0 and 1)."""
    h, w = 8 * 4 * 16, 4 * 16
    return j_testsrc.testsrc2(w, h, 0), j_testsrc.testsrc2(w, h, 1)


def _gate_spy(monkeypatch):
    """Record each stripe's gate sums (CDEF off / on, and each restoration
    mode's) as the port's stripe functions compute them."""
    from av1tpu_torch.encoder.kernels import cdef, restoration
    seen = {"gate": [], "lr": []}
    for mod, name, key in ((cdef, "gate_errors", "gate"),
                           (restoration, "mode_costs", "lr")):
        def spy(*a, real=getattr(mod, name), key=key):
            out = real(*a)
            seen[key].append(out.tolist())
            return out
        monkeypatch.setattr(mod, name, spy)
    return seen


def _frame_sums_below_2_24(seen):
    """8 stripes each; the frame's sums (what the reference adds in
    float32) stay below 2^24."""
    for key, k in (("gate", 2), ("lr", 4)):
        assert len(seen[key]) == 8 and all(len(v) == k for v in seen[key])
        assert max(map(sum, zip(*seen[key]))) < F24


def test_v1_search_frame_and_stripes_match_jax(mesh8, monkeypatch):
    """The v1 path: tss_search on test_inter's known-shift case,
    _ssd_surface, _search_stage_coarse and _search_stage on its blocks,
    search_v2 at 96x128 (its shift scans one dy row a group);
    encode_inter_frame and decode_inter_frame at
    512x64 (decode recon = encode recon); halo_windows against the
    reference's ppermute halo exchange, and encode_inter_frame_sharded over
    8 stripes against the JAX function and the port's one-device frame;
    make_mesh's sizes."""
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 256, (96, 128), np.int32)
    dy, dx = 5, -7
    src = np.roll(np.roll(ref, -dy, axis=0), -dx, axis=1)
    ref_pad = np.asarray(j_motion.pad_ref(jnp.asarray(ref)))
    np.testing.assert_array_equal(motion.pad_ref(_t(ref)).numpy(), ref_pad)
    want = np.asarray(j_motion.tss_search(jnp.asarray(src),
                                          jnp.asarray(ref_pad), 16))
    got = motion.tss_search(_t(src), _t(ref_pad), 16)
    _eq(got, want, "tss_search")
    grid = want.reshape(6, 8, 2)[1:-1, 1:-1]
    assert (grid[..., 0] == dy).all() and (grid[..., 1] == dx).all()
    # one dy row of shifts a group: the running minimum across groups,
    # on a plane of two-level 8x8 tiles too (many shifts tie)
    monkeypatch.setattr(motion, "SCAN_BUDGET", 1)
    _eq(motion.search_v2(_t(src), _t(ref_pad), 16),
        j_motion.search_v2(jnp.asarray(src), jnp.asarray(ref_pad), 16),
        "search_v2")
    tiles = (rng.integers(0, 2, (12, 16)) * 40).repeat(8, 0).repeat(8, 1)
    tpad = np.pad(tiles, 64, mode="edge")
    got = motion._shift_scan_search(_t(np.roll(tiles, 3, 1)), _t(tpad), 16,
                                    16, 64)
    want = j_motion._shift_scan_search(jnp.asarray(np.roll(tiles, 3, 1)),
                                       jnp.asarray(tpad), 16, 16, 64)
    for a, b in zip(got, want):
        _eq(a, b, "_shift_scan_search")
    monkeypatch.undo()
    # the stages on their own, at random seeds within the clamp
    seeds = rng.integers(-40, 41, (48, 2)).astype(np.int32)
    _eq(motion._search_stage(_t(src), _t(ref_pad), 16, 8, _t(seeds)),
        j_motion._search_stage(jnp.asarray(src), jnp.asarray(ref_pad), 16,
                               8, jnp.asarray(seeds)), "_search_stage")
    src_c = np.asarray(j_motion._downsample(jnp.asarray(src), 4))
    ref_c = np.asarray(j_motion._downsample(jnp.asarray(ref_pad), 4))
    _eq(motion._search_stage_coarse(_t(src_c), _t(ref_c), 4, 12),
        j_motion._search_stage_coarse(jnp.asarray(src_c), jnp.asarray(ref_c),
                                      4, 12), "_search_stage_coarse")
    blocks = motion._to_blocks(_t(src), 16)
    regions = torch.stack([_t(ref_pad)[r:r + 32, c:c + 32] for r, c in
                           rng.integers(0, 96, (48, 2))])
    energy = (regions.long() ** 2).unfold(1, 16, 1).unfold(2, 16, 1).sum(
        (-2, -1))
    assert int(energy.max()) < F24 and int((blocks.long() ** 2).sum(
        (1, 2)).max()) < F24
    surf = motion._ssd_surface(blocks, regions)
    assert surf.dtype == torch.float32
    _eq(surf, j_motion._ssd_surface(jnp.asarray(blocks.numpy()),
                                    jnp.asarray(regions.numpy())),
        "_ssd_surface")
    _eq(motion._argmin_2d(surf, 8),
        j_motion._argmin_2d(jnp.asarray(surf.numpy()), 8), "_argmin_2d")
    mv = rng.integers(-9, 10, (64, 2)).astype(np.int32)
    _eq(motion.chroma_mv(_t(mv)), j_motion.chroma_mv(jnp.asarray(mv)))

    # the v1 frame at 512x64 (test_sharding's)
    f0, f1 = _pframes()
    h, w = f1.y.shape
    cur = [p.astype(np.int32) for p in (f1.y, f1.u, f1.v)]
    refs = [p.astype(np.int32) for p in (f0.y, f0.u, f0.v)]
    pads = [np.pad(refs[0], motion.PAD, mode="edge")] + \
        [np.pad(p, motion.CHROMA_PAD, mode="edge") for p in refs[1:]]
    jout = [np.asarray(x) for x in j_if.encode_inter_frame(
        *map(jnp.asarray, cur + pads), DC, AC, 16)]
    tout = inter_frame.encode_inter_frame(*map(_t, cur + pads), DC, AC, 16)
    for i, (a, b) in enumerate(zip(tout, jout)):
        _eq(a, b, f"encode_inter_frame output {i}")
    assert int((tout[0] != 0).any(1).sum()) > 0
    jdec = j_if.decode_inter_frame(*map(jnp.asarray, jout[:4] + pads), DC,
                                   AC, h, w, 16)
    tdec = inter_frame.decode_inter_frame(*tout[:4], *map(_t, pads), DC, AC,
                                          h, w, 16)
    for a, b, c in zip(tdec, jdec, tout[4:]):
        _eq(a, b, "decode_inter_frame")
        assert torch.equal(a, c)

    # halo windows: the reference's ppermute exchange on the mesh
    def halos(y_l):
        return j_mesh._exchange_ref_halos(y_l, 8, motion.PAD)
    want_w = np.asarray(j_mesh.shard_map(
        halos, mesh=mesh8, in_specs=(P(j_mesh.AXIS, None),),
        out_specs=P(j_mesh.AXIS, None))(jnp.asarray(refs[0])))
    parts = stripes.shard_rows(GROUP8, _t(refs[0]))
    sh = h // 8
    for k in range(8):
        _eq(stripes.halo_windows(GROUP8, [parts], k,
                                 [(motion.PAD, h, w, k * sh)])[0],
            want_w[k * (sh + 128):(k + 1) * (sh + 128)], f"halo {k}")

    # the striped v1 frame
    jsh = [np.asarray(x) for x in j_mesh.encode_inter_frame_sharded(
        *map(jnp.asarray, cur + refs), DC, AC, 16, mesh8)]
    tsh = mesh.encode_inter_frame_sharded(*map(_t, cur + refs), DC, AC, 16,
                                          mesh.make_mesh(8, "cpu"))
    assert len(tsh) == 8
    for i, (a, b, c) in enumerate(zip(tsh, jsh, tout)):
        _eq(a, b, f"encode_inter_frame_sharded output {i}")
        if i < 7:
            assert torch.equal(a, c)
    assert int(tsh[7]) == int(jsh[7]) == int(sum((lv != 0).sum()
                                                 for lv in tout[1:4]))
    with pytest.raises(ValueError):
        mesh.encode_inter_frame_sharded(*map(_t, cur + refs), DC, AC, 16,
                                        (CPU,) * 16)

    assert mesh.make_mesh(1, "cpu") == (CPU,)
    assert mesh.make_mesh(0, "cpu") == (CPU,)
    assert mesh.make_mesh(8, "cpu") == GROUP8
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            mesh.make_mesh(0)
    with pytest.raises(ValueError):
        mesh.make_mesh(1000)


def test_striped_v2_pframe_matches_jax_and_one_device(mesh8, monkeypatch):
    """encode_inter_frame_sharded_v2 at 512x64, 16-px blocks, 8 stripes:
    every output equals the JAX function on the mesh and the port's
    one-device encode_inter_frame_v2 with tile_rows=8."""
    seen = _gate_spy(monkeypatch)
    f0, f1 = _pframes()
    planes = (f1.y, f1.u, f1.v, f0.y, f0.u, f0.v)
    jout = [np.asarray(x) for x in j_mesh.encode_inter_frame_sharded_v2(
        *map(jnp.asarray, planes), DC, AC, Q, 16, mesh8)]
    tout = mesh.encode_inter_frame_sharded_v2(*map(_t, planes), DC, AC, Q,
                                              16, GROUP8)
    _frame_sums_below_2_24(seen)
    one = inter_frame.encode_inter_frame_v2(*map(_t, planes), DC, AC, Q, 16,
                                            8, 8)
    assert len(tout) == len(jout) == 11
    assert tout[5].dtype == torch.uint8
    names = ("mvs", "levels y", "levels u", "levels v", "skips", "recon y",
             "recon u", "recon v", "lr_mode", "cdef_on", "tx_syms")
    # the one-device tuple: the same order, with the sparse pack and the
    # reference selectors between cdef_on and tx_syms
    for i, nm in enumerate(names):
        _eq(tout[i], jout[i], nm)
        _eq(tout[i], one[14 if i == 10 else i], nm + " (one device)")
    assert int((tout[0] != 0).any(1).sum()) > 0


def test_striped_v2_keyframe_matches_jax_and_one_device(mesh8, monkeypatch):
    """encode_key_frame_sharded_v2 at 256x192, n=16, 8 stripes (random
    planes, test_sharding's): every output equals the JAX function on the
    mesh and the port's one-device encode_key_frame_v2 with
    tile_rows=8."""
    seen = _gate_spy(monkeypatch)
    rng = np.random.default_rng(7)
    H, W, n = 256, 192, 16
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    u = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    jout = [np.asarray(x) for x in j_mesh.encode_key_frame_sharded_v2(
        *map(jnp.asarray, (y, u, v)), DC, AC, Q, n, mesh8)]
    tout = mesh.encode_key_frame_sharded_v2(*map(_t, (y, u, v)), DC, AC, Q,
                                            n, GROUP8)
    _frame_sums_below_2_24(seen)
    one = intra_frame.encode_key_frame_v2(*map(_t, (y, u, v)), DC, AC, Q, n,
                                          8, 8)
    assert len(tout) == len(jout) == 11
    names = ("y modes", "levels y", "levels u", "levels v", "skips",
             "recon y", "recon u", "recon v", "lr_mode", "cdef_on",
             "uv modes")
    for i, nm in enumerate(names):
        _eq(tout[i], jout[i], nm)
        _eq(tout[i], one[13 if i == 10 else i], nm + " (one device)")
