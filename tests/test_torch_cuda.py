"""On-card checks of the PyTorch port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device.  This file imports no JAX, so it runs
on a machine that has only PyTorch; tests/conftest.py imports JAX, so
run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from av1tpu_torch.encoder.kernels import gather, refine


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_gather_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    plane = torch.as_tensor(rng.integers(0, 1024, (608, 1024)), dtype=dtype,
                            device=cuda)
    for W, B in ((48, 300), (41, 300), (23, 300), (15, 1000)):
        oy = torch.as_tensor(rng.integers(0, 608 - W + 1, B),
                             dtype=torch.int32, device=cuda)
        ox = torch.as_tensor(rng.integers(0, 1024 - W + 1, B),
                             dtype=torch.int32, device=cuda)
        n0 = gather.gather_windows.launches
        got = gather.gather_windows(plane, oy, ox, W)
        assert gather.gather_windows.launches == n0 + 1
        assert torch.equal(got, gather.gather_windows_plain(plane, oy, ox,
                                                            W))


def _pair(rng, dtype, dev, hp=608, wp=1024):
    return [torch.as_tensor(rng.integers(0, 1024, (hp, wp)), dtype=dtype,
                            device=dev) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("sel", ["last", "golden", "mixed"])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_gather2_kernel_matches_plain(cuda, dtype, sel):
    """Two-plane K1 at the golden path's widths, ragged block counts,
    with every block on plane 0, on plane 1, and mixed."""
    rng = np.random.default_rng(11)
    p0, p1 = _pair(rng, dtype, cuda)
    for W, B in ((41, 301), (32, 1003), (25, 1003), (23, 301), (15, 1003)):
        oy = torch.as_tensor(rng.integers(0, 608 - W + 1, B),
                             dtype=torch.int32, device=cuda)
        ox = torch.as_tensor(rng.integers(0, 1024 - W + 1, B),
                             dtype=torch.int32, device=cuda)
        ri = {"last": torch.zeros(B), "golden": torch.ones(B),
              "mixed": torch.as_tensor(rng.integers(0, 2, B))}[sel] \
            .to(dtype=torch.int32, device=cuda)
        n0 = gather.gather_windows2.launches
        got = gather.gather_windows2(p0, p1, ri, oy, ox, W)
        assert gather.gather_windows2.launches == n0 + 1
        assert torch.equal(got, gather.gather_windows2_plain(p0, p1, ri, oy,
                                                             ox, W))
        one = gather.gather_windows_plain(p1 if sel == "golden" else p0, oy,
                                          ox, W)
        if sel != "mixed":
            assert torch.equal(got, one)


@pytest.mark.cuda
def test_gather2_kernel_clamps_origins_and_selector(cuda):
    """Origins at and beyond every edge clamp into a single plane, and a
    selector outside {0, 1} clamps to it: nothing reads out of bounds."""
    rng = np.random.default_rng(12)
    p0, p1 = _pair(rng, torch.int32, cuda, 96, 160)
    W = 25
    ys = [-7, 0, 96 - W, 96 - W + 1, 96, 500]
    xs = [-3, 0, 160 - W, 160 - W + 1, 160, 900]
    oy = torch.tensor([y for y in ys for _ in xs], dtype=torch.int32,
                      device=cuda)
    ox = torch.tensor(xs * len(ys), dtype=torch.int32, device=cuda)
    ri = torch.as_tensor(rng.integers(-2, 4, oy.shape[0]), dtype=torch.int32,
                         device=cuda)
    got = gather.gather_windows2(p0, p1, ri, oy, ox, W)
    assert torch.equal(got, gather.gather_windows2_plain(p0, p1, ri, oy, ox,
                                                         W))
    b = len(xs) * 5 + 5                     # the far corner
    want = (p1 if int(ri[b]) > 0 else p0)[96 - W:, 160 - W:]
    assert torch.equal(got[b], want)


@pytest.mark.cuda
def test_gather2_wrapper_rejects_bad_inputs(cuda):
    p0 = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    n0 = gather.gather_windows2.launches
    with pytest.raises(ValueError):      # planes of two shapes
        gather.gather_windows2(p0, p0[:32], idx, idx, idx, 8)
    with pytest.raises(TypeError):       # planes of two dtypes
        gather.gather_windows2(p0, p0.to(torch.int16), idx, idx, idx, 8)
    with pytest.raises(TypeError):
        gather.gather_windows2(p0.float(), p0.float(), idx, idx, idx, 8)
    with pytest.raises(ValueError):      # selector of another length
        gather.gather_windows2(p0, p0, idx[:3], idx, idx, 8)
    with pytest.raises(ValueError):      # a tensor on another device
        gather.gather_windows2(p0, p0.cpu(), idx, idx, idx, 8)
    with pytest.raises(ValueError):
        gather.gather_windows2(p0, p0, idx.cpu(), idx, idx, 8)
    with pytest.raises(ValueError):      # window larger than the plane
        gather.gather_windows2(p0, p0, idx, idx, idx, 65)
    assert gather.gather_windows2.launches == n0


# the widths with a compile-time instance, and two the kernel takes at
# run time
K1_WIDTHS = (15, 23, 25, 32, 41, 48, 9, 2)


def _k1_case(rng, dev, W, B, hp=200, wp=328):
    """Origins that reach past every edge (the kernel clamps them) and a
    selector with values outside {0, 1}."""
    oy, ox = (torch.as_tensor(rng.integers(-20, n - W + 21, B),
                              dtype=torch.int32, device=dev)
              for n in (hp, wp))
    ri = torch.as_tensor(rng.integers(-2, 4, B), dtype=torch.int32,
                         device=dev)
    return oy, ox, ri


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("W", K1_WIDTHS)
def test_k1_entries_match_plain(cuda, W, dtype, P):
    """Both entries with one plane and with U+V in one launch, at block
    counts the group does not divide (B = 1 included), origins out of
    range, and selectors all LAST, all GOLDEN, mixed and out of range."""
    rng = np.random.default_rng(W * 7 + P)
    hp, wp = 200, 328
    last = [torch.as_tensor(rng.integers(-3000, 3000, (hp, wp)), dtype=dtype,
                            device=cuda) for _ in range(P)]
    gold = [torch.as_tensor(rng.integers(-3000, 3000, (hp, wp)), dtype=dtype,
                            device=cuda) for _ in range(P)]
    one = P == 1
    a, g = (last[0], gold[0]) if one else (tuple(last), tuple(gold))
    for B in (1, 3, 5, 37, 1001):
        oy, ox, ri = _k1_case(rng, cuda, W, B, hp, wp)
        n0 = gather.gather_windows.launches
        got = gather.gather_windows(a, oy, ox, W)
        assert gather.gather_windows.launches == n0 + 1
        want = gather.gather_windows_plain(a, oy, ox, W)
        assert got.shape == ((B, W, W) if one else (P, B, W, W))
        assert torch.equal(got, want)
        for sel in (ri.clamp(0, 0), ri.clamp(1, 1), ri.clamp(0, 1), ri):
            n0 = gather.gather_windows2.launches
            got = gather.gather_windows2(a, g, sel, oy, ox, W)
            assert gather.gather_windows2.launches == n0 + 1
            assert torch.equal(got, gather.gather_windows2_plain(
                a, g, sel, oy, ox, W))
        # a U+V launch equals one launch a plane
        if not one:
            for j in range(P):
                assert torch.equal(got[j], gather.gather_windows2(
                    last[j], gold[j], ri, oy, ox, W))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [15, 9])
def test_k1_grid_strides_over_groups(cuda, W):
    """More groups of windows than the grid has CTAs (about 1,100 on an
    H100): each CTA takes several groups in turn, the last one ragged."""
    rng = np.random.default_rng(W)
    planes = [torch.as_tensor(rng.integers(0, 1024, (200, 328)),
                              dtype=torch.int32, device=cuda)
              for _ in range(4)]
    oy, ox, ri = _k1_case(rng, cuda, W, 150_001)
    last, gold = tuple(planes[:2]), tuple(planes[2:])
    assert torch.equal(gather.gather_windows2(last, gold, ri, oy, ox, W),
                       gather.gather_windows2_plain(last, gold, ri, oy, ox,
                                                    W))
    assert torch.equal(gather.gather_windows(last, oy, ox, W),
                       gather.gather_windows_plain(last, oy, ox, W))


@pytest.mark.cuda
def test_k1_uv_wrappers_reject_bad_inputs(cuda):
    p = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    n0 = (gather.gather_windows.launches, gather.gather_windows2.launches)
    with pytest.raises(ValueError):      # three output planes
        gather.gather_windows((p, p, p), idx, idx, 8)
    with pytest.raises(ValueError):      # U and V of two shapes
        gather.gather_windows((p, p[:32]), idx, idx, 8)
    with pytest.raises(TypeError):       # U and V of two dtypes
        gather.gather_windows((p, p.to(torch.int16)), idx, idx, 8)
    with pytest.raises(ValueError):      # two LAST planes, one GOLDEN
        gather.gather_windows2((p, p), (p,), idx, idx, idx, 8)
    with pytest.raises(ValueError):      # GOLDEN V on another device
        gather.gather_windows2((p, p), (p, p.cpu()), idx, idx, idx, 8)
    with pytest.raises(ValueError):      # W = 0
        gather.gather_windows((p, p), idx, idx, 0)
    assert (gather.gather_windows.launches,
            gather.gather_windows2.launches) == n0


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    """Inputs the kernels would read out of bounds raise before launch."""
    plane = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    oy = torch.zeros(4, dtype=torch.int32, device=cuda)
    n0 = gather.gather_windows.launches
    with pytest.raises(ValueError):
        gather.gather_windows(plane, oy, oy[:3], 8)
    with pytest.raises(ValueError):
        gather.gather_windows(plane, oy, oy.cpu(), 8)
    assert gather.gather_windows.launches == n0
    bt = torch.zeros((4, 16, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        refine.refine_ssd(bt, torch.zeros((4, 32, 32), dtype=torch.int32),
                          16, 8)
    with pytest.raises(ValueError):
        refine.refine_ssd(bt, torch.zeros((4, 30, 30), dtype=torch.int32,
                                          device=cuda), 16, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
def test_refine_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    bt = torch.as_tensor(rng.integers(0, 1024, (200, n, n)),
                         dtype=torch.int32, device=cuda)
    rt = torch.as_tensor(rng.integers(0, 1024, (200, n + 16, n + 16)),
                         dtype=torch.int32, device=cuda)
    rt[:20] = 7          # flat regions: every displacement ties
    bt[:20] = 7
    s1, d1 = refine.refine_ssd(bt, rt, n, 8)
    s0, d0 = refine.refine_ssd_plain(bt, rt, n, 8)
    assert torch.equal(s1, s0) and torch.equal(d1, d0)
    assert (d1[:20] == -8).all()     # ties resolve to the first k


def _k2_equal(bt, rt, n):
    s1, d1 = refine.refine_ssd(bt, rt, n, 8)
    s0, d0 = refine.refine_ssd_plain(bt, rt, n, 8)
    assert torch.equal(s1, s0) and torch.equal(d1, d0)
    return s1, d1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
def test_refine_kernel_largest_10bit_ssd(cuda, n):
    """An all-1023 block against an all-0 region: every SSD is
    n^2 * 1023^2 (1,071,645,696 at n=32, next to the int32 wrap), all
    tie, and k = 0 wins."""
    bt = torch.full((5, n, n), 1023, dtype=torch.int32, device=cuda)
    rt = torch.zeros((5, n + 16, n + 16), dtype=torch.int32, device=cuda)
    s, d = _k2_equal(bt, rt, n)
    assert (s == float(n * n * 1023 ** 2)).all() and (d == -8).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
def test_refine_kernel_constant_region_ties_to_first(cuda, n):
    rt = torch.full((7, n + 16, n + 16), 300, dtype=torch.int32, device=cuda)
    bt = torch.full((7, n, n), 41, dtype=torch.int32, device=cuda)
    _, d = _k2_equal(bt, rt, n)
    assert (d == -8).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [16, 32])
def test_refine_kernel_random_ragged_batch(cuda, n, bd):
    """Random 8/10-bit blocks cut from their regions plus noise, at a
    block count (151) that the n=16 CTA's four blocks do not divide."""
    rng = np.random.default_rng(n * bd)
    B, R = 151, n + 16
    reg = rng.integers(0, 1 << bd, (B, R, R))
    oy, ox = rng.integers(0, 17, (2, B))
    blk = np.stack([reg[b, oy[b]:oy[b] + n, ox[b]:ox[b] + n]
                    for b in range(B)])
    blk = np.clip(blk + rng.integers(-3, 4, blk.shape), 0, (1 << bd) - 1)
    _k2_equal(torch.as_tensor(blk, dtype=torch.int32, device=cuda),
              torch.as_tensor(reg, dtype=torch.int32, device=cuda), n)


@pytest.mark.cuda
@pytest.mark.parametrize("n,radius", [(16, 8), (32, 8), (8, 4)])
def test_refine_kernel_direct_path(cuda, n, radius):
    """Values outside [0, 1023] and shapes off the main path take the
    kernel's direct path, which wraps like the plain version's int32."""
    rng = np.random.default_rng(n + radius)
    R = n + 2 * radius
    bt = torch.as_tensor(rng.integers(-40000, 40000, (6, n, n)),
                         dtype=torch.int32, device=cuda)
    rt = torch.as_tensor(rng.integers(-40000, 40000, (6, R, R)),
                         dtype=torch.int32, device=cuda)
    s1, d1 = refine.refine_ssd(bt, rt, n, radius)
    s0, d0 = refine.refine_ssd_plain(bt, rt, n, radius)
    assert torch.equal(s1, s0) and torch.equal(d1, d0)


@pytest.mark.cuda
def test_gpu_stream_equals_cpu_stream(cuda):
    """A tiny grainy clip encodes to the same bytes on the card (CUDA
    kernels) and on the CPU (plain versions)."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.utils import testsrc
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        f = testsrc.testsrc2(128, 96, i)
        y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                    0, 255).astype(np.uint8)
        frames.append(testsrc.Frame(y=y, u=f.u, v=f.v))
    cfg = dict(chunk=1, golden=False, cdef=False, lr=False)
    outs = [list(SpecTorchEngine(TpuEncoderConfig(**cfg),
                                 device=d).encode_stream(frames, 96))
            for d in ("cuda", "cpu")]
    assert outs[0] == outs[1]
    assert len(SpecTorchEngine(TpuEncoderConfig(), device="cuda:0")._group) \
        <= 1


@pytest.mark.cuda
def test_gpu_golden_deblock_stream_equals_cpu_stream(cuda):
    """A clean two-scene clip (golden on; 144 % 32 == 16 and clean, so
    the loop filter and the strip are on) through encode_stream: the
    card's bytes equal the CPU's, with GOLDEN blocks chosen and all
    three kernels launched."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.utils.cleansrc import clean_frame
    frames = [clean_frame(256, 144, 0, 0), clean_frame(256, 144, 1, 0),
              clean_frame(256, 144, 5, 1), clean_frame(256, 144, 2, 0)]
    cfg = dict(chunk=1, golden=True, cdef=False, lr=False)
    n0 = (gather.gather_windows.launches, gather.gather_windows2.launches,
          refine.refine_ssd.launches)
    outs = []
    for d in ("cuda", "cpu"):
        eng = SpecTorchEngine(TpuEncoderConfig(**cfg), device=d)
        eng.start_stream()
        pend = [eng._submit(f, 96, is_key=(i == 0))
                for i, f in enumerate(frames)]
        assert eng._gop_deblock and all(p[14] > 0 for p in pend)
        assert int(pend[3][11][14].sum()) > 0      # GOLDEN blocks
        outs.append([eng._finalize(p) for p in pend])
    assert outs[0] == outs[1]
    assert len(SpecTorchEngine(TpuEncoderConfig(), device="cuda:0")._group) \
        <= 1
    n1 = (gather.gather_windows.launches, gather.gather_windows2.launches,
          refine.refine_ssd.launches)
    assert all(b > a for a, b in zip(n0, n1))


@pytest.mark.cuda
def test_daemon_make_engine_on_card(cuda):
    """The daemon's engine factory builds the card engine by default,
    and its startup self-test (one 1280x720 keyframe) passes."""
    from av1tpu_torch import config
    from av1tpu_torch.daemon import engine
    from av1tpu_torch.spec_engine import SpecTorchEngine
    eng = engine.make_engine(config.default_config())
    assert isinstance(eng, SpecTorchEngine) and eng.device.type == "cuda"
    dt = engine.verify_engine(eng, "1280x720")
    assert isinstance(dt, float) and dt > 0


@pytest.mark.cuda
def test_stripes_across_two_cards_equal_one_card(cuda):
    """K1 and K2 on the second card while the first is current launch
    there and equal their plain versions; a clean 256x256 drift in the
    default config at chunk=3, its P-frames in 4 stripes alternating
    between two cards (every halo crosses cards), gives the one-card
    stream byte for byte.  The default config (num_chips=0) keeps one
    card."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.utils.cleansrc import clean_frame
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(9)
    second = torch.device("cuda", 1)
    with torch.cuda.device(0):
        plane = torch.as_tensor(rng.integers(0, 256, (160, 192)),
                                dtype=torch.int32, device=second)
        oy, ox = (torch.as_tensor(rng.integers(0, 160 - 41, 37),
                                  dtype=torch.int32, device=second)
                  for _ in range(2))
        got = gather.gather_windows(plane, oy, ox, 41)
        assert torch.equal(got, gather.gather_windows_plain(plane, oy, ox, 41))
        blocks = got[:, 8:24, 8:24].contiguous()
        s1, d1 = refine.refine_ssd(blocks, got[:, :32, :32].contiguous(),
                                   16, 8)
        s0, d0 = refine.refine_ssd_plain(blocks, got[:, :32, :32], 16, 8)
        assert torch.equal(s1, s0) and torch.equal(d1, d0)
    frames = [clean_frame(256, 256, t, 0) for t in range(5)]
    outs = []
    for group in (("cuda:0",), ("cuda:0", "cuda:1") * 2):
        eng = SpecTorchEngine(TpuEncoderConfig(chunk=3), device="cuda:0",
                              stripe_devices=group)
        outs.append([p for p, _ in eng.encode_stream(frames, 96)])
    assert outs[0] == outs[1]
    assert len(SpecTorchEngine(TpuEncoderConfig(), device="cuda:0")._group) \
        <= 1


@pytest.mark.cuda
def test_two_nccl_ranks_on_two_cards_equal_one_card(cuda, tmp_path):
    """Two rank processes joined over NCCL through the daemon's
    make_engine (AV1TPU_* variables, num_chips 0: one stripe a rank),
    each on its own card, encode a clean 256x256 drift at chunk=3: every
    P-frame in 2 stripes, halos and outputs through the collectives.
    Each rank yields the one-card stream byte for byte, and launches
    K1 and K2 on its own card."""
    import torch_dist_ranks as R
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.utils.cleansrc import clean_frame
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    frames = [clean_frame(256, 256, t, 0) for t in range(5)]
    one = [p for p, _ in SpecTorchEngine(TpuEncoderConfig(chunk=3),
                                         device="cuda:0").encode_stream(
                                             frames, 96)]
    ranks = R.run(2, "stream", tmp_path, timeout=300, device="cuda",
                  cfg=dict(chunk=3), frames=frames)
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:1"]
    for r in ranks:
        assert r["stripes"] == 2 and r["calls"] == {"key": 0, "inter": 4}
        assert r["payloads"] == one
        assert all(n > 0 for n in r["launches"])


@pytest.mark.cuda
def test_dashboard_reads_the_card(cuda):
    """av1top's reader on the card: the device count, card 0's name,
    and card-wide used memory (this process's context included) within
    the card's total."""
    from av1tpu_torch.tui import metrics
    pct, name, count, used, total = metrics.read_gpu()
    assert count == torch.cuda.device_count() >= 1
    assert name == torch.cuda.get_device_name(0)
    assert 0 < used <= total
    assert total == torch.cuda.mem_get_info(0)[1] / 1024 ** 3
    assert 0 < pct <= 100


@pytest.mark.cuda
def test_doctor_encode_smoke_on_card(cuda, capsys):
    """The doctor's encode smoke runs a 320x192 keyframe on the card
    (building the kernels at first use) and its accelerator check names
    the card."""
    from av1tpu_torch.tools import doctor
    assert doctor.check_encode_smoke("cuda")
    assert doctor.check_gpu() is True
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[OK  ] encode smoke: ")
    assert "320x192 keyframe on cuda:0" in out[0]
    assert out[1].startswith("[OK  ] accelerator: ")
    assert torch.cuda.get_device_name(0) in out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("speed", [6, 4])
def test_legacy_engine_card_bytes_equal_cpu_bytes(cuda, speed):
    """The private av1tpu profile (tpu.bitstream "av1tpu") at 160x96,
    key + 3 P through encode_stream at chunk=2 (a chunk of 2, a single P):
    the card's payloads and recon equal the CPU's, and the P-frames
    launch K1 and K2 (search_v3: 2 each a reference searched)."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.legacy.engine import LegacyTorchEngine
    from av1tpu_torch.utils.testsrc import testsrc2
    frames = [testsrc2(160, 96, i) for i in range(4)]
    outs, refs = [], []
    for dev in ("cuda", "cpu"):
        eng = LegacyTorchEngine(TpuEncoderConfig(bitstream="av1tpu",
                                                 chunk=2, speed=speed),
                                device=dev)
        k1, k2 = gather.gather_windows.launches, refine.refine_ssd.launches
        outs.append(list(eng.encode_stream(frames, 96)))
        refs.append(eng._ref)
        if dev == "cuda":
            per = 2 if speed <= 4 else 1
            assert gather.gather_windows.launches - k1 == 3 * 2 * per
            assert refine.refine_ssd.launches - k2 == 3 * 2 * per
    assert [k for _, k in outs[0]] == [True, False, False, False]
    assert outs[0] == outs[1]
    for a, b in zip(*refs):
        assert np.array_equal(a, b)


def _mesh_inputs(dev, w=64, h=512):
    """The CPU tests' 512x64 P-frame pair: int32 planes (current, then
    reference) and their uint8 forms on ``dev``."""
    from av1tpu_torch.utils.testsrc import testsrc2
    fr = [testsrc2(w, h, i) for i in range(2)][::-1]
    p8 = [torch.as_tensor(p, device=dev) for f in fr for p in (f.y, f.u,
                                                                f.v)]
    return [p.to(torch.int32) for p in p8], p8


def _mesh_outputs(group, planes, p8):
    """The three stripe functions of the private profile over ``group``."""
    from av1tpu_torch.encoder import quant
    from av1tpu_torch.legacy import mesh_sharding as M
    dq = (quant.dc_q(96), quant.ac_q(96))
    return (M.encode_inter_frame_sharded(*planes, *dq, 16, group),
            M.encode_inter_frame_sharded_v2(*p8, *dq, 96, 16, group),
            M.encode_key_frame_sharded_v2(*p8[:3], *dq, 96, 16, group))


def _mesh_equal(a, b):
    for ta, tb in zip(a, b):
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert torch.equal(torch.as_tensor(x).cpu().long(),
                               torch.as_tensor(y).cpu().long())


@pytest.mark.cuda
def test_v1_pframe_card_equals_cpu(cuda):
    """The private profile's v1 P-frame (full-pel tss_search) at 512x64
    on the card: the CPU's outputs; K1 7 launches (2 region gathers, 4
    block gathers, U+V in one) and K2 2; decode_inter_frame gives the
    encoder's recon."""
    from av1tpu_torch.encoder import quant
    from av1tpu_torch.encoder.kernels import motion
    from av1tpu_torch.encoder.kernels.restoration import edge_pad
    from av1tpu_torch.legacy.core import inter_frame as IF
    dq = (quant.dc_q(96), quant.ac_q(96))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        planes, _ = _mesh_inputs(dev)
        pads = (motion.pad_ref(planes[3]),
                *(edge_pad(p, motion.CHROMA_PAD, motion.CHROMA_PAD)
                  for p in planes[4:]))
        k1, k2 = gather.gather_windows.launches, refine.refine_ssd.launches
        out = IF.encode_inter_frame(*planes[:3], *pads, *dq, 16)
        if dev.type == "cuda":
            assert gather.gather_windows.launches - k1 == 7
            assert refine.refine_ssd.launches - k2 == 2
        dec = IF.decode_inter_frame(*out[:4], *pads, *dq, 512, 64, 16)
        assert all(torch.equal(a, b) for a, b in zip(dec, out[4:]))
        outs.append(out)
    _mesh_equal([outs[0]], [outs[1]])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_stripe_functions_on_one_card_equal_cpu(cuda, n):
    """encode_inter_frame_sharded, encode_inter_frame_sharded_v2 and
    encode_key_frame_sharded_v2 over n stripes all on one card: the
    CPU's outputs over n CPU stripes."""
    got = _mesh_outputs((cuda,) * n, *_mesh_inputs(cuda))
    cpu = torch.device("cpu")
    want = _mesh_outputs((cpu,) * n, *_mesh_inputs(cpu))
    _mesh_equal(got, want)


@pytest.mark.cuda
def test_stripe_functions_across_two_cards_equal_one_card(cuda):
    """The three stripe functions over 4 stripes alternating two cards
    (every halo crosses cards) equal 4 stripes on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    two = (torch.device("cuda", 0), torch.device("cuda", 1)) * 2
    got = _mesh_outputs(two, *_mesh_inputs(two[0]))
    want = _mesh_outputs((two[0],) * 4, *_mesh_inputs(two[0]))
    _mesh_equal(got, want)
