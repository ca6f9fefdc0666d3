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


@pytest.mark.cuda
def test_gpu_stream_equals_cpu_stream(cuda):
    """A tiny grainy clip encodes to the same bytes on the card (CUDA
    kernels) and on the CPU (plain versions)."""
    from av1tpu.config import TpuEncoderConfig
    from av1tpu.utils import testsrc
    from av1tpu_torch.spec_engine import SpecTorchEngine
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
