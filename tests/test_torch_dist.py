"""Stripes over processes in the PyTorch port: the ``AV1TPU_*`` process
group (``av1tpu_torch/encoder/mesh/distributed.py``, the counterpart of
``av1tpu/encoder/mesh/distributed.py``) and the stripe groups that span
it (``specav1.stripes.Ranks``), on the CPU.

Each rank is a subprocess (``torch_dist_ranks.run``) joined over gloo on
127.0.0.1, one stripe a rank.  Every rank's bytes and recons must equal
the one-process stripe group's and the one-device engine's exactly.  No
JAX program is compiled here (the JAX comparison of the same transport
is ``test_torch_stripes.py``'s).
"""

import numpy as np
import torch

import torch_dist_ranks as R
from av1tpu_torch import spec_engine as SE
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.encoder import quant
from av1tpu_torch.encoder.mesh import distributed
from av1tpu_torch.legacy import mesh_sharding as ms
from av1tpu_torch.utils import testsrc
from av1tpu_torch.utils.cleansrc import clean_frame

CPU = torch.device("cpu")


def _one_process(cfg, frames, n):
    eng = SE.SpecTorchEngine(TpuEncoderConfig(**cfg, num_chips=n),
                             device="cpu")
    return R.spied_stream(eng, frames, 96)


def _same_recons(got, want, h):
    """Recons equal over the coded frame (a striped key's rows past it
    are stripe garbage)."""
    assert len(got) == len(want)
    for fa, fb in zip(got, want):
        for a, b, rows in zip(fa, fb, (h, h // 2, h // 2)):
            np.testing.assert_array_equal(a[:rows], b[:rows])


def test_maybe_initialize_without_and_with_the_variables(monkeypatch,
                                                         tmp_path):
    """Without AV1TPU_COORDINATOR maybe_initialize() is False and nothing
    joins a group (the reference's test_distributed_noop_without_env);
    with the variables, in a one-rank process, it is True, and True again,
    over gloo on the CPU; the engine's group is then the world (num_chips
    0 or the world size; any other count raises), and so is make_mesh's."""
    monkeypatch.delenv("AV1TPU_COORDINATOR", raising=False)
    assert distributed.maybe_initialize() is False
    assert distributed.maybe_initialize("cpu") is False
    assert not distributed.active()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.rank_device("cpu") == CPU
    (res,) = R.run(1, "init", tmp_path, device="cpu")
    assert res == {"first": True, "again": True, "backend": "gloo",
                   "world": 1, "rank": 0, "device": "cpu",
                   "groups": {0: 1, 1: 1, 2: "ValueError"}, "mesh": 1,
                   "mesh2": "ValueError"}


def test_two_ranks_stream_equals_one_process_and_one_device(tmp_path):
    """The daemon's default config at chunk=3 on a clean 256x256 drift
    (key, a packed chunk of 3, a remainder of 1) through make_engine in
    two ranks with num_chips 0: every P-frame in 2 stripes, one a rank
    (the 256-row key has one tile row and stays on one device).  Each
    rank's payloads equal the one-process 2-stripe group's and the
    one-device engine's, its recons equal theirs, and the port's decoder
    decodes the stream to them."""
    frames = [clean_frame(256, 256, t, 0) for t in range(5)]
    one, rec1, c1 = _one_process(dict(chunk=3), frames, 0)
    two, rec2, c2 = _one_process(dict(chunk=3), frames, 2)
    assert c1 == {"key": 0, "inter": 0} and c2 == {"key": 0, "inter": 4}
    assert two == one
    ranks = R.run(2, "stream", tmp_path, device="cpu", cfg=dict(chunk=3),
                  frames=frames)
    for res in ranks:
        assert res["stripes"] == 2 and res["device"] == "cpu"
        assert res["calls"] == {"key": 0, "inter": 4}
        assert res["payloads"] == one
        _same_recons(res["recons"], rec2, 256)
        _same_recons(res["recons"], rec1, 256)
    R.decodes_to(ranks[1]["payloads"], ranks[1]["recons"])


def test_four_ranks_key_and_p_and_two_ranks_private_profile(tmp_path):
    """Four ranks encode a clean 96x512 key + P (chunk=1, deblocking, CDEF
    and LR on): the key stripes over its 4 tile rows and the P-frame over
    4 stripes, every rank's payloads equal to the one-process 4-stripe
    group's and the one-device engine's, recons over the coded frame too.
    Then the private profile's three stripe functions (the v1 and v2
    P-frames on test_sharding's 512x64 pair, the v2 keyframe on a random
    256x192 frame) over two ranks equal the one-process 2-stripe group's
    outputs."""
    frames = [clean_frame(96, 512, i, 0) for i in range(2)]
    one, rec1, _ = _one_process(dict(chunk=1), frames, 0)
    four, rec4, c4 = _one_process(dict(chunk=1), frames, 4)
    assert c4 == {"key": 1, "inter": 1} and four == one
    ranks = R.run(4, "stream", tmp_path, device="cpu", cfg=dict(chunk=1),
                  frames=frames)
    for res in ranks:
        assert res["calls"] == {"key": 1, "inter": 1}
        assert res["payloads"] == one
        _same_recons(res["recons"], rec4, 512)
        _same_recons(res["recons"], rec1, 512)

    f0, f1 = testsrc.testsrc2(64, 512, 0), testsrc.testsrc2(64, 512, 1)
    planes = [f1.y, f1.u, f1.v, f0.y, f0.u, f0.v]
    rng = np.random.default_rng(7)
    key = [rng.integers(0, 256, s).astype(np.uint8)
           for s in ((256, 192), (128, 96), (128, 96))]
    dq, q, block = (quant.dc_q(96), quant.ac_q(96)), 96, 16
    g = ms.make_mesh(2, "cpu")
    p = [torch.from_numpy(a) for a in planes]
    k = [torch.from_numpy(a) for a in key]
    want = (ms.encode_inter_frame_sharded(*p, *dq, block, g),
            ms.encode_inter_frame_sharded_v2(*p, *dq, q, block, g),
            ms.encode_key_frame_sharded_v2(*k, *dq, q, block, g))
    ranks = R.run(2, "mesh", tmp_path, device="cpu", planes=planes,
                  key_planes=key, dq=dq, q=q, block=block)
    for res in ranks:
        for got, w in zip(res, want):
            assert len(got) == len(w)
            for i, (a, b) in enumerate(zip(got, w)):
                b = b if isinstance(b, int) else b.numpy()
                np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert int(want[0][7]) > 0 and (want[1][0] != 0).any()

