"""The traffic generator: the same seed gives the same frames, and the
cut mix gives the engine a key at every frame."""

import numpy as np

from benchmark import gen


def test_same_seed_same_frames():
    p = {"content": "grain", "pool": 3, "grain": 6}
    a, b = gen.Source(p, 64, 64, 2 ** 40 + 3), gen.Source(p, 64, 64,
                                                            2 ** 40 + 3)
    c = gen.Source(p, 64, 64, 9)
    assert all(np.array_equal(a.frame(i).y, b.frame(i).y) for i in range(6))
    assert not np.array_equal(a.frame(0).y, c.frame(0).y)
    assert [gen.pingpong(i, 3) for i in range(6)] == [0, 1, 2, 1, 0, 1]


def test_clean_excursion_lands_on_its_blends():
    p = {"content": "clean", "pool": 4, "start_range": 4,
         "excursion": {"period": 12, "blends": 5}}
    s = gen.Source(p, 128, 64, 5)
    for i in range(24):
        pos = i % 12
        f = s.frame(i)
        if 5 < pos < 11:
            assert f is s._cache[("blend", pos - 5)]
        else:
            assert f is s.pool[gen.pingpong(i, 4)]


def test_cuts_give_only_keys():
    from av1tpu_torch.engine import TorchEngine
    s = gen.Source({"content": "cuts", "grain": 6, "min_cut_mad": 40},
                   256, 128, 12345)
    eng = TorchEngine()
    eng._golden = True
    frames = [s.frame(i) for i in range(13)]
    kinds = []
    for i in range(12):
        kinds.append(eng._classify_frame(frames[i], frames[i + 1]))
        eng._ref_dev = object()  # a reference is held after the first key
    assert kinds == ["key"] * 12
