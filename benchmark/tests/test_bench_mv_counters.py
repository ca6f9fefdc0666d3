"""The readers of the tile writer's MV counters (``golden_block_share``,
``signbias_flips_per_pframe``) on hand-made program spans: None without
spans, and the ratio worked out by hand with them; spans outside the
window are left out; and ``program.ON`` switches the tracer on for them."""

import pytest

from av1tpu_torch.utils import spans as tracer
from benchmark import harness, program

CELL = "spec1080.grain-p"
NEW = ("golden_block_share", "signbias_flips_per_pframe")


def _counts(frames):
    """Three counter spans a frame, as the engine records them: (t0 us,
    item, inter blocks, GOLDEN blocks, negations) each."""
    sp = []
    for t0, item, inter, golden, flips in frames:
        for name, n in (("mv.inter_blocks", inter),
                        ("mv.golden_blocks", golden),
                        ("mv.signbias_flips", flips)):
            sp.append(tracer.Span(name, t0 * 1000, t0 * 1000 + 500, 7,
                                  len(sp) + 1, 0, item, n))
    return sp


def _run(program_spans):
    # the window is [0, 100] us; a frame before it and one after it
    frames = [(-50, 1, 900, 400, 9), (10, 2, 100, 10, 0), (20, 2, 120, 0, 3),
              (60, 3, 80, 30, 4), (150, 4, 700, 700, 50)]
    spans = _counts(frames) if program_spans else []
    return harness.Run(frames=3, t_open=0.0, t_close=100e-6,
                       program=spans)


def _readers():
    return {m["name"]: mod for m, mod in harness.load_cell(CELL)["per_layer"]
            if m["name"] in NEW}


def test_readers_read_the_hand_worked_ratio():
    readers = _readers()
    assert set(readers) == set(NEW)
    run = _run(True)
    # inside the window: GOLDEN 10 + 0 + 30 of 100 + 120 + 80 inter
    # blocks; negations 0 + 3 + 4 over 3 P-frames
    assert readers["golden_block_share"].read(run) == pytest.approx(40 / 300)
    assert readers["signbias_flips_per_pframe"].read(run) == \
        pytest.approx(7 / 3)
    assert all(program.ON in readers[n].SPANS for n in NEW)


def test_readers_none_without_spans():
    readers = _readers()
    tracer.drain()
    for run in (_run(False), harness.Run(frames=3, t_open=0.0,
                                         t_close=100e-6)):
        assert {n: readers[n].read(run) for n in NEW} == dict.fromkeys(NEW)


def test_golden_share_none_without_inter_blocks():
    sp = _counts([(10, 2, 0, 0, 0)])
    run = harness.Run(frames=1, t_open=0.0, t_close=100e-6, program=sp)
    readers = _readers()
    assert readers["golden_block_share"].read(run) is None
    assert readers["signbias_flips_per_pframe"].read(run) == 0
