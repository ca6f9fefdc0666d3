"""The frozen byte and operation counts against hand-worked cases."""

import pytest
import torch

from benchmark.frozen import roofline


def _t(*v):
    return torch.tensor(v, dtype=torch.int32)


def test_one_window():
    # a 2x2 window of an int32 4x4 plane: 4 elements read, two int32
    # origins, one 2x2 int32 output
    assert roofline.touched_bytes((4, 4), 4, 1, None, _t(0), _t(0), 2) == \
        4 * 4 + 4 * 2 + 4 * 4


def test_overlap_counts_once_and_planes_multiply():
    # two 3x3 windows overlapping in 2x2, int16, U and V (P = 2): the 14
    # distinct elements of each plane, four int32 origins, 2 x 2 x 9
    # int32 outputs
    got = roofline.touched_bytes((8, 8), 2, 2, None, _t(0, 1), _t(0, 1), 3)
    assert got == 2 * 14 * 2 + 4 * 2 * 2 + 4 * 2 * 2 * 9


def test_selector_reads_each_reference_apart():
    # the same origin from LAST and from GOLDEN: both windows are read;
    # three int32 indices a block
    got = roofline.touched_bytes((4, 4), 4, 1, _t(0, 1), _t(0, 0), _t(0, 0),
                                 2)
    assert got == 1 * 8 * 4 + 4 * 2 * 3 + 4 * 1 * 2 * 4


def test_k2_count_and_bound():
    nbytes, ops = roofline.k2_bytes_ops(1, 32, 8)
    assert (nbytes, ops) == (4 * (32 * 32 + 48 * 48) + 12,
                             3 * 289 * 32 * 32)
    assert roofline.bound_s(nbytes, ops) == pytest.approx(
        max(nbytes / 3.35e12, ops / 1979e12))
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
