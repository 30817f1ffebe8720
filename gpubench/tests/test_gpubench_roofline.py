"""The frozen bound arithmetic against counts made by hand."""

import numpy as np
import pytest

from core import roofline


def test_sw_counts_by_hand():
    # 3 pairs, q_max 8, t_max 16, band 128: reads of 5, 8 and 20 bases
    # (the last capped at q_max): cells (5 + 8 + 8) * 128 = 2688; bytes:
    # planes 3 * (8 + 16) = 72, lengths 3 * 2 * 4 = 24, out 3 * 7 * 4 = 84
    nb, ops = roofline.sw_counts(3, 8, 16, np.array([5, 8, 20]), 128)
    assert nb == 72 + 24 + 84
    assert ops == 2688 * 22


def test_chain_counts_by_hand():
    # 2 groups of A = 4 anchors (int16 planes), counts 3 and 4, window 2:
    # pairs: min(i, 2) for i < count: 0+1+2 = 3 and 0+1+2+2 = 5
    nb, ops = roofline.chain_counts(2, 2, 4, np.array([3, 4]), window=2,
                                    bandwidth=500)
    assert ops == (3 + 5) * 8
    assert nb == 2 * 2 * 2 * 4 + 4 * 2 + 4 * 501 + 24 * 2


def test_bound_side():
    t, side = roofline.bound(3.35e12, 1.0)
    assert side == "bytes" and t == pytest.approx(1.0)
    t, side = roofline.bound(1.0, 16.75e12 * 2)
    assert side == "operations" and t == pytest.approx(2.0)
