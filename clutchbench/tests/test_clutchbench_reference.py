"""The plain reference on tables and forests worked out by hand."""

import math

import numpy as np
import pytest
import torch

from clutchbench.reference.forest import Forest
from clutchbench.reference.predicates import Columns

# three columns of six records
COLS = [np.array(v, np.uint64) for v in (
    [1, 5, 9, 3, 7, 2],
    [10, 20, 30, 40, 50, 60],
    [4, 4, 8, 8, 12, 12],
)]


def _bits(t):
    return t.tolist()


@pytest.fixture
def cols():
    return Columns(COLS, 32, "cpu")


def test_q1_bounds_are_exclusive(cols):
    assert _bits(cols.answer(("q1", 0, 2, 7))) == [
        False, True, False, True, False, False]


def test_q2_ands_and_q3_ors_then_counts(cols):
    # 2 < c0 < 9: records 1, 3, 4; 15 < c1 < 45: records 1, 2, 3
    assert _bits(cols.answer(("q2", 0, 2, 9, 1, 15, 45))) == [
        False, True, False, True, False, False]
    assert cols.answer(("q3", 0, 2, 9, 1, 15, 45)) == 4


def test_q4_is_the_exact_mean_and_zero_over_no_rows(cols):
    # rows 1, 3 -> c2 = 4, 8
    assert cols.answer(("q4", 2, 0, 2, 9, 1, 15, 45)) == 6.0
    assert cols.answer(("q4", 2, 0, 100, 200, 1, 0, 100)) == 0.0


def test_q5_nested_count(cols):
    # q3 rows 1, 2, 3, 4 -> mean of c2 over them = (4+8+8+12)/4 = 8
    # count of 8 < c1 < 16: only 10 -> 1
    assert cols.answer(("q5", 1, 2, 0, 2, 9, 1, 15, 45)) == 1
    # avg 0 (no rows): the range is empty, the count 0
    assert cols.answer(("q5", 1, 2, 0, 100, 200, 1, 100, 200)) == 0


def test_q5_integer_part_of_the_mean():
    c = [np.array([1, 2, 2, 5], np.uint64), np.array([1, 1, 1, 1],
                                                     np.uint64)]
    cols = Columns(c, 32, "cpu")
    # mean of c0 over all rows = 2.5 -> 2; count of 2 < c0 < 4 -> 0;
    # a float mean rounded would give 3 and count 1 (the 5 excluded)
    assert cols.answer(("q5", 0, 0, 1, 0, 2, 1, 0, 2)) == 0


def test_compound_is_left_associative(cols):
    a = ("q1", 0, 0, 4)        # rows 0, 3, 5
    b = ("q1", 1, 35, 65)      # rows 3, 4, 5
    c = ("q1", 2, 10, 20)      # rows 4, 5
    got = cols.answer(("compound", False, ("or", "and"), (a, b, c)))
    assert _bits(got) == [False, False, False, False, True, True]
    assert cols.answer(("compound", True, ("and", "or"), (a, b, c))) == 3


def test_control_cuts_values_and_scalars_to_16_bits():
    c = [np.array([70000, 5, 65541], np.uint64)]
    full = Columns(c, 32, "cpu")
    ctl = Columns(c, 32, "cpu", bits=16)
    assert _bits(full.answer(("q1", 0, 65536, 70001))) == [True, False,
                                                             True]
    # 70000 -> 4464, 65541 -> 5; 65536 -> 0, 70001 -> 4465
    assert _bits(ctl.answer(("q1", 0, 65536, 70001))) == [True, True, True]


def test_forest_by_hand():
    # one tree of depth 2 over 2 features: level 0 tests x0 < 5,
    # level 1 tests x1 < 3; the address has level 0 as its top bit
    feat = np.array([[0, 1], [1, 1]], np.int32)
    thr = np.array([[5, 3], [0, 0]], np.uint64)     # tree 1: always 0
    leaves = np.array([[1.0, 2.0, 3.0, 4.0], [0.5, 9, 9, 9]], np.float32)
    f = Forest(feat, thr, leaves, "cpu")
    x = np.array([[4, 2], [4, 7], [6, 2], [6, 9]], np.uint8)
    # addresses: (1,1)=3 -> 4, (1,0)=2 -> 3, (0,1)=1 -> 2, (0,0)=0 -> 1
    got = f.predict(x, block=3)
    assert got.dtype == torch.float64
    assert got.tolist() == [4.5, 3.5, 2.5, 1.5]


def test_forest_control_rounds_leaves_to_bfloat16():
    feat = np.zeros((1, 1), np.int32)
    thr = np.zeros((1, 1), np.uint64)
    leaves = np.array([[1.001, 2.0]], np.float32)
    x = np.zeros((1, 1), np.uint8)
    exact = Forest(feat, thr, leaves, "cpu").predict(x)
    ctl = Forest(feat, thr, leaves, "cpu", control=True).predict(x)
    assert math.isclose(float(exact[0]), 1.001, rel_tol=1e-7)
    assert float(ctl[0]) == 1.0
