"""The frozen work counts against counts made by hand."""

import pytest

from clutchbench import work


def test_chunk_widths():
    assert work.chunk_widths(32, 5) == [6, 6, 6, 7, 7]
    assert work.chunk_widths(32, 8) == [4] * 8
    assert work.chunk_widths(8, 1) == [8]


def test_side_rows_by_hand():
    # 8 bits in two 4-bit chunks, a = 0x35: chunk 0 = 5, chunk 1 = 3.
    # chunk 0 reads lt row 5 (its le row never); chunk 1 reads lt 3, le 2
    assert work.side_rows(0x35, [4, 4]) == {(0, 5), (1, 3), (1, 2)}
    # a = 0xF0: chunk 0 = 0 -> lt row 0; chunk 1 = 15 (the top: lt is the
    # constant-zero row) -> le row 14 only
    assert work.side_rows(0xF0, [4, 4]) == {(0, 0), (1, 14)}
    # a = 0x0F: chunk 0 = 15 -> nothing; chunk 1 = 0 -> lt 0, le constant
    assert work.side_rows(0x0F, [4, 4]) == {(1, 0)}


def test_range_rows_both_sides_and_past_the_max():
    # x0 < f < x1 over 8 bits in 2 chunks: gt side on 0x35, lt side on
    # 255 - 0x40 = 0xBF: chunk 0 = 15 -> nothing; chunk 1 = 11 -> lt 11,
    # le 10
    rows = work.range_rows(0x35, 0x40, 8, 2)
    assert rows == {("n", 0, 5), ("n", 1, 3), ("n", 1, 2), ("c", 1, 11),
                    ("c", 1, 10)}
    # x1 past the max: the lt side is all true and reads nothing
    assert work.range_rows(0x35, 256, 8, 2) == {("n", 0, 5), ("n", 1, 3),
                                                ("n", 1, 2)}


def test_query_bytes_takes_the_lesser_figure_and_the_result():
    n = 1 << 20
    # one range of 5 rows of n/8 bytes, under the column's 4 n bytes; a
    # count comes back as 8 bytes
    q3 = ("q3", 0, 0x35, 0x40, 0, 0x35, 0x40)      # the same column twice
    assert work.query_bytes(q3, n, 8, 2) == 5 * n / 8 + 8
    # a bitmap adds n / 8
    q1 = ("q1", 0, 0x35, 0x40)
    assert work.query_bytes(q1, n, 8, 2) == 5 * n / 8 + n / 8
    # 1-bit chunks read so many rows that the column's values are less
    wide = ("q1", 0, 0x55, 0xAA)
    rows = len(work.range_rows(0x55, 0xAA, 8, 8))
    assert rows * n / 8 > n
    assert work.query_bytes(wide, n, 8, 8) == n + n / 8


def test_compound_counts_distinct_rows_per_column():
    n = 800
    a = ("q1", 0, 0x35, 0x40)
    b = ("q1", 1, 0x35, 0x40)
    both = ("compound", True, ("and", "or"), (a, b, a))
    assert work.query_bytes(both, n, 8, 2) == 2 * 5 * n / 8 + 8


def test_predict_work_by_hand():
    nbytes, ops = work.predict_work(batch=10, trees=3, depth=2,
                                    features=4, n_bits=8)
    # instances 10 * 4, thresholds and indices 3 * 2 * (1 + 1), leaves
    # 3 * 4 * 4, predictions 10 * 4
    assert nbytes == 40 + 12 + 48 + 40
    assert ops == 10 * 3 * 2 + 10 * 3


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12 * 2) == pytest.approx(2.0)
