"""The port's chunk plans and index resolution against the reference.

``repro_torch.core.encoding`` and the host-side resolution in
``repro_torch.kernels.ops`` are copies of the reference's NumPy code;
these tests hold them equal to ``repro.core.encoding`` and
``repro.kernels.ops`` over a grid of plans, boundary scalars included.
"""

import numpy as np
import pytest

from repro.core import encoding as jenc
from repro.kernels import ops as jops
from repro_torch.core import encoding as tenc
from repro_torch.kernels import ops as tops

PLANS = [(1, 1), (5, 2), (8, 1), (8, 2), (13, 4), (16, 4), (16, 16),
         (32, 5), (32, 8), (32, 12)]


def _boundary_scalars(plan, rng):
    """0, 2^n - 1, and scalars whose every chunk sits at 0 or 2^k - 1,
    plus random ones."""
    out = [0, (1 << plan.n_bits) - 1]
    for hi in (True, False):
        a = 0
        for j, (s, k) in enumerate(zip(plan.shifts, plan.widths)):
            if (j % 2 == 0) == hi:
                a |= ((1 << k) - 1) << s
        out.append(a)
    out += [int(x) for x in rng.integers(0, 1 << plan.n_bits, 8,
                                         dtype=np.uint64)]
    return out


@pytest.mark.parametrize("n_bits,chunks", PLANS)
def test_make_plan_matches_reference(n_bits, chunks):
    tp, jp = tenc.make_plan(n_bits, chunks), jenc.make_plan(n_bits, chunks)
    assert tp.widths == jp.widths
    assert (tp.n_bits, tp.num_chunks, tp.rows_required, tp.shifts) == \
        (jp.n_bits, jp.num_chunks, jp.rows_required, jp.shifts)
    rng = np.random.default_rng(n_bits * 100 + chunks)
    for a in _boundary_scalars(tp, rng):
        assert tp.split_scalar(a) == jp.split_scalar(a)
    v = rng.integers(0, 1 << n_bits, 50, dtype=np.uint64)
    for x, y in zip(tp.split_vector(v), jp.split_vector(v)):
        np.testing.assert_array_equal(x, y)
    cp = tenc.ColumnPlan(n_bits, chunks)
    jcp = jenc.ColumnPlan(n_bits, chunks)
    assert cp.chunk_plan.widths == jcp.chunk_plan.widths
    assert (cp.max_value, cp.rows_required, cp.lut_rows(),
            cp.lut_rows(negated=True)) == \
        (jcp.max_value, jcp.rows_required, jcp.lut_rows(),
         jcp.lut_rows(negated=True))
    assert tops.lut_offsets(tp) == jops.lut_offsets(jp)


@pytest.mark.parametrize("bad", [(8, 0), (8, 9), (0, 1)])
def test_invalid_plans_raise_like_reference(bad):
    for mod in (tenc, jenc):
        with pytest.raises(ValueError):
            mod.make_plan(*bad)
        with pytest.raises(ValueError):
            mod.ColumnPlan(*bad)


def test_split_scalar_rejects_out_of_range():
    plan = tenc.make_plan(8, 2)
    with pytest.raises(ValueError):
        plan.split_scalar(256)
    with pytest.raises(ValueError):
        plan.split_scalar(-1)


@pytest.mark.parametrize("n_bits,chunks", PLANS)
def test_resolve_indices_matches_reference(n_bits, chunks):
    tp, jp = tenc.make_plan(n_bits, chunks), jenc.make_plan(n_bits, chunks)
    rng = np.random.default_rng(n_bits + chunks)
    scalars = _boundary_scalars(tp, rng)
    for a in scalars:
        for x, y in zip(tops.resolve_indices(tp, a),
                        jops.resolve_indices(jp, a)):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)
    a = np.array(scalars + [-1, -1], np.int64)
    for x, y in zip(tops.resolve_indices_banked(tp, a),
                    jops.resolve_indices_banked(jp, a)):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_resolve_indices_banked_always_true_and_out_of_range():
    plan = tenc.make_plan(16, 4)
    _, _, one = tops.lut_offsets(plan)
    lt, le = tops.resolve_indices_banked(plan, np.array([-1, 7], np.int64))
    assert (lt[0] == one).all() and (le[0] == one).all()
    for mod, p in ((tops, plan), (jops, jenc.make_plan(16, 4))):
        with pytest.raises(ValueError):
            mod.resolve_indices_banked(p, np.array([3, 1 << 16], np.int64))
        with pytest.raises(ValueError):
            mod.resolve_indices(p, 1 << 16)


def test_resolve_indices_is_memoized_per_plan_and_scalar():
    plan = tenc.make_plan(16, 4)
    tops._resolve_scalar_cached.cache_clear()
    tops.resolve_indices(plan, 12345)
    before = tops._resolve_scalar_cached.cache_info()
    tops.resolve_indices(tenc.make_plan(16, 4), 12345)   # equal plan
    after = tops._resolve_scalar_cached.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)
