"""The port's executors lay tables and forests out as the reference does.

``repro.kernels.fused_session``'s constructors run on the CPU (their
LUTs come from ``encode_lut``); the port's ``FusedTableExec`` and
``FusedGbdtExec`` must build byte-equal LUTs, the same ragged block
bases, the same Algorithm 1 row indices, and the same GBDT masks.
Uniform plans and ragged per-column plans chosen by a reference
session's ``representation="auto"`` optimizer are both covered.
"""

import numpy as np
import pytest

from repro.apps import gbdt as JG
from repro.apps import predicate as JP
from repro.core import encoding as jenc
from repro.kernels.fused_session import FusedGbdtExec as JGbdt
from repro.kernels.fused_session import FusedTableExec as JTable
from repro.pud import PudSession as JSession
from repro_torch import convert
from repro_torch.apps import gbdt as TG
from repro_torch.kernels.fused_session import FusedGbdtExec, FusedTableExec


def _table(t):
    return convert.table(t.n_bits, t.features)


def _ranges(mx_table, mx_cols, rng):
    """(fi, x0, x1) triples: boundaries, past a narrow column's max, and
    random spans."""
    out = []
    for fi, mx in enumerate(mx_cols):
        out += [(fi, 0, mx_table), (fi, 0, 1), (fi, mx, mx_table),
                (fi, mx // 3, mx + 1), (fi, 0, mx)]
        a, b = sorted(int(x) for x in rng.integers(0, mx_table + 1, 2))
        out.append((fi, a, b))
    return out


def _assert_same_layout(jx, tx, ranges):
    np.testing.assert_array_equal(convert.words_to_numpy(tx.lut),
                                  np.asarray(jx.lut))
    assert list(tx._base_n) == list(jx._base_n)
    assert list(tx._base_c) == list(jx._base_c)
    assert (tx.r_pad, tx.num_chunks, tx.per) == \
        (jx.r_pad, jx.num_chunks, jx.per)
    for r in ranges:
        np.testing.assert_array_equal(tx._range_idx(*r), jx._range_idx(*r))


@pytest.mark.parametrize("n_bits,shards,chunks,n", [
    (8, 1, 2, 1000),
    (16, 2, 4, 2501),
    (32, 3, 8, 777),
])
def test_table_exec_layout_matches_reference_uniform(n_bits, shards, chunks,
                                                     n):
    t = JP.Table.generate(n, n_bits, num_features=3, seed=n_bits)
    jx = JTable(t, num_shards=shards, num_chunks=chunks)
    tx = FusedTableExec(_table(t), num_shards=shards, num_chunks=chunks,
                        device="cpu")
    mx = (1 << n_bits) - 1
    _assert_same_layout(jx, tx, _ranges(mx, [mx] * 3,
                                        np.random.default_rng(n)))


def test_table_exec_layout_matches_reference_ragged_auto_plans():
    rng = np.random.default_rng(5)
    n, n_bits = 3000, 16
    cols = [rng.integers(0, 1 << w, n, dtype=np.uint64) for w in (16, 5, 9)]
    t = JP.Table(n_bits=n_bits, features=cols)
    s = JSession(num_devices=1)
    h = s.create_table(t, name="t", representation="auto")
    cfg = s.executor(h).fused_config()
    plans = cfg["plans"]
    assert len({p.n_bits for p in plans}) > 1, plans    # really ragged
    jx = JTable(**cfg)
    tx = FusedTableExec(
        _table(t), num_shards=cfg["num_shards"],
        num_chunks=cfg["num_chunks"],
        plans=[convert.column_plan(p.n_bits, p.num_chunks) for p in plans],
        device="cpu")
    _assert_same_layout(jx, tx, _ranges((1 << n_bits) - 1,
                                        [p.max_value for p in plans], rng))


def test_table_exec_rejects_overflowing_plan():
    t = JP.Table.generate(100, 8, num_features=1, seed=0)
    with pytest.raises(ValueError, match="overflows"):
        FusedTableExec(_table(t), num_shards=1, num_chunks=1,
                       plans=[convert.column_plan(2, 1)], device="cpu")


def _forest(f):
    return convert.forest(f.feature_idx, f.thresholds, f.leaves, f.n_bits,
                          f.num_features)


@pytest.mark.parametrize("n_bits,chunks,plan", [
    (8, 1, None),
    (16, 2, None),
    (16, 2, (10, 2)),             # thresholds narrowed to a 10-bit plan
])
def test_gbdt_exec_lut_and_masks_match_reference(n_bits, chunks, plan):
    f = JG.ObliviousForest.random(num_trees=30, depth=4, num_features=5,
                                  n_bits=plan[0] if plan else n_bits,
                                  seed=n_bits)
    f.n_bits = n_bits
    jx = JGbdt(f, num_chunks=chunks,
               plan=jenc.ColumnPlan(*plan) if plan else None)
    tx = FusedGbdtExec(_forest(f), num_chunks=chunks,
                       plan=convert.column_plan(*plan) if plan else None,
                       device="cpu")
    np.testing.assert_array_equal(convert.words_to_numpy(tx.lut),
                                  np.asarray(jx.lut))
    np.testing.assert_array_equal(convert.words_to_numpy(tx.masks),
                                  np.asarray(jx.masks))
    assert (tx.num_chunks, tx.mx, tx.n_nodes) == \
        (jx.num_chunks, jx.mx, jx.n_nodes)
    X = np.random.default_rng(1).integers(0, 1 << n_bits, (9, 5),
                                          dtype=np.int64)
    np.testing.assert_array_equal(tx.leaf_addrs(X),
                                  TG.reference_leaf_addrs(_forest(f), X))
