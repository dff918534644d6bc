"""The fused executors over a mesh: two gloo ranks on the CPU
(``tests/_torch_mesh_worker.py``), each holding its block of the
table's record shards (``shard_mesh``) and running the plain versions
of the kernels on it; counts all-reduced, bitmaps and leaf addresses
all-gathered.  Bitmaps, counts and leaf addresses must be bit-exact to
the one-rank executor, to the reference's ``Q*.reference()`` and to
``reference_leaf_addrs``; predictions bit-equal to the reference's
``assemble_leaves`` over those addresses in C order (its float32 sum
follows the array's memory order); Q4's float average, as ``Q4.check``
holds it, within 1e-9."""

import json

import numpy as np
import pytest

from _torch_mesh_util import run_ranks
from repro.apps import gbdt as JG
from repro.apps import predicate as JP
from repro.pud import queries as Q

TIMEOUT = 180


def _queries(mx: int) -> list:
    qa = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
              y1=3 * mx // 4)
    qb = dict(fi=2, x0=mx // 3, x1=mx, fj=3, y0=0, y1=mx // 5)
    return [
        Q.Q1(fi=0, x0=mx // 8, x1=mx // 2),
        Q.Q2(**qa), Q.Q3(**qa), Q.Q4(fk=2, **qa), Q.Q5(fl=3, fk=2, **qa),
        Q.Compound((Q.Q1(fi=3, x0=mx // 10, x1=9 * mx // 10), Q.Q3(**qb)),
                   ("and",)),
        Q.Compound((Q.Q1(fi=1, x0=0, x1=mx // 16), Q.Q2(**qa), Q.Q3(**qb)),
                   ("or", "and"), count=True),
    ]


@pytest.mark.parametrize("num_shards,ranks", [(4, 2), (2, 2), (3, 1)])
def test_fused_session_over_a_shard_mesh_is_bit_exact(tmp_path, num_shards,
                                                      ranks):
    n_bits, n = 16, 3001
    table = JP.Table.generate(n, n_bits, num_features=4, seed=num_shards)
    forest = JG.ObliviousForest.random(num_trees=40, depth=5,
                                       num_features=4, n_bits=8, seed=2)
    X = np.random.default_rng(3).integers(0, 256, (37, 4), dtype=np.int64)
    np.savez(tmp_path / "data.npz", X=X, feature_idx=forest.feature_idx,
             thresholds=forest.thresholds, leaves=forest.leaves,
             **{f"f{i}": f for i, f in enumerate(table.features)})
    qs = _queries((1 << n_bits) - 1)
    out = run_ranks("fused", 2, {
        "data": str(tmp_path / "data.npz"), "num_features": 4,
        "n_bits": n_bits, "num_shards": num_shards, "num_chunks": 4,
        "forest_bits": 8, "forest_features": 4, "forest_chunks": 2,
        "queries": json.dumps([q.to_tuple() for q in qs]),
        "out": str(tmp_path / "out.npz")}, TIMEOUT)
    assert [r["ranks"] for r in out] == [ranks] * 2
    # a rank the mesh leaves out refuses to build an executor on it
    assert [r["lut_shards"] for r in out] == \
        [num_shards // ranks] * ranks + [None] * (2 - ranks)
    got = np.load(tmp_path / "out.npz")
    for i, q in enumerate(qs):
        have, one = got[f"got{i}"], got[f"one{i}"]
        assert have.shape == one.shape and (have == one).all(), q
        want = q.reference(table)
        if isinstance(q, Q.Q4):
            assert q.check(table, float(have)), q
        else:
            np.testing.assert_array_equal(have, np.asarray(want))
    np.testing.assert_array_equal(got["addrs"], got["addrs_one"])
    np.testing.assert_array_equal(got["addrs"],
                                  JG.reference_leaf_addrs(forest, X))
    want = JG.assemble_leaves(forest.leaves, np.ascontiguousarray(
        JG.reference_leaf_addrs(forest, X)))
    assert got["pred"].tobytes() == want.tobytes()
