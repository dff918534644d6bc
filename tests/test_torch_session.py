"""The slice as a whole: the port's session against the reference's.

The port's ``PudSession(device="cpu")`` (every kernel's plain version)
runs the same queries and forests as ``repro``'s
``PudSession(backend="machine")`` (the NumPy DRAM simulator) on the same
data.  Bitmaps, counts and Q4's average are equal; predictions are
equal with zero tolerance, because both sum leaves with the same
``assemble_leaves`` expression.
"""

import numpy as np
import pytest

from repro.apps import gbdt as JG
from repro.apps import predicate as JP
from repro.pud import PudSession as JSession
from repro.pud import queries as JQ
from repro_torch import convert
from repro_torch.apps import gbdt as TG
from repro_torch.pud import PudSession, queries as TQ


def _queries(Q, mx):
    qa = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
              y1=3 * mx // 4)
    qb = dict(fi=2, x0=0, x1=mx, fj=3, y0=mx // 3, y1=mx)
    return [
        Q.Q1(fi=0, x0=mx // 8, x1=mx // 2), Q.Q1(fi=3, x0=0, x1=mx),
        Q.Q2(**qa), Q.Q3(**qa), Q.Q3(**qb), Q.Q4(fk=2, **qa),
        Q.Q4(fk=1, fi=0, x0=mx - 1, x1=mx, fj=1, y0=0, y1=1),   # empty
        Q.Q5(fl=3, fk=2, **qa), Q.Q5(fl=1, fk=0, **qb),
        Q.Compound((Q.Q1(fi=0, x0=0, x1=mx),), ()),
        Q.Compound((Q.Q3(**qa), Q.Q1(fi=2, x0=5, x1=mx - 3)), ("and",),
                   count=True),
        Q.Compound((Q.Q1(fi=1, x0=mx // 5, x1=mx), Q.Q2(**qb), Q.Q3(**qa)),
                   ("or", "and"), merge="host"),
    ]


@pytest.mark.parametrize("n_bits,shards_per_device,n", [
    (8, 1, 2501),
    (16, 2, 2501),
    (32, 3, 1999),
])
def test_query_matches_reference_machine_session(n_bits, shards_per_device,
                                                 n):
    t = JP.Table.generate(n, n_bits, num_features=4, seed=n_bits)
    mx = (1 << n_bits) - 1
    js = JSession(num_devices=1)
    jh = js.create_table(t, name="t", shards_per_device=shards_per_device)
    want = js.query(jh, _queries(JQ, mx)).result
    ts = PudSession(device="cpu")
    tt = convert.table(t.n_bits, t.features)
    th = ts.create_table(tt, name="t", shards_per_device=shards_per_device)
    queries = _queries(TQ, mx)
    got = ts.query(th, queries)
    assert got.wallclock_ns > 0
    for q, g, w in zip(queries, got.result, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w, q
        assert q.check(tt, g), q
    # same layout choice as the reference executor's fused recipe
    cfg = js.executor(jh).fused_config()
    ex = ts.executor(th)
    assert (ex.num_shards, ex.num_chunks) == \
        (cfg["num_shards"], cfg["num_chunks"])
    # one launch count per query kind and per compound shape
    assert set(ex.launch_counts) == {
        (1, False), (2, False), (2, True),
        ("compound", (1,), (False,), ()),
        ("compound", (2, 1), (True, False), (False,)),
        ("compound", (1, 2, 2), (False, False, True), (True, False))}
    assert ex.launch_counts[(2, True)] == 4      # two Q3s, two Q5 phase 1s


@pytest.mark.parametrize("n_bits,depth,trees", [(8, 4, 24), (16, 3, 17)])
def test_predict_matches_reference_machine_session(n_bits, depth, trees):
    f = JG.ObliviousForest.random(num_trees=trees, depth=depth,
                                  num_features=4, n_bits=n_bits, seed=depth)
    X = np.random.default_rng(9).integers(0, 1 << n_bits, (33, 4),
                                          dtype=np.uint64)
    js = JSession(num_devices=1)
    jh = js.load_forest(f, name="f", banks_per_group=2)
    want = js.predict(jh, X).result
    ts = PudSession(device="cpu")
    tf = convert.forest(f.feature_idx, f.thresholds, f.leaves, f.n_bits,
                        f.num_features)
    th = ts.load_forest(tf, name="f")
    got = ts.predict(th, X).result
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)          # zero tolerance
    # the same float32 expression on the reference addresses, C-ordered
    # as both executors hold them (reference_leaf_addrs returns an
    # F-ordered array, whose strided sum rounds differently)
    addrs = np.ascontiguousarray(TG.reference_leaf_addrs(tf, X))
    np.testing.assert_array_equal(got, TG.assemble_leaves(tf.leaves, addrs))
    assert ts.executor(th).num_chunks == \
        js.executor(jh).fused_config()["num_chunks"]
    # the reference's own predictor sums trees in another order
    np.testing.assert_allclose(got, TG.reference_predict(tf, X), atol=1e-5)


def test_chunk_fit_matches_reference_when_rows_are_tight():
    """A small subarray forces more chunks than the paper's default;
    both sessions must pick the same count."""
    t = JP.Table.generate(500, 16, num_features=8, seed=1)
    js = JSession(num_devices=2, num_rows=400)
    jh = js.create_table(t, name="t")
    ts = PudSession(num_devices=2, num_rows=400, device="cpu")
    th = ts.create_table(convert.table(t.n_bits, t.features), name="t")
    cfg = js.executor(jh).fused_config()
    ex = ts.executor(th)
    assert cfg["num_chunks"] > 4
    assert (ex.num_shards, ex.num_chunks) == \
        (cfg["num_shards"], cfg["num_chunks"])


def test_resource_lifetime_and_unported_options():
    t = convert.table(8, [np.arange(300) % 256, np.arange(300) % 7])
    s = PudSession(device="cpu")
    h = s.create_table(t, name="t")
    q = TQ.Q1(fi=0, x0=10, x1=200)
    assert h.status == "ready"
    s.evict(h)
    assert h.status == "evicted"
    np.testing.assert_array_equal(s.query(h, q).result, q.reference(t))
    assert h.status == "ready"
    s.drop(h)
    assert h.status == "dropped"
    with pytest.raises(KeyError):
        s.query(h, q)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.create_table(t, representation="auto")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.recode_column(h, 0, n_bits=4)
    arr = np.stack([np.arange(300) % 256, np.arange(300) % 9], axis=1)
    h2 = s.create_table(arr, n_bits=8)
    assert s.query(h2, q).result.sum() == q.reference(t).sum()
    with pytest.raises(TypeError, match="table"):
        s.predict(h2, np.zeros((1, 2), np.uint64))
