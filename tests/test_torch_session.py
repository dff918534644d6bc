"""The slice as a whole: the port's session against the reference's.

The port's ``PudSession(device="cpu")`` (every kernel's plain version)
runs the same queries and forests as ``repro``'s
``PudSession(backend="machine")`` (the NumPy DRAM simulator) on the same
data.  Bitmaps, counts and Q4's average are equal; predictions are
equal with zero tolerance, because both sum leaves with the same
``assemble_leaves`` expression.  With ``representation="auto"`` both
sessions choose the same per-column plans, report the same dicts, and
recode columns with the same results and errors.
"""

import numpy as np
import pytest

from repro.apps import gbdt as JG
from repro.apps import predicate as JP
from repro.core import machine as JMachine
from repro.pud import PudSession as JSession
from repro.pud import queries as JQ
from repro_torch import convert
from repro_torch.apps import gbdt as TG
from repro_torch.core.machine import PuDArch
from repro_torch.pud import PudSession, queries as TQ
from test_torch_pudlint import port_pudlint_sweep  # noqa: F401  (autouse)


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
                                                 n, monkeypatch):
    t = JP.Table.generate(n, n_bits, num_features=4, seed=n_bits)
    mx = (1 << n_bits) - 1
    js = JSession(num_devices=1)
    jh = js.create_table(t, name="t", shards_per_device=shards_per_device)
    want = js.query(jh, _queries(JQ, mx)).result
    ts = PudSession(backend="fused", device="cpu")
    tt = convert.table(t.n_bits, t.features)
    th = ts.create_table(tt, name="t", shards_per_device=shards_per_device)
    queries = _queries(TQ, mx)
    launched = _spy_on_launches(monkeypatch)
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
    # one launch per query kind and per compound shape
    assert set(launched) == {
        (1, False), (2, False), (2, True),
        ("compound", (1,), (False,), ()),
        ("compound", (2, 1), (True, False), (False,)),
        ("compound", (1, 2, 2), (False, False, True), (True, False))}
    assert launched.count((2, True)) == 4      # two Q3s, two Q5 phase 1s


def _spy_on_launches(monkeypatch) -> list:
    """The shape of every fused table launch, in order: ``(num_ranges,
    disjunction)`` or ``("compound", term_ranges, term_disj, conn)``."""
    from repro_torch.kernels import fused_session as fs

    launched = []
    pred, comp = fs.fused_predicate_banked, fs.fused_compound_banked

    def predicate(lut, idx, num_chunks, num_ranges, disjunction):
        launched.append((num_ranges, disjunction))
        return pred(lut, idx, num_chunks, num_ranges, disjunction)

    def compound(lut, idx, num_chunks, term_ranges, term_disj, conn):
        launched.append(("compound", term_ranges, term_disj, conn))
        return comp(lut, idx, num_chunks, term_ranges, term_disj, conn)

    monkeypatch.setattr(fs, "fused_predicate_banked", predicate)
    monkeypatch.setattr(fs, "fused_compound_banked", compound)
    return launched


def _many_terms(Q, mx, k, rng):
    """A ``k``-term compound mixing Q1/Q2/Q3 terms and and/or."""
    terms = []
    for i in range(k):
        (a, b), (c, d) = (sorted(int(x) for x in rng.integers(0, mx + 1, 2))
                          for _ in range(2))
        fi, fj = (int(x) for x in rng.integers(0, 4, 2))
        if i % 3 == 0:
            terms.append(Q.Q1(fi=fi, x0=a, x1=b))
        else:
            q = Q.Q2 if i % 3 == 1 else Q.Q3
            terms.append(q(fi=fi, x0=a, x1=b, fj=fj, y0=c, y1=d))
    ops = tuple("or" if x else "and" for x in rng.integers(0, 2, k - 1))
    return tuple(terms), ops


@pytest.mark.parametrize("k", [33, 40])
def test_compound_of_many_terms_matches_reference_machine_session(k):
    """More terms than the kernel's former limit of 32: bitmap and
    count equal the reference machine session's."""
    t = JP.Table.generate(2501, 8, num_features=4, seed=8)
    js = JSession(num_devices=1)
    jh = js.create_table(t, name="t")
    jterms, jops = _many_terms(JQ, 255, k, np.random.default_rng(k))
    want = js.query(jh, [JQ.Compound(jterms, jops),
                         JQ.Compound(jterms, jops, count=True)]).result
    ts = PudSession(backend="fused", device="cpu")
    th = ts.create_table(convert.table(t.n_bits, t.features), name="t")
    terms, ops = _many_terms(TQ, 255, k, np.random.default_rng(k))
    got = ts.query(th, [TQ.Compound(terms, ops),
                        TQ.Compound(terms, ops, count=True)]).result
    np.testing.assert_array_equal(got[0], want[0])
    assert type(got[1]) is type(want[1]) and got[1] == want[1]
    assert got[1] == int(want[0].sum())


@pytest.mark.parametrize("n_bits,depth,trees", [(8, 4, 24), (16, 3, 17)])
def test_predict_matches_reference_machine_session(n_bits, depth, trees):
    f = JG.ObliviousForest.random(num_trees=trees, depth=depth,
                                  num_features=4, n_bits=n_bits, seed=depth)
    X = np.random.default_rng(9).integers(0, 1 << n_bits, (33, 4),
                                          dtype=np.uint64)
    js = JSession(num_devices=1)
    jh = js.load_forest(f, name="f", banks_per_group=2)
    want = js.predict(jh, X).result
    ts = PudSession(backend="fused", device="cpu")
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
    ts = PudSession(backend="fused", num_devices=2, num_rows=400,
                    device="cpu")
    th = ts.create_table(convert.table(t.n_bits, t.features), name="t")
    cfg = js.executor(jh).fused_config()
    ex = ts.executor(th)
    assert cfg["num_chunks"] > 4
    assert (ex.num_shards, ex.num_chunks) == \
        (cfg["num_shards"], cfg["num_chunks"])


def test_resource_lifetime_and_unported_options():
    t = convert.table(8, [np.arange(300) % 256, np.arange(300) % 7])
    s = PudSession(backend="fused", device="cpu")
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
    with pytest.raises(ValueError, match="representation"):
        s.create_table(t, representation="bogus")
    with pytest.raises(ValueError, match="representation"):
        s.load_forest(TG.ObliviousForest.random(2, 2, 2, 8),
                      representation="bogus")
    arr = np.stack([np.arange(300) % 256, np.arange(300) % 9], axis=1)
    h2 = s.create_table(arr, n_bits=8)
    assert s.query(h2, q).result.sum() == q.reference(t).sum()
    with pytest.raises(TypeError, match="table"):
        s.predict(h2, np.zeros((1, 2), np.uint64))


# ---------------------- adaptive representation ----------------------- #

ARCHS = [(JMachine.PuDArch.MODIFIED, PuDArch.MODIFIED),
         (JMachine.PuDArch.UNMODIFIED, PuDArch.UNMODIFIED)]
ARCH_IDS = ["modified", "unmodified"]


def _mixed_data(n=400, seed=0):
    """A 4-, 8- and 12-bit column (``tests/test_adaptive_precision.py``'s
    table)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 13, n), rng.integers(0, 220, n),
                     rng.integers(0, 3500, n)], axis=1).astype(np.uint64)


def _mixed_queries(Q):
    return [
        Q.Q1(fi=0, x0=2, x1=9),
        Q.Q1(fi=0, x0=3, x1=(1 << 32) - 1),           # x1 past MAX_f
        Q.Q2(fi=0, x0=1, x1=10, fj=2, y0=100, y1=3000),
        Q.Q3(fi=1, x0=10, x1=150, fj=2, y0=100, y1=2500),
        Q.Q4(fk=2, fi=0, x0=1, x1=8, fj=1, y0=5, y1=180),
        Q.Q5(fl=2, fk=1, fi=0, x0=1, x1=8, fj=2, y0=0, y1=2000),
        Q.Compound((Q.Q1(fi=0, x0=1, x1=9),
                    Q.Q3(fi=1, x0=10, x1=150, fj=2, y0=0, y1=2500)),
                   ("and",), count=True),
        Q.Compound((Q.Q1(fi=2, x0=700, x1=4000), Q.Q2(fi=0, x0=0, x1=12,
                                                     fj=1, y0=3, y1=300)),
                   ("or",)),
    ]


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w


def _plans(plans):
    return [(p.n_bits, p.num_chunks) for p in plans]


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_auto_table_matches_reference_machine_session(arch):
    """Plans, reports and Q1-Q5 / compound results equal the reference
    machine session's, and the port's auto table answers as its fixed
    one does."""
    data = _mixed_data()
    js = JSession(num_devices=2, arch=arch[0])
    ja = js.create_table(data, n_bits=12, name="auto",
                         representation="auto")
    jf = js.create_table(data, n_bits=12, name="fix", num_chunks=3)
    ts = PudSession(backend="fused", num_devices=2, arch=arch[1],
                    device="cpu")
    ta = ts.create_table(data, n_bits=12, name="auto",
                         representation="auto")
    tf = ts.create_table(data, n_bits=12, name="fix", num_chunks=3)
    assert _plans(ts._plans["auto"]) == _plans(js._plans["auto"])
    assert [p.n_bits for p in ts._plans["auto"]] == [4, 8, 12]
    assert "fix" not in ts._plans
    assert ta.representation == ja.representation
    assert tf.representation == jf.representation
    assert ta.representation["mode"] == "auto"
    assert ta.representation["saved_rows"] > 0
    want = js.query(ja, _mixed_queries(JQ)).result
    got = ts.query(ta, _mixed_queries(TQ)).result
    _assert_results_equal(got, want)
    _assert_results_equal(ts.query(tf, _mixed_queries(TQ)).result, want)
    ex = ts.executor(ta)
    assert ex.plans == tuple(ts._plans["auto"])
    cfg = js.executor(ja).fused_config()
    assert (ex.num_shards, ex.num_chunks) == \
        (cfg["num_shards"], cfg["num_chunks"])


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_auto_forest_matches_reference_machine_session(arch):
    rng = np.random.default_rng(2)
    n_feat, trees, depth = 5, 12, 3
    f = JG.ObliviousForest(
        rng.integers(0, n_feat, size=(trees, depth)).astype(np.int32),
        rng.integers(0, 400, size=(trees, depth)).astype(np.uint64),
        rng.normal(size=(trees, 1 << depth)).astype(np.float32),
        12, n_feat)
    X = rng.integers(0, 4096, size=(40, n_feat)).astype(np.uint64)
    js = JSession(num_devices=2, arch=arch[0])
    jh = js.load_forest(f, name="f", representation="auto")
    ts = PudSession(backend="fused", num_devices=2, arch=arch[1],
                    device="cpu")
    tf = convert.forest(f.feature_idx, f.thresholds, f.leaves, f.n_bits,
                        f.num_features)
    th = ts.load_forest(tf, name="f", representation="auto")
    tfix = ts.load_forest(tf, name="fix", num_chunks=3)
    plan = ts._forest_plans["f"]
    want = js._forest_plans["f"]
    assert (plan.n_bits, plan.num_chunks) == (want.n_bits, want.num_chunks)
    assert plan.n_bits < 12
    assert "fix" not in ts._forest_plans
    got = ts.predict(th, X).result
    np.testing.assert_array_equal(got, js.predict(jh, X).result)
    np.testing.assert_array_equal(got, ts.predict(tfix, X).result)
    assert ts.executor(th).num_chunks == plan.num_chunks


def test_recode_column_matches_reference_machine_session():
    """A recode evicts the table, the next job rebuilds it with equal
    results; a recode the data overflows names the column; a fixed
    table gets declared-width plans seeded first.  Reports follow the
    reference session's at each step."""
    data = _mixed_data()
    js, ts = JSession(num_devices=2), PudSession(backend="fused",
                                                 num_devices=2,
                                                 device="cpu")
    jt = js.create_table(data, n_bits=12, name="t", representation="auto")
    tt = ts.create_table(data, n_bits=12, name="t", representation="auto")
    before = ts.query(tt, _mixed_queries(TQ)).result
    new = ts.recode_column(tt, 1, n_bits=9, num_chunks=3)
    assert _plans([new]) == _plans(
        [js.recode_column(jt, 1, n_bits=9, num_chunks=3)]) == [(9, 3)]
    assert tt.status == "evicted"
    after = ts.query(tt, _mixed_queries(TQ)).result
    assert tt.status == "ready"
    _assert_results_equal(after, before)
    _assert_results_equal(after, js.query(jt, _mixed_queries(JQ)).result)
    assert ts.executor(tt).plans[1] == new
    assert tt.representation == jt.representation
    # omitted arguments keep the column's current value
    for col, kw in ((2, {"num_chunks": 2}), (0, {"n_bits": 6})):
        assert _plans([ts.recode_column(tt, col, **kw)]) == \
            _plans([js.recode_column(jt, col, **kw)])
    assert tt.representation == jt.representation
    for s, h in ((ts, tt), (js, jt)):
        with pytest.raises(ValueError, match="column 2"):
            s.recode_column(h, 2, n_bits=8)
        with pytest.raises(IndexError):
            s.recode_column(h, 3, n_bits=8)
    assert tt.representation == jt.representation
    # a fixed table seeds declared-width plans, then moves one column
    jt2 = js.create_table(data, n_bits=12, name="t2", num_chunks=3)
    tt2 = ts.create_table(data, n_bits=12, name="t2", num_chunks=3)
    assert tt2.representation == jt2.representation
    assert _plans([ts.recode_column(tt2, 0, n_bits=4)]) == \
        _plans([js.recode_column(jt2, 0, n_bits=4)])
    assert _plans(ts._plans["t2"]) == _plans(js._plans["t2"])
    assert tt2.representation == jt2.representation
    assert tt2.representation["mode"] == "auto"
    _assert_results_equal(ts.query(tt2, _mixed_queries(TQ)).result, before)
    # a dropped table is unknown, to both
    for s, h in ((ts, tt2), (js, jt2)):
        s.drop(h)
        with pytest.raises(KeyError):
            s.recode_column(h, 0, n_bits=4)
        with pytest.raises(KeyError):
            s.representation_report(h)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_recode_over_budget_rolls_back_as_the_reference_does(arch):
    data = np.stack([np.arange(8, dtype=np.uint64) % 4] * 3, axis=1)
    js = JSession(num_devices=1, num_rows=256, arch=arch[0])
    ts = PudSession(backend="fused", num_devices=1, num_rows=256,
                    arch=arch[1], device="cpu")
    jt = js.create_table(data, n_bits=8, name="t", representation="auto")
    tt = ts.create_table(data, n_bits=8, name="t", representation="auto")
    old = list(ts._plans["t"])
    assert _plans(old) == _plans(js._plans["t"])
    errors = []
    for s, h in ((ts, tt), (js, jt)):
        with pytest.raises(MemoryError) as err:
            s.recode_column(h, 0, n_bits=8, num_chunks=1)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert list(ts._plans["t"]) == old                # rolled back
    assert tt.status == "ready"                       # and not evicted
    assert tt.representation == jt.representation


def test_auto_table_under_a_taken_name_keeps_the_first():
    data = _mixed_data(n=64)
    s = PudSession(backend="fused", device="cpu")
    h = s.create_table(data, n_bits=12, name="t", representation="auto")
    plans = list(s._plans["t"])
    with pytest.raises(ValueError, match="already exists"):
        s.create_table(data[:, :2], n_bits=12, name="t")
    assert s._plans["t"] == plans and len(s._tables["t"].features) == 3
    q = TQ.Q1(fi=2, x0=5, x1=3000)
    np.testing.assert_array_equal(s.query(h, q).result,
                                  q.reference(s._tables["t"]))
