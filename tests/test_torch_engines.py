"""The port's engines on the PuD model held against the reference's on
the CPU: ``ClutchEngine`` (per-bank scalars, in-DRAM clone replication),
``TypedClutchEngine``, ``BitSerialEngine``, ``PudQueryEngine`` and
``GbdtPudEngine``, and the LUT loads under them.

Same seeds and inputs for both packages; every comparison is exact:
results bit for bit, PuD op counts equal to each other and to the
closed forms (``clutch_op_count``, ``bitserial_op_count``,
``gbdt_ops_per_instance``), subarray states and traces entry for entry.
The port's ``load_vector`` computes its planes with the
``temporal_encode`` kernel's plain version on the CPU; its state must
equal the reference's host encoding.  Counterparts of the reference's
``tests/test_clutch_core.py``, ``test_banked.py``, ``test_apps.py`` and
``test_system.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_machine import (
    ARCHS,
    BOTH,
    PORT,
    REF,
    arch,
    pinned_clock,  # noqa: F401  (a fixture)
    same_result,
    state,
    trace_key,
)


def _subs(name, banks, rows, cols, seed=5, mra=1):
    return [P.machine.BankedSubarray(banks, rows, cols, arch(P, name),
                                     seed=seed, multi_row_act=mra, **P.dev)
            for P in BOTH]


def _same(subs):
    np.testing.assert_array_equal(state(subs[1]), state(subs[0]))
    assert trace_key(subs[1].trace) == trace_key(subs[0].trace)


# ------------------------------ LUT loads ------------------------------ #

@pytest.mark.parametrize("name", ARCHS)
@settings(deadline=None, max_examples=25)
@given(st.integers(1, 16), st.integers(1, 3), st.sampled_from([32, 96, 160]),
       st.booleans(), st.booleans(), st.data())
def test_load_vector_through_temporal_encode_matches_reference(
        name, n_bits, banks, cols, complement, per_bank, data):
    """Chunk widths up to 16 bits, [n] broadcast and [banks, n] shards,
    complement planes: the state written through the kernel's plain
    version equals the reference's host encoding bit for bit."""
    c = data.draw(st.integers(max(1, -(-n_bits // 6)), n_bits))
    plan = REF.encoding.make_plan(n_bits, c)
    rows = plan.rows_required + 8 + 2
    n = data.draw(st.integers(1, cols))
    shape = (banks, n) if per_bank else (n,)
    vals = np.random.default_rng(n_bits * 7 + n).integers(
        0, 1 << n_bits, shape, dtype=np.uint64)
    subs = _subs(name, banks, rows, cols, seed=n)
    lays = [P.encoding.load_vector(s, vals, P.encoding.make_plan(n_bits, c),
                                   complement=complement)
            for P, s in zip(BOTH, subs)]
    assert (lays[1].plan.widths, lays[1].cp, lays[1].complement) == \
        (lays[0].plan.widths, lays[0].cp, lays[0].complement)
    _same(subs)


@pytest.mark.parametrize("k", [1, 3, 4, 7, 8, 11, 16])
def test_chunk_planes_equal_the_host_encoding(k):
    """``_chunk_planes`` (``temporal_encode``, plain version) equals
    ``pack_bits(temporal_encode_planes(..))`` per bank."""
    sub = PORT.machine.BankedSubarray(3, 40, 96, device="cpu")
    vals = np.random.default_rng(k).integers(0, 1 << k, (3, 96),
                                             dtype=np.uint64)
    got = PORT.encoding._chunk_planes(sub, vals, k)
    want = REF.machine.pack_bits(REF.encoding.temporal_encode_planes(vals, k))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        PORT.encoding.temporal_encode_planes(vals, k),
        REF.encoding.temporal_encode_planes(vals, k))


def test_chunk_wider_than_the_kernel_is_host_encoded_only_on_the_cpu():
    """A 17-bit chunk (wider than ``temporal_encode``'s 16) in a
    subarray of 2^17 + 9 rows: a CPU subarray encodes it on the host,
    equal to the reference; a card subarray raises the kernel's error
    before any work moves to the host."""
    k = 17
    rows = (1 << k) - 1 + 8 + 2
    vals = np.random.default_rng(k).integers(0, 1 << k, 20, dtype=np.uint64)
    subs = _subs("modified", 1, rows, 32)
    for P, s in zip(BOTH, subs):
        P.encoding.load_vector(s, vals, P.encoding.make_plan(k, 1))
    _same(subs)
    card = PORT.machine.BankedSubarray(1, rows, 32, device="cpu")
    card.device = torch.device("cuda")     # its state is never touched
    with pytest.raises(ValueError, match="chunk width 17 outside"):
        PORT.encoding.load_vector(card, vals, PORT.encoding.make_plan(k, 1))
    assert card.trace.entries == []


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("n_bits", [1, 8, 13])
def test_load_binary_vector_matches_reference(name, n_bits):
    vals = np.random.default_rng(n_bits).integers(0, 1 << n_bits, (2, 70),
                                                  dtype=np.uint64)
    subs = _subs(name, 2, 32, 96)
    starts = [P.encoding.load_binary_vector(s, vals, n_bits)
              for P, s in zip(BOTH, subs)]
    assert starts[0] == starts[1]
    _same(subs)


def test_order_preserving_encodings_match_reference():
    rng = np.random.default_rng(0)
    ints = rng.integers(-2 ** 11, 2 ** 11, 200)
    floats = np.concatenate([rng.normal(size=200).astype(np.float32),
                             np.float32([0.0, -0.0, np.inf, -np.inf])])
    np.testing.assert_array_equal(PORT.encoding.encode_signed(ints, 12),
                                  REF.encoding.encode_signed(ints, 12))
    np.testing.assert_array_equal(PORT.encoding.encode_float32(floats),
                                  REF.encoding.encode_float32(floats))
    for a in (-2048, 0, 2047):
        assert PORT.encoding.encode_signed_scalar(a, 12) == \
            REF.encoding.encode_signed_scalar(a, 12)
    for a in (-1.5, -0.0, 0.0, 3e38):
        assert PORT.encoding.encode_float32_scalar(a) == \
            REF.encoding.encode_float32_scalar(a)
    for P in BOTH:
        with pytest.raises(ValueError, match="signed 4-bit"):
            P.encoding.encode_signed(np.array([9]), 4)
        with pytest.raises(ValueError, match="NaN"):
            P.encoding.encode_float32(np.float32([np.nan]))


# ------------------------------- Clutch ------------------------------- #

@pytest.mark.parametrize("name", ARCHS)
@settings(deadline=None, max_examples=20)
@given(st.integers(1, 9), st.integers(1, 4), st.data())
def test_per_bank_scalars_match_reference(name, n_bits, banks, data):
    """Vector-of-scalars Algorithm 1: one broadcast stream with per-bank
    gathers, the always-true ``-1`` boundary (``>= 0``) included; the
    op count equals ``clutch_op_count`` whatever the scalars."""
    c = data.draw(st.integers(1, n_bits))
    mx = (1 << n_bits) - 1
    rows = 2 * REF.encoding.make_plan(n_bits, c).rows_required + 16
    vals = np.random.default_rng(n_bits).integers(0, mx + 1, (banks, 64),
                                                  dtype=np.uint64)
    subs = _subs(name, banks, rows, 64)
    engs = [P.clutch.ClutchEngine(s, vals, n_bits, num_chunks=c)
            for P, s in zip(BOTH, subs)]
    for op in (">", ">=", "<", "<=", "=="):
        x = np.array(data.draw(st.lists(
            st.sampled_from([0, 1, mx, mx // 2, data.draw(
                st.integers(0, mx))]), min_size=banks, max_size=banks)))
        res = [e.predicate(op, x) for e in engs]
        assert (res[1].row, res[1].pud_ops) == (res[0].row, res[0].pud_ops)
        np.testing.assert_array_equal(engs[1].read_bitmap(res[1].row),
                                      engs[0].read_bitmap(res[0].row))
        if op == ">":
            assert res[1].pud_ops == PORT.clutch.clutch_op_count(
                c, arch(PORT, name))
    _same(subs)
    row = PORT.clutch.compare_lt(subs[1], engs[1].layout, np.full(banks, -1))
    assert row == REF.clutch.compare_lt(subs[0], engs[0].layout,
                                        np.full(banks, -1))
    _same(subs)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mra", [1, 3])
def test_clone_replication_matches_reference(name, mra):
    """An engine cloned in-DRAM from a loaded one: its layouts equal
    the source's, its stream holds clone waves and no WRITE, and its
    predicates equal a host-loaded engine's."""
    vals = np.random.default_rng(3).integers(0, 256, (2, 96),
                                             dtype=np.uint64)
    srcs = _subs(name, 2, 128, 96, seed=1, mra=mra)
    dsts = _subs(name, 2, 128, 96, seed=2, mra=mra)
    out = []
    for P, s, d in zip(BOTH, srcs, dsts):
        a = P.clutch.ClutchEngine(s, vals, 8, num_chunks=2)
        b = P.clutch.ClutchEngine(d, vals, 8, num_chunks=2, clone_from=a)
        assert b.layout.cp == a.layout.cp
        assert "write" not in d.trace.counts()
        out.append([b.read_bitmap(b.predicate(op, 77).row)
                    for op in (">", "<", "==")])
    _same(dsts)
    for x, y in zip(*out):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="different chunk plan"):
        PORT.clutch.ClutchEngine(
            PORT.machine.BankedSubarray(2, 128, 96, arch(PORT, name),
                                        device="cpu"),
            vals, 8, num_chunks=4,
            clone_from=PORT.clutch.ClutchEngine(
                PORT.machine.BankedSubarray(2, 128, 96, arch(PORT, name),
                                            device="cpu"),
                vals, 8, num_chunks=2))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype,n_bits", [("signed", 10), ("float32", 32)])
def test_typed_engine_matches_reference(name, dtype, n_bits):
    rng = np.random.default_rng(4)
    if dtype == "signed":
        vals = rng.integers(-500, 500, 80)
        scalars = [-500, -1, 0, 3, 499]
    else:
        vals = np.concatenate([rng.normal(size=78).astype(np.float32),
                               np.float32([-0.0, 0.0])])
        scalars = [-1.0, -0.0, 0.0, 0.25, float(vals[5])]
    chunks = 2 if dtype == "signed" else 8
    rows = 2 * REF.encoding.make_plan(n_bits, chunks).rows_required + 16
    subs = _subs(name, 1, rows, 96)
    engs = [P.clutch.TypedClutchEngine(s, vals, n_bits, dtype=dtype,
                                       num_chunks=chunks)
            for P, s in zip(BOTH, subs)]
    for op in ("<", "<=", ">", ">=", "=="):
        for x in scalars:
            got = [e.read_bitmap(e.predicate(op, x).row) for e in engs]
            np.testing.assert_array_equal(got[1], got[0])
            want = {"<": vals < x, "<=": vals <= x, ">": vals > x,
                    ">=": vals >= x, "==": vals == x}[op]
            np.testing.assert_array_equal(got[1][0, :80], want)
    _same(subs)


# ----------------------------- bit-serial ----------------------------- #

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("n_bits", [4, 8, 12])
def test_bitserial_engine_matches_reference(name, n_bits):
    """Every operator at the boundaries and inside: bitmaps, rows,
    states and traces equal; the native ``>`` costs
    ``bitserial_op_count``; the paper's accounting as the reference's."""
    mx = (1 << n_bits) - 1
    vals = np.random.default_rng(n_bits).integers(0, mx + 1, (2, 90),
                                                  dtype=np.uint64)
    subs = _subs(name, 2, 4 * n_bits + 24, 96)
    engs = [P.bitserial.BitSerialEngine(s, vals, n_bits)
            for P, s in zip(BOTH, subs)]
    for op in (">", ">=", "<", "<=", "=="):
        for x in (0, 1, mx // 3, mx - 1, mx):
            before = subs[1].trace.pud_ops
            rows = [e.predicate(op, x) for e in engs]
            assert rows[1] == rows[0]
            bms = [e.read_bitmap(r) for e, r in zip(engs, rows)]
            np.testing.assert_array_equal(bms[1], bms[0])
            if op == ">":
                assert subs[1].trace.pud_ops - before == \
                    PORT.bitserial.bitserial_op_count(n_bits,
                                                      arch(PORT, name))
    _same(subs)
    for a in ARCHS:
        assert PORT.bitserial.paper_bitserial_op_count(
            n_bits, arch(PORT, a)) == REF.bitserial.paper_bitserial_op_count(
            n_bits, arch(REF, a))


# ---------------------------- the apps ------------------------------- #

def _query_engines(name, method, records=2500, n_bits=8, cols=1024,
                   plans=False, **kw):
    out = []
    for P in BOTH:
        t = P.predicate.Table.generate(records, n_bits, num_features=6,
                                       seed=9)
        p = None
        if plans:
            p = [P.encoding.ColumnPlan(n_bits - (i % 3), 2 + i % 2)
                 for i in range(6)]
            t = P.predicate.Table(n_bits, [f % (1 << (n_bits - (i % 3)))
                                           for i, f in
                                           enumerate(t.features)])
        extra = {"torch_device": "cpu"} if P is PORT else {}
        out.append(P.predicate.PudQueryEngine(
            t, arch(P, name), method, cols_per_bank=cols, plans=p,
            **kw, **extra))
    return out


QUERY_CALLS = [("q1", (0, 30, 200)), ("q2", (0, 10, 250, 1, 40, 200)),
               ("q3", (2, 0, 100, 3, 150, 255)),
               ("q4", (4, 0, 20, 200, 1, 5, 250)),
               ("q5", (5, 4, 0, 20, 200, 1, 5, 250))]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("method,plans", [("clutch", False),
                                          ("clutch", True),
                                          ("bitserial", False)],
                         ids=["clutch", "clutch-plans", "bitserial"])
def test_query_engine_matches_reference(pinned_clock, name, method, plans):
    """Q1-Q5 called directly on a table sharded over 3 banks, then the
    pipelined ``submit`` / ``read_parked`` path: results, states and
    traces (Q5's host event and barrier segment included) equal, and
    every result equals the NumPy reference."""
    engs = _query_engines(name, method, plans=plans)
    t = engs[1].table
    assert engs[1].num_banks == engs[0].num_banks == 3
    for q, args in QUERY_CALLS:
        got = [getattr(e, q)(*args) for e in engs]
        same_result(got[1], got[0])
        same_result(got[1], getattr(PORT.predicate, f"reference_{q}")(
            t, *args))
    for e in engs:
        e.submit("compound", (("and", "or"), (("q1", 0, 5, 90),
                                              ("q2", 1, 0, 99, 2, 3, 250),
                                              ("q3", 3, 9, 80, 4, 1, 30))),
                 buf=1, segment="c")
    bms = [e.merge_words(e.read_parked(1)) for e in engs]
    np.testing.assert_array_equal(bms[1], bms[0])
    _same([e.sub for e in engs])
    if method == "clutch" and not plans:
        assert engs[1].num_chunks == engs[0].num_chunks == 2


def test_clutch_issues_fewer_ops_than_bitserial_per_query():
    """The paper's headline on the model: each query issues fewer PuD
    ops on Clutch engines than on bit-serial ones, in both packages
    alike."""
    ops = {}
    for method in ("clutch", "bitserial"):
        engs = _query_engines("unmodified", method, records=500)
        for q, args in QUERY_CALLS[:3]:
            n = []
            for e in engs:
                before = e.sub.trace.pud_ops
                getattr(e, q)(*args)
                n.append(e.sub.trace.pud_ops - before)
            assert n[0] == n[1]
            ops[method, q] = n[1]
    for q, _ in QUERY_CALLS[:3]:
        assert ops["clutch", q] < ops["bitserial", q]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("shards,banks,clone", [(1, 4, False),
                                                (1, 4, True),
                                                (2, 4, False)],
                         ids=["one-shard", "cloned", "two-shards"])
def test_gbdt_engine_matches_reference(name, shards, banks, clone):
    """Batched inference with per-bank scalars (two column shards an
    instance when the forest is wider than a bank), a replica cloned
    in-DRAM, the ragged last wave: predictions bit-equal to the
    reference's and to ``assemble_leaves``, op counts equal to
    ``gbdt_ops_per_instance``, states and traces equal."""
    preds, engs = [], []
    for P in BOTH:
        f = P.gbdt.ObliviousForest.random(24 if shards == 1 else 1500, 3,
                                          5, 8, seed=6)
        X = np.random.default_rng(2).integers(0, 256, (11, 5),
                                              dtype=np.uint64)
        extra = {"torch_device": "cpu"} if P is PORT else {}
        kw = dict(num_banks=banks, cols_per_bank=4096, **extra)
        src = P.gbdt.GbdtPudEngine(f, arch(P, name), **kw) if clone \
            else None
        e = P.gbdt.GbdtPudEngine(f, arch(P, name), clone_source=src, **kw)
        assert e.col_shards == shards
        preds.append((e.infer(X), e.infer_one(X[3]), f, X))
        engs.append(e)
    np.testing.assert_array_equal(preds[1][0], preds[0][0])
    np.testing.assert_array_equal(preds[1][1][0], preds[0][1][0])
    assert preds[1][1][1] == preds[0][1][1]
    f, X = preds[1][2], preds[1][3]
    addrs = np.ascontiguousarray(PORT.gbdt.reference_leaf_addrs(f, X))
    np.testing.assert_array_equal(
        preds[1][0], PORT.gbdt.assemble_leaves(f.leaves, addrs))
    assert engs[1].ops_per_instance == engs[0].ops_per_instance == \
        PORT.gbdt.gbdt_ops_per_instance(f, engs[1].num_chunks,
                                        arch(PORT, name))
    _same([e.sub for e in engs])
    assert PORT.gbdt.GbdtPudEngine(f, arch(PORT, name), num_banks=banks,
                                   torch_device="cpu").infer(
        np.zeros((0, 5))).shape == (0,)


def test_fitted_forest_matches_reference_and_runs_on_the_model():
    """``fit_oblivious_forest`` draws and fits the same forest; it runs
    on the model bit-equal to ``assemble_leaves``."""
    rng = np.random.default_rng(5)
    X = rng.integers(0, 256, (300, 4)).astype(np.uint64)
    y = (X[:, 0] > 128).astype(np.float64) + 0.1 * X[:, 1] / 255
    fs = [P.gbdt.fit_oblivious_forest(X, y, num_trees=6, depth=3, n_bits=8,
                                      seed=1) for P in BOTH]
    for field in ("feature_idx", "thresholds", "leaves"):
        np.testing.assert_array_equal(getattr(fs[1], field),
                                      getattr(fs[0], field))
    eng = PORT.gbdt.GbdtPudEngine(fs[1], PORT.machine.PuDArch.MODIFIED,
                                  num_banks=8, torch_device="cpu")
    got = eng.infer(X[:20])
    addrs = np.ascontiguousarray(PORT.gbdt.reference_leaf_addrs(fs[1],
                                                                X[:20]))
    np.testing.assert_array_equal(got, PORT.gbdt.assemble_leaves(
        fs[1].leaves, addrs))
    assert np.mean((PORT.gbdt.reference_predict(fs[1], X) - y) ** 2) < \
        np.var(y)
