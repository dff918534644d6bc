"""Every mix draws the same requests from the same seed, and the TPC-H
mix keeps to the substitution-parameter ranges."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from clutchbench.data import day
from clutchbench.manifest import Manifest

HOME = Path(__file__).resolve().parents[1]
BENCH = json.loads((HOME.parent / "BENCHMARK.json").read_text())
MANIFEST = Manifest(HOME.parent / "BENCHMARK.json")
CELLS = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
QUERY_CELLS = [c for c in CELLS
               if MANIFEST.mix(c[1])["generator"] == "queries"]


def _gen(config, traffic, seed):
    cfg = MANIFEST.config(config)
    return MANIFEST.generator(MANIFEST.mix(traffic), cfg, seed, "cpu"), cfg


def _draw(config, traffic, seed, n):
    gen, cfg = _gen(config, traffic, seed)
    return gen.draw(n), cfg


@pytest.mark.parametrize("config,traffic", QUERY_CELLS)
def test_query_mix_is_deterministic_per_seed(config, traffic):
    a, _ = _draw(config, traffic, 2 ** 31 + 5, 300)
    b, _ = _draw(config, traffic, 2 ** 31 + 5, 300)
    c, _ = _draw(config, traffic, 2 ** 31 + 6, 300)
    assert a == b
    assert a != c


def _ranges(req):
    kind = req[0]
    if kind == "q1":
        return [req[1:4]]
    if kind in ("q2", "q3"):
        return [req[1:4], req[4:7]]
    if kind == "q4":
        return [req[2:5], req[5:8]]
    if kind == "q5":
        return [req[3:6], req[6:9]]
    return [r for t in req[3] for r in _ranges(t)]


@pytest.mark.parametrize("config,traffic", QUERY_CELLS)
def test_scalars_are_valid_for_the_port(config, traffic):
    reqs, cfg = _draw(config, traffic, 11, 2000)
    top = (1 << cfg["n_bits"]) - 1
    for req in reqs:
        for f, x0, x1 in _ranges(req):
            assert 0 <= f < len(cfg["columns"])
            assert 0 <= x0 < x1 <= top


def test_adhoc_bounds_are_fresh_and_inside_each_column():
    gen, cfg = _gen("tpch-lineitem-sf10", "adhoc-count", 3)
    warm = gen.warmup()
    reqs = gen.draw(4000)
    kinds = Counter(r[0] for r in reqs)
    assert kinds == {"q3": 2000, "compound": 2000}
    cols = list(cfg["columns"])
    wide = {cols.index(c) for c in gen.spec["wide"]}
    assert len(wide) == 7
    lims = list(cfg["columns"].values())
    ranges = []
    for r in warm + reqs:
        if r[0] == "q3":
            assert r[1] != r[4]                 # two distinct columns
        elif r[0] == "compound":
            assert r[1] is True and 2 <= len(r[3]) <= 3
            assert set(r[2]) <= {"and", "or"}
        for f, x0, x1 in _ranges(r):
            lo, hi = lims[f]
            assert f in wide
            assert max(lo - 1, 0) <= x0 < x1 <= hi + 1
            ranges.append((f, x0, x1))
    # fresh: no column and bounds drawn twice in a run, warm-up included
    assert len(set(ranges)) == len(ranges) > 10000
    # every wide column is drawn, the three dates among them
    assert {f for f, _, _ in ranges} == wide
    for name in ("l_shipdate", "l_commitdate", "l_receiptdate"):
        assert cols.index(name) in wide


def test_tpch_where_follows_the_substitution_rules():
    reqs, cfg = _draw("tpch-lineitem-sf10", "tpch-where", 8, 5000)
    cols = list(cfg["columns"])
    ship, disc, qty, price, receipt = (cols.index(c) for c in (
        "l_shipdate", "l_discount", "l_quantity", "l_extendedprice",
        "l_receiptdate"))
    years = {day(f"{y}-01-01") - 1: day(f"{y + 1}-01-01")
             for y in range(1993, 1998)}
    shapes = Counter()
    for r in reqs:
        if r[0] == "compound" and r[2] == ("and", "and"):        # Q6
            shapes["Q6"] += 1
            (_, f0, a0, b0), (_, f1, a1, b1), (_, f2, a2, b2) = r[3]
            assert r[1] is False and (f0, f1, f2) == (ship, disc, qty)
            assert years[a0] == b0                  # [DATE, DATE + 1 y)
            d = a1 + 2                              # D - 0.01 .. D + 0.01
            assert 2 <= d <= 9 and b1 == d + 2
            assert a2 == 0 and b2 in (24, 25)       # quantity < QTY
        elif r[0] == "compound":                                # Q19
            shapes["Q19"] += 1
            assert r[2] == ("or", "or")
            for (_, f, a, b), (lo, hi) in zip(r[3], ((1, 10), (10, 20),
                                                      (20, 30))):
                assert f == qty and lo <= a + 1 <= hi and b == a + 12
        elif r[0] == "q1" and r[1] == receipt:                  # Q12
            shapes["Q12"] += 1
            assert years[r[2]] == r[3]              # [DATE, DATE + 1 y)
        elif r[0] == "q1" and r[2] == 0:                        # Q1
            shapes["Q1"] += 1
            delta = day("1998-12-01") - (r[3] - 1)
            assert r[1] == ship and 60 <= delta <= 120
        elif r[0] == "q1":                                      # Q14
            shapes["Q14"] += 1
            start = r[2] + 1
            assert r[1] == ship
            assert day("1993-01-01") <= start <= day("1997-12-01")
            assert 28 <= r[3] - start <= 31
        elif r[0] == "q4":
            shapes["Q4"] += 1
            assert r[1] in (qty, price) and r[2] == ship and r[5] == disc
            assert years[r[3]] == r[4] and 2 <= r[6] + 2 <= 9
        else:
            shapes["Q5"] += 1
            assert r[0] == "q5" and r[1] == price and r[2] == price
            assert r[3] == ship and years[r[4]] == r[5] and r[6] == qty
    # every block of 20 holds each query its share of times exactly
    want = {"Q6": .25, "Q14": .15, "Q12": .10, "Q1": .10, "Q19": .15,
            "Q4": .15, "Q5": .10}
    assert shapes == {k: round(v * len(reqs)) for k, v in want.items()}


def test_blocks_give_every_seed_the_same_mix():
    for seed in (1, 2 ** 31 + 99):
        reqs, _ = _draw("tpch-lineitem-sf10", "tpch-where", seed, 40)
        for block in (reqs[:20], reqs[20:]):
            kinds = Counter((r[0], r[2] if r[0] == "compound" else None)
                            for r in block)
            assert kinds[("q4", None)] == 3 and kinds[("q5", None)] == 2
            assert kinds[("compound", ("and", "and"))] == 5
    reqs, _ = _draw("tpch-lineitem-sf10", "adhoc-count", 5, 1000)
    assert all({reqs[i][0], reqs[i + 1][0]} == {"q3", "compound"}
               for i in range(0, 1000, 2))


@pytest.mark.parametrize("traffic", ["bulk-65536", "online-256"])
def test_predict_instances_are_deterministic_per_seed(traffic):
    spec = dict(MANIFEST.mix(traffic), batch=30)
    cfg = MANIFEST.config("catboost-higgs-1000x6")

    def draw(seed):
        gen = MANIFEST.generator(spec, cfg, seed, "cpu")
        return np.concatenate(gen.draw(10) + gen.draw(10))
    a, b = draw(2 ** 31 + 9), draw(2 ** 31 + 9)
    assert a.shape == (600, 28) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a[:300], a[300:])    # each block fresh
    assert not np.array_equal(a, draw(2 ** 31 + 10))


def test_lineitem_columns_follow_dbgen():
    from clutchbench import data
    cfg = json.loads((HOME / "configs" / "tpch-lineitem-sf10.json"
                      ).read_text())
    cfg.update(records=40000, orders=10000, parts=4000, suppliers=400)
    cols = dict(zip(cfg["columns"], data.lineitem(cfg, 7, "cpu")))
    again = data.lineitem(cfg, 7, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(cols.values(), again))
    ok = cols["l_orderkey"].astype(np.int64)
    assert (np.diff(ok) >= 0).all() and ok.min() == 1
    assert ((ok - 1) % 32 < 8).all()               # dbgen's sparse keys
    pk = cols["l_partkey"].astype(np.int64)
    assert pk.min() >= 1 and pk.max() <= 4000
    rp = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    q = cols["l_quantity"].astype(np.int64)
    assert np.array_equal(cols["l_extendedprice"].astype(np.int64), q * rp)
    sk = cols["l_suppkey"].astype(np.int64)
    assert sk.min() >= 1 and sk.max() <= 400
    for name in ("l_linenumber", "l_quantity", "l_discount", "l_tax",
                 "l_shipdate", "l_commitdate", "l_receiptdate"):
        lo, hi = cfg["columns"][name]
        v = cols[name].astype(np.int64)
        assert lo <= v.min() and v.max() <= hi
    # an order's lines are numbered 1, 2, ... in table order
    ln = cols["l_linenumber"].astype(np.int64)
    first = np.r_[True, ok[1:] != ok[:-1]]
    assert (ln[first] == 1).all() and (ln[~first] == ln[:-1][~first[1:]]
                                       + 1).all()
    ship = cols["l_shipdate"].astype(np.int64)
    lag = cols["l_receiptdate"].astype(np.int64) - ship
    assert lag.min() == 1 and lag.max() == 30
    # commit and ship dates come from one order date: within an order
    # they differ by less than 30-90 days minus 1-121 days allows
    commit = cols["l_commitdate"].astype(np.int64)
    assert ((commit - ship) >= 30 - 121).all() and ((commit - ship)
                                                    <= 90 - 1).all()
