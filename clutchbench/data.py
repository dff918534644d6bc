"""Inputs made from ``--seed``: the TPC-H ``lineitem`` columns and the
oblivious forest with its instances.

Everything is drawn on ``device`` (the card in a run) by one
``torch.Generator`` in a few large calls, then handed to the host as
NumPy, the form both the program and the reference take.  The same seed
gives the same arrays.  Nothing here imports the program.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch


def derive(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of a run's draws."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def day(text: str, epoch: str = "1992-01-01") -> int:
    """Days from ``epoch`` to the ISO date ``text``."""
    return (datetime.date.fromisoformat(text)
            - datetime.date.fromisoformat(epoch)).days


def _randint(g, lo: int, hi: int, n: int, device) -> torch.Tensor:
    """``n`` int64 draws uniform in ``[lo, hi]`` (both inclusive)."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                         dtype=torch.int64)


def retail_price(partkey: torch.Tensor) -> torch.Tensor:
    """dbgen's ``P_RETAILPRICE``, in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def lineitem(cfg: dict, seed: int, device) -> list[np.ndarray]:
    """The table's columns in ``cfg["columns"]`` order, as uint64 NumPy
    arrays of ``cfg["records"]`` rows, by dbgen's rules for lineitem."""
    g = generator(seed, device)
    n, parts, supps = cfg["records"], cfg["parts"], cfg["suppliers"]
    # lines per order, 1-7, dealt to orders in order until n rows are
    # filled (further orders only where a draw falls short)
    counts = _randint(g, 1, 7, cfg["orders"], device)
    while int(counts.sum()) < n:
        counts = torch.cat([counts, _randint(g, 1, 7, 1 + n // 64, device)])
    ends = torch.cumsum(counts, 0)
    row = torch.arange(n, device=device)
    order = torch.searchsorted(ends, row, right=True)
    # a line's number inside its order, 1-7
    linenumber = row - (ends[order] - counts[order]) + 1
    del counts, ends, row
    # dbgen's sparse order keys: 8 of every 32
    orderkey = (order // 8) * 32 + order % 8 + 1
    od_lo, od_hi = cfg["orderdate_days"]
    lag_lo, lag_hi = cfg["ship_lag_days"]
    orderdate = _randint(g, od_lo, od_hi, int(order.max()) + 1, device)[order]
    del order
    shipdate = orderdate + _randint(g, lag_lo, lag_hi, n, device)
    commitdate = orderdate + _randint(g, *cfg["commit_lag_days"], n, device)
    del orderdate
    receiptdate = shipdate + _randint(g, *cfg["receipt_lag_days"], n,
                                      device)
    partkey = _randint(g, 1, parts, n, device)
    slot = _randint(g, 0, 3, n, device)
    suppkey = (partkey + slot * (supps // 4 + (partkey - 1) // supps)) \
        % supps + 1
    del slot
    q_lo, q_hi = cfg["columns"]["l_quantity"]
    quantity = _randint(g, q_lo, q_hi, n, device)
    extendedprice = quantity * retail_price(partkey)
    discount = _randint(g, *cfg["columns"]["l_discount"], n, device)
    tax = _randint(g, *cfg["columns"]["l_tax"], n, device)
    made = {"l_orderkey": orderkey, "l_partkey": partkey,
            "l_suppkey": suppkey, "l_linenumber": linenumber,
            "l_quantity": quantity, "l_extendedprice": extendedprice,
            "l_discount": discount, "l_tax": tax, "l_shipdate": shipdate,
            "l_commitdate": commitdate, "l_receiptdate": receiptdate}
    out = []
    for name in cfg["columns"]:
        out.append(made.pop(name).cpu().numpy().view(np.uint64))
    return out


def forest(cfg: dict, seed: int, device) -> dict:
    """Feature indices [T, D] int32, thresholds [T, D] uint64 below
    2^n_bits, leaves [T, 2^D] float32."""
    g = generator(seed, device)
    t, d = cfg["trees"], cfg["depth"]
    feat = torch.randint(0, cfg["features"], (t, d), generator=g,
                         device=device, dtype=torch.int32)
    thr = torch.randint(0, 1 << cfg["n_bits"], (t, d), generator=g,
                        device=device, dtype=torch.int64)
    leaves = torch.randn((t, 1 << d), generator=g, device=device,
                         dtype=torch.float32)
    return {"feature_idx": feat.cpu().numpy(),
            "thresholds": thr.cpu().numpy().view(np.uint64),
            "leaves": leaves.cpu().numpy()}


def instances(cfg: dict, seed: int, rows: int, device) -> np.ndarray:
    """[rows, F] uint8 quantized feature values."""
    g = generator(seed, device)
    x = torch.randint(0, 1 << cfg["n_bits"], (rows, cfg["features"]),
                      generator=g, device=device, dtype=torch.uint8)
    return x.cpu().numpy()
