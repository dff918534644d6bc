"""The bit-serial PuD comparison baseline (SIMDRAM/Ambit style).

The bitmap of ``a < B_i`` is the final borrow of ``a - B``, evaluated
LSB to MSB as ``borrow_{i+1} = MAJ3(NOT a_i, b_i, borrow_i)``.  The host
knows ``NOT a_i`` and stages it from the constant rows, so ``>`` and
``>=`` need no in-DRAM NOT; ``<`` and ``<=`` use the dual-contact NOT on
Modified PuD and a complement copy of the bit-planes on Unmodified PuD.

Op counts (:func:`bitserial_op_count`): ``4n + 1`` on Modified and
``5n + 1`` on Unmodified (n staging copies, one init, 3 or 4 per bit);
the paper's own ~4n / ~6n accounting is
:func:`paper_bitserial_op_count`.  The reference package's
``core/bitserial.py`` under the same names.
"""

from __future__ import annotations


import numpy as np

from .encoding import load_binary_vector
from .machine import BankedSubarray, PuDArch, unpack_bits


def bitserial_op_count(n_bits: int, arch: PuDArch) -> int:
    """Closed-form op count of our microcode (see module docstring)."""
    if arch is PuDArch.MODIFIED:
        return 4 * n_bits + 1
    return 5 * n_bits + 1


def paper_bitserial_op_count(n_bits: int, arch: PuDArch) -> int:
    """The paper's stated ~4n / ~6n accounting (used for the
    'paper-faithful' columns of the benchmark tables)."""
    return (4 if arch is PuDArch.MODIFIED else 6) * n_bits


class BitSerialEngine:
    """Binary bit-plane layout + bit-serial comparison; mirrors the
    :class:`repro_torch.core.clutch.ClutchEngine` predicate API."""

    def __init__(self, sub: BankedSubarray, values: np.ndarray,
                 n_bits: int) -> None:
        """``values``: [n] (broadcast to every bank) or [banks, n] (one
        shard per bank).  The borrow chain uses only broadcast row
        addresses, so banked execution needs no per-bank gathers -- the
        same scalar is compared against every bank's shard concurrently."""
        self.sub = sub
        self.n_bits = n_bits
        self.n = int(np.asarray(values).shape[-1])
        self.max = (1 << n_bits) - 1
        self.base = load_binary_vector(sub, values, n_bits)
        if sub.arch is PuDArch.UNMODIFIED:
            comp = (self.max - np.asarray(values, np.uint64)).astype(np.uint64)
            self.base_c = load_binary_vector(sub, comp, n_bits)
        else:
            self.base_c = None
        # Rows where the scalar's (complemented) bits are staged each call.
        self.scalar_rows = sub.alloc(n_bits)
        self._scratch = [sub.alloc(1), sub.alloc(1)]

    # ------------------------------------------------------------------ #
    def _borrow_chain(self, a: int, plane_base: int) -> int:
        """MAJ3 borrow chain; returns the accumulator row holding the
        bitmap of (a < V) where V is the vector at ``plane_base``."""
        sub = self.sub
        # Stage NOT(a_i) from the constant rows (scalar initialization).
        for i in range(self.n_bits):
            bit = (a >> i) & 1
            sub.rowcopy(sub.ROW_ZERO if bit else sub.ROW_ONE,
                        self.scalar_rows + i)
        acc_home = sub.T0 if sub.arch is PuDArch.MODIFIED else sub.G[0]
        sub.rowcopy(sub.ROW_ZERO, acc_home)          # borrow_0 = 0
        acc = acc_home
        for i in range(self.n_bits):
            acc = sub.maj3_into_acc(acc, self.scalar_rows + i, plane_base + i)
        return acc

    def compare_lt_scalar_vector(self, a: int) -> int:
        """Bitmap row of ``a < B_i``  (== element-side ``B > a``)."""
        return self._borrow_chain(a, self.base)

    # ---------------- element-vs-scalar predicate API ------------------ #
    def predicate(self, op: str, x: int, save_to: int | None = None) -> int:
        sub = self.sub
        if op == ">":
            row = self._borrow_chain(x, self.base)
        elif op == ">=":
            row = sub.ROW_ONE if x == 0 \
                else self._borrow_chain(x - 1, self.base)
        elif op == "<":
            if x == 0:
                row = sub.ROW_ZERO
            elif sub.arch is PuDArch.UNMODIFIED:
                assert self.base_c is not None
                row = self._borrow_chain(self.max - x, self.base_c)
            else:
                row = self._borrow_chain(x - 1, self.base)
                sub.bulk_not(row, sub.DCC0)
                row = sub.DCC0
        elif op == "<=":
            if x == self.max:
                row = sub.ROW_ONE
            elif sub.arch is PuDArch.UNMODIFIED:
                assert self.base_c is not None
                row = self._borrow_chain(self.max - x - 1, self.base_c)
            else:
                row = self._borrow_chain(x, self.base)
                sub.bulk_not(row, sub.DCC0)
                row = sub.DCC0
        elif op == "==":
            le = self.predicate("<=", x, save_to=self._scratch[0])
            ge = self.predicate(">=", x, save_to=self._scratch[1])
            row = sub.maj3_into_acc(le, ge, sub.ROW_ZERO)
        else:
            raise ValueError(f"unknown operator {op!r}")
        if save_to is not None and row != save_to:
            sub.rowcopy(row, save_to)
            row = save_to
        return row

    def read_bitmap(self, row: int) -> np.ndarray:
        words = self.sub.host_read_row(row)
        return unpack_bits(words, self.n).astype(bool)
