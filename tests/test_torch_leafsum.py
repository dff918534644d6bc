"""GBDT predictions summed from the leaf bits: ``gbdt_leafbits_sum``.

The fused executor sums each instance's leaves on the card in the order
of ``apps.gbdt.assemble_leaves`` (NumPy's pairwise float32 sum of a
C-ordered row).  Here the kernel's plain version, which the wrapper
runs for CPU tensors, is held bit for bit (``tobytes()``) against
``assemble_leaves`` over the executor's own leaf addresses: at tree
counts on both sides of NumPy's 8-wide unroll and 128-value blocks,
depths 1-8 (``L = 2 ** D``), batches of 0, 1 and 33, and leaves spread
over six decades.  The comparison is with the NumPy installed, so these
tests fail if that NumPy sums in another order.
"""

import contextlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro_torch import convert
from repro_torch.apps.gbdt import ObliviousForest, assemble_leaves
from repro_torch.kernels import ref
from repro_torch.kernels.fused_query import (
    SUM_BLOCK,
    SUM_MAX_DEPTH,
    SUM_PROG,
    SUM_STACK,
    gbdt_leafbits_sum,
    sum_program,
)
from repro_torch.kernels.fused_session import FusedGbdtExec

CSRC = Path(ref.__file__).resolve().parent / "csrc" / "fused_query.cu"
TREES = (1, 7, 8, 9, 127, 128, 129, 255, 256, 257, 1000, 1001)


def _executor(trees: int, depth: int, seed: int) -> FusedGbdtExec:
    """A random forest of 5 features at 8 bits, its leaves drawn with
    magnitudes from 1e-3 to 1e3 and both signs."""
    rng = np.random.default_rng(seed)
    f = ObliviousForest.random(trees, depth, 5, 8, seed=seed)
    shape = (trees, 1 << depth)
    leaves = rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, shape)
    f = convert.forest(f.feature_idx, f.thresholds, leaves, 8, 5)
    return FusedGbdtExec(f, 1, device="cpu")


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("trees", TREES)
def test_leafbits_sum_ref_is_assemble_leaves_bit_for_bit(trees, depth):
    ex = _executor(trees, depth, seed=trees * 10 + depth)
    rng = np.random.default_rng(depth)
    for b in (0, 1, 33):
        X = rng.integers(0, 256, (b, 5))
        want = assemble_leaves(ex.forest.leaves, ex.leaf_addrs(X))
        got = ref.gbdt_leafbits_sum_ref(ex._leaf_bits(X), ex.leaves, trees,
                                        depth)
        assert got.dtype == torch.float32 and got.shape == (b,)
        assert got.numpy().tobytes() == want.tobytes(), (trees, depth, b)
        assert ex.infer(X).tobytes() == want.tobytes(), (trees, depth, b)


def test_the_order_is_what_makes_the_bits():
    """A left-to-right float32 sum of the same leaves misses most rows,
    so the bit-for-bit checks above do pin the order."""
    ex = _executor(1000, 6, seed=7)
    X = np.random.default_rng(0).integers(0, 256, (256, 5))
    vals = ex.forest.leaves[np.arange(1000)[None], ex.leaf_addrs(X)]
    plain = np.zeros(256, np.float32)
    for t in range(1000):
        plain += vals[:, t]
    got = ex.infer(X)
    assert got.tobytes() == assemble_leaves(ex.forest.leaves,
                                            ex.leaf_addrs(X)).tobytes()
    assert (plain != got).mean() > 0.5


def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_nothing():
    ex = _executor(129, 4, seed=1)
    bm = ex._leaf_bits(np.random.default_rng(2).integers(0, 256, (9, 5)))
    K.reset_launch_counts()
    got = gbdt_leafbits_sum(bm, ex.leaves, 129, 4)
    assert torch.equal(got, ref.gbdt_leafbits_sum_ref(bm, ex.leaves, 129, 4))
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def test_wrapper_refuses_what_the_kernel_cannot_sum():
    ex = _executor(40, 3, seed=3)
    bm = ex._leaf_bits(np.random.default_rng(4).integers(0, 256, (5, 5)))
    leaves, w = ex.leaves, bm.shape[1]
    with pytest.raises(ValueError, match="bitmap must be a 2-D int32"):
        gbdt_leafbits_sum(bm.to(torch.int64), leaves, 40, 3)
    with pytest.raises(ValueError, match="bitmap must be a 2-D int32"):
        gbdt_leafbits_sum(bm[0], leaves, 40, 3)
    with pytest.raises(ValueError, match="float32"):
        gbdt_leafbits_sum(bm, leaves.double(), 40, 3)
    with pytest.raises(ValueError, match="float32"):
        gbdt_leafbits_sum(bm, leaves[0], 40, 3)
    with pytest.raises(ValueError, match="rows of leaves"):
        gbdt_leafbits_sum(bm, leaves[:39], 40, 3)
    with pytest.raises(ValueError, match="2 \\*\\* depth leaves"):
        gbdt_leafbits_sum(bm, leaves[:, :4], 40, 3)
    with pytest.raises(ValueError, match="depth"):
        gbdt_leafbits_sum(bm, leaves, 40, 0)
    with pytest.raises(ValueError, match="120 bits, the bitmap holds 96"):
        gbdt_leafbits_sum(bm[:, :3], leaves, 40, 3)
    many = torch.zeros((32 * w + 1, 2))
    with pytest.raises(ValueError, match=f"the bitmap holds {32 * w}"):
        gbdt_leafbits_sum(bm, many, 32 * w + 1, 1)


def test_kernel_limits_match_the_cuda_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("SUM_PROG"), const("SUM_STACK"), const("SUM_BLOCK")) == \
        (SUM_PROG, SUM_STACK, SUM_BLOCK) == (1024, 16, 128)
    assert f"D > {SUM_MAX_DEPTH}" in src


@contextlib.contextmanager
def _bufsize(n):
    old = np.setbufsize(n)
    try:
        yield
    finally:
        np.setbufsize(old)


def _run_program(vals: np.ndarray, run: int) -> np.ndarray:
    """``sum_program``'s codes evaluated as ``leafsum_kernel`` does, over
    the rows of ``vals`` [B, T] float32: per block the eight lanes'
    accumulators, their combine by XOR partners 1, 2, 4, the tail, the
    joins on a stack, and 0 + the total."""
    codes, stack = sum_program(vals.shape[1], run)
    stk, sp, t0 = [None] * stack, 0, 0
    for code in codes:
        n, joins = code & 0xff, code >> 8
        a = vals[:, t0:t0 + n]
        if n < 8:
            s = np.zeros(vals.shape[0], np.float32)
            for i in range(n):
                s = s + a[:, i]
        else:
            m = n - n % 8
            r = a[:, :8].copy()
            for i in range(8, m, 8):
                r = r + a[:, i:i + 8]
            for x in (1, 2, 4):
                r = r + r[:, np.arange(8) ^ x]
            assert (r == r[:, :1]).all()
            s = r[:, 0]
            for i in range(m, n):
                s = s + a[:, i]
        for q in range(1, joins + 1):
            s = stk[sp - q] + s
        stk[sp - joins] = s
        sp, t0 = sp + 1 - joins, t0 + n
    assert sp == 1 and t0 == vals.shape[1]
    return np.float32(0) + stk[0]


def test_sum_program_of_a_thousand_trees():
    """The shape ``leafsum_kernel`` runs in both predict cells."""
    codes, stack = sum_program(1000, 8192)
    assert [c & 0xff for c in codes] == [120, 128] * 3 + [128, 128]
    assert [c >> 8 for c in codes] == [0, 1, 0, 2, 0, 1, 0, 3]
    assert stack == 4


@pytest.mark.parametrize("trees,bufsize", [
    (0, 8192), (1, 8192), (7, 8192), (8, 8192), (129, 8192), (1000, 8192),
    (8192, 8192), (8193, 8192), (12388, 8192), (12388, 4096),
    (12388, 16384), (5000, 2048), (65536, 8192)])
def test_kernel_order_and_plain_version_follow_numpys_buffer(trees,
                                                             bufsize):
    """A row longer than NumPy's buffer is summed a buffer at a time by
    some NumPy versions (2.0) and whole by others (2.3); the program and
    the plain version follow what ``ref.numpy_row_run`` finds, and the
    largest forest the kernel takes fits its program and stack."""
    rng = np.random.default_rng(trees)
    shape = (trees, 4)
    leaves = (rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, shape)
              ).astype(np.float32)
    addrs = rng.integers(0, 4, (6, trees)).astype(np.int32)
    bits = (addrs[:, :, None] >> np.array([1, 0])) & 1
    words = np.zeros((6, max(1, -(-2 * trees // 32))), np.uint32)
    for n in range(2 * trees):
        words[:, n // 32] |= bits.reshape(6, -1)[:, n].astype(
            np.uint32) << np.uint32(n % 32)
    bm = torch.from_numpy(words.view(np.int32))
    with _bufsize(bufsize):
        want = assemble_leaves(leaves, addrs)
        got = ref.gbdt_leafbits_sum_ref(bm, torch.from_numpy(leaves),
                                        trees, 2)
        run = ref.numpy_row_run(trees)
    vals = leaves[np.arange(trees)[None], addrs]
    assert got.numpy().tobytes() == want.tobytes()
    assert _run_program(vals, run).tobytes() == want.tobytes()
    codes, stack = sum_program(trees, run)
    assert len(codes) <= SUM_PROG and stack <= SUM_STACK
    # a row within the buffer is one pairwise sum, whatever the NumPy
    assert run == max(trees, 1) or (trees > bufsize and run in (bufsize,
                                                         sys.maxsize))
