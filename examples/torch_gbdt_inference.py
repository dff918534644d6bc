"""GBDT (oblivious-tree) inference on PuD (paper section 6.1) with the
PyTorch/CUDA port: fit a booster, load it as a session forest on the
PuD model (thresholds and one-hot masks in channel-spread bank groups,
bank state on the card), predict batches, and sum leaves on the card's
``leaf_gather`` kernel.

    PYTHONPATH=src python examples/torch_gbdt_inference.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.apps import gbdt as G
from repro_torch.core.machine import PuDArch
from repro_torch.kernels import ops
from repro_torch.pud import PudSession


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--small", action="store_true",
                    help="16 trees over 500 records instead of 64 over "
                         "2,000")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n, nf, n_bits = (500, 8, 8) if args.small else (2000, 8, 8)
    x = rng.integers(0, 1 << n_bits, (n, nf), dtype=np.uint64)
    y = (np.sin(x[:, 0] / 37.0) + (x[:, 1] > 128) * 0.8
         - 0.3 * (x[:, 2] / 255.0))
    forest = G.fit_oblivious_forest(x, y, num_trees=16 if args.small
                                    else 64, depth=6, n_bits=n_bits)
    pred = G.reference_predict(forest, x)
    mae = np.abs(pred - y).mean()
    print(f"fitted {forest.num_trees} trees depth {forest.depth}; "
          f"train MAE {mae:.3f} (baseline {np.abs(y - y.mean()).mean():.3f})")

    batch = x[:16]
    addrs = np.ascontiguousarray(G.reference_leaf_addrs(forest, batch))
    want = G.assemble_leaves(forest.leaves, addrs)
    for arch in (PuDArch.MODIFIED, PuDArch.UNMODIFIED):
        session = PudSession(arch=arch, device=args.device)
        ranker = session.load_forest(forest, name="ranker",
                                     banks_per_group=2)
        job = session.predict(ranker, batch)
        fused = session.predict(ranker, batch, backend="fused")
        assert np.array_equal(job.result, want)
        assert np.array_equal(fused.result, want)
        eng = session.executor(ranker).engines[0]
        print(f"{arch.value:10s}: PuD inference exact; "
              f"{eng.ops_per_instance} PuD ops/instance "
              f"({eng.num_chunks} chunks/feature, {forest.num_features} "
              f"features); modeled batch makespan "
              f"{job.stats.makespan_ns / 1e3:.1f} us across "
              f"{len(session.devices)} device(s)")

    # leaf aggregation on the card's leaf_gather kernel
    addrs = G.reference_leaf_addrs(forest, x[:256])
    leaf_sum = ops.gbdt_leaf_sum(addrs, forest.leaves,
                                 device=session.device)
    np.testing.assert_allclose(leaf_sum.cpu().numpy(),
                               G.reference_predict(forest, x[:256]),
                               rtol=1e-4, atol=1e-3)
    print("leaf_gather kernel matches the reference aggregation")
    return 0


if __name__ == "__main__":
    sys.exit(main())
