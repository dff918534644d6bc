"""Quickstart of the PyTorch/CUDA port: one range predicate three ways.

Runs ``x0 < f < x1`` over 100K 32-bit records through:
  1. a ``PudSession`` on the command-level PuD model (Unmodified DRAM,
     traced and bus-scheduled commands; the bank state on the card),
  2. the same session's ``backend="fused"`` job and the
     ``clutch_compare`` kernel front-end on the card,
  3. the analytical DRAM cost model (a DDR4-2666 desktop, modeled),
and checks them against NumPy.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import cost
from repro_torch.core.clutch import clutch_op_count
from repro_torch.core.encoding import make_plan
from repro_torch.core.machine import PuDArch
from repro_torch.kernels import ops
from repro_torch.pud import PudSession, Q1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--small", action="store_true",
                    help="4,000 records instead of 100,000")
    args = ap.parse_args(argv)
    n_bits, chunks = 32, 12
    n = 4_000 if args.small else 100_000
    rng = np.random.default_rng(0)
    values = rng.integers(0, 1 << n_bits, n, dtype=np.uint64)
    x0 = int(rng.integers(0, 1 << (n_bits - 1)))
    x1 = int(rng.integers(x0 + 1, 1 << n_bits))
    plan = make_plan(n_bits, chunks)
    print(f"range predicate {x0} < f < {x1} over {n} x {n_bits}-bit "
          f"values, {chunks} chunks -> {plan.rows_required} LUT rows")

    # 1. the session over the PuD model: declare the table, submit the
    #    query as a job, read the result and its scheduled stats
    session = PudSession(sys_cfg=cost.DESKTOP, num_devices=1,
                         arch=PuDArch.UNMODIFIED, device=args.device)
    table = session.create_table(values[:, None], n_bits=n_bits,
                                 name="quickstart")
    job = session.query(table, Q1(fi=0, x0=x0, x1=x1))

    # 2. the card's kernels: the fused job, and one compare front-end
    fused = session.query(table, Q1(fi=0, x0=x0, x1=x1), backend="fused")
    gt = ops.clutch_compare(values.astype(np.uint32).view(np.int32), x0,
                            make_plan(n_bits, 5), device=session.device)

    want = (values > x0) & (values < x1)
    assert (job.result == want).all() and (fused.result == want).all()
    assert (gt.cpu().numpy() == (values > x0)).all()
    print(f"bitmaps match NumPy on the model and the kernels "
          f"({session.device})")
    print(f"machine job: {len(job.timeline.waves)} scheduled waves, "
          f"modeled makespan {job.stats.makespan_ns / 1e3:.2f} us on "
          f"{cost.DESKTOP.name} ({clutch_op_count(chunks, PuDArch.UNMODIFIED)}"
          f" PuD ops a {chunks}-chunk compare); fused job "
          f"{fused.wallclock_ns / 1e6:.2f} ms measured")

    for name, method in [("clutch", "clutch"), ("bit-serial", "bitserial")]:
        c = cost.pud_compare_cost(method, n_bits, PuDArch.UNMODIFIED,
                                  cost.DESKTOP, chunks=5)
        print(f"{name:11s}: {c.time_ns / 1e3:8.2f} us/batch "
              f"{c.throughput_geps:8.1f} Gelem/s "
              f"{c.elems_per_uj:10.0f} elem/uJ   (modeled DDR4-2666)")
    cpu = cost.cpu_scan_cost(n_bits, cost.DESKTOP.parallel_cols,
                             cost.DESKTOP)
    print(f"{'cpu-scan':11s}: {cpu.time_ns / 1e3:8.2f} us/batch "
          f"{cpu.throughput_geps:8.2f} Gelem/s "
          f"{cpu.elems_per_uj:10.0f} elem/uJ   (modeled BitWeaving-V)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
