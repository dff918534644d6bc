"""Predicate evaluation on PuD (paper section 6.2) with the PyTorch/CUDA
port's session.

Builds an 8-feature 16-bit table, loads it on each substrate (Clutch and
the bit-serial baseline, both PuD architectures) of the PuD model whose
bank state lives on the card, submits the paper's Q2-Q5 as one
pipelined job, checks every result against NumPy (and the Clutch ones
against the session's fused kernels), reports the modeled stats, and
drops each table so the next one reuses its banks.

    PYTHONPATH=src python examples/torch_predicate_eval.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.apps import predicate as P
from repro_torch.core import cost
from repro_torch.core.machine import PuDArch
from repro_torch.pud import PudSession, Q2, Q3, Q4, Q5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--small", action="store_true",
                    help="2,000 records instead of 20,000")
    args = ap.parse_args(argv)
    n_bits = 16
    t = P.Table.generate(2_000 if args.small else 20_000, n_bits, seed=0)
    mx = (1 << n_bits) - 1
    rng = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
               y1=3 * mx // 4)
    batch = [Q2(**rng), Q3(**rng), Q4(fk=2, **rng), Q5(fl=3, fk=2, **rng)]
    print(f"table: {t.num_records} records x 8 features @ {n_bits}-bit\n")
    for arch in (PuDArch.MODIFIED, PuDArch.UNMODIFIED):
        session = PudSession(sys_cfg=cost.DESKTOP, arch=arch,
                             device=args.device)
        for method in ("clutch", "bitserial"):
            table = session.create_table(t, name=method, method=method)
            job = session.query(table, batch)
            for q, got in zip(batch, job.result):
                assert q.check(t, got), (q, got)
            if method == "clutch":
                fused = session.query(table, batch, backend="fused")
                assert all(q.check(t, got)
                           for q, got in zip(batch, fused.result))
            q2, q3, q4, q5 = job.result
            print(f"{arch.value:10s} {method:9s} "
                  f"Q2={int(q2.sum()):6d} rows  Q3={q3:6d}  "
                  f"Q4={q4:9.1f}  Q5={q5:6d}  (modeled makespan "
                  f"{job.stats.makespan_ns / 1e3:8.1f} us, overlap "
                  f"x{job.stats.overlap_efficiency:.2f})")
            # free this table's banks (coalesced) for the next one
            session.drop(table)
    print("\nall queries match NumPy ground truth")

    for nb in (8, 16, 32):
        e1 = cost.pud_compare_cost(
            "clutch", nb, PuDArch.MODIFIED, cost.DESKTOP,
            chunks=P.PAPER_PREDICATE_CHUNKS[(nb, PuDArch.MODIFIED)])
        cpu = cost.cpu_scan_cost(nb, cost.DESKTOP.parallel_cols,
                                 cost.DESKTOP)
        print(f"{nb:2d}-bit predicate, modeled on DDR4-2666: Clutch(M) "
              f"{e1.throughput_geps:7.1f} Gelem/s vs CPU "
              f"{cpu.throughput_geps:6.2f} Gelem/s -> "
              f"{e1.throughput_geps / cpu.throughput_geps:5.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
