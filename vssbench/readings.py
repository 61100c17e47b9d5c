"""Readings that a cell's limits are set from, run on the card.

    python3 vssbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 10

Runs the cell in this one process, once a seed: the program as the
configuration states it, then the control (the stored original one tier
below the configuration's), and prints each run's compared numbers as
one JSON line.  The benchmark's own runs never call this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    from vssbench import harness

    plan = [(False, args.first_seed + 7919 * i) for i in range(args.seeds)]
    plan += [(True, args.first_seed + 104729 * (i + 1))
             for i in range(args.control_seeds)]
    for control, seed in plan:
        t0 = time.perf_counter()
        r = harness.execute(args.workload, seed=seed, seconds=args.seconds,
                            trace=False, control=control)
        print(json.dumps({"workload": args.workload, "control": control,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"],
                          "metrics": r["metrics"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
