"""Run one benchmark cell once and print its result as the last line.

    python3 vssbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (process start to the first measured request) is timed as
``setup_s``; the window then runs for about ``--seconds``; the answers
are checked against the benchmark's own reference; the last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last).  Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits with 2.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Keep every cache inside the checkout at a fixed path, and keep
    libraries from loading JAX on their own."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from vssbench import harness

    try:
        result = harness.execute(
            args.workload, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), t_process=T_PROCESS)
    except harness.NoDevice as exc:
        print(f"vssbench: {exc}", file=sys.stderr)
        return 2
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
