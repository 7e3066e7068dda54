"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the log, ending with the same checks,
goes to standard error. Without the CUDA devices the cell asks for, or
when the process holds JAX or the JAX package after the window, it
exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # Caches of compiled kernels at fixed places inside the checkout (the
    # port's own CUDA build goes to build/repro_torch/ beside them).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    from bench.harness import RunFailed, forbidden_modules, log, run_cell
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except (RunFailed, ImportError) as exc:
        log(f"no result: {exc}")
        return 2
    found = forbidden_modules()
    if found:
        log(f"no result: the measured process holds {found}")
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
