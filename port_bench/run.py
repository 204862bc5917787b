"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The run draws its weights and clips from
the seed, warms the cell's shapes, drives the timed entry back to back for
`seconds`, checks what it produced against the plain reference and prints,
as the last line of standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 breakdown, and last the compared
numbers with their limits (also the last lines of standard error). Without
a CUDA device it exits 2 and prints no result; if jax, jaxlib, flax or the
JAX package is loaded once the window has closed, it exits 3.
"""

import time

STARTED = time.perf_counter()  # set-up counts from here: before any import of weight

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout's root, not port_bench/ (whose names could shadow the stdlib's)
BUILD = ROOT / "build" / "port_bench"
# every cache a build or compile may use, at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "nv_compute_cache")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), STARTED)
    found = harness.banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the port must run without JAX)", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
