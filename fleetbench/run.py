"""The benchmark's command:

    python3 -m fleetbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's chips.  Prints
the result as the last line of standard output, and every number compared
with its limit as the last lines of standard error.  Exits 2 without the
card (or its count) and 3 if JAX or the JAX package was loaded, printing
no result either way.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


HERE = os.path.dirname(os.path.abspath(__file__))


def _environment() -> None:
    """Before torch loads: every kernel and build cache at a fixed path
    inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(HERE, ".cache", sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="an open loop's rate in ops/s in place of the cell's (for a sweep)")
    ap.add_argument("--control", action="store_true",
                    help="judge the reference with an op left out in the program's place")
    args = ap.parse_args(argv)

    _environment()
    from fleetbench import harness, spec

    cell = spec.load("workloads", args.workload)
    config = spec.load("configs", cell["config"])
    traffic = spec.load("traffic", cell["traffic"])
    metrics = spec.cell_metrics(spec.benchmark(), args.workload, bool(args.trace))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"fleetbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, cell, config, traffic, metrics, args.seed,
                              args.seconds, bool(args.trace), "cuda", T_START,
                              rate=args.rate, control=args.control)
    print("fleetbench: " + json.dumps(result.pop("diag")), file=sys.stderr)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"fleetbench: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    missing = [m["name"] for m in metrics if m["name"] not in result["metrics"]]
    if missing:
        print(f"fleetbench: no reading of {', '.join(missing)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']}", file=sys.stderr)
    if missing:
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
