"""The benchmark's command: one run of one cell.

    python3 -m graphbench.run --workload kron24.bfs --seed 7 --seconds 30 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the program (``essentials_tpu_torch``). The last line of
standard output is the result's JSON object; the compared numbers and
their limits are the last lines of standard error. Exits 3, printing no
result, without a CUDA device for the cell, and 4 where a module of JAX or
of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from graphbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"torch sees {torch.cuda.device_count()}")
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
