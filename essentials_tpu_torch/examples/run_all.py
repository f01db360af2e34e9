"""Run every algorithm on one graph and validate (examples smoke driver).

Counterpart of the JAX package's ``examples/run_all.py``, through the
port's CLI. Usage:

    python -m essentials_tpu_torch.examples.run_all [graph.mtx] [--cpu]
"""

import sys

ALGOS = ["bfs", "sssp", "pr", "ppr", "bc", "color", "kcore", "hits",
         "spmv", "tc", "mst", "spgemm"]


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    if cpu:
        args.remove("--cpu")
    graph = args[0] if args else "datasets/chesapeake.mtx"
    from essentials_tpu_torch.cli import main as cli
    failures = 0
    for algo in ALGOS:
        argv = [algo, graph, "--validate", "--undirected"]
        if cpu:
            argv.append("--cpu")
        print(f"== {algo} ==")
        failures += cli(argv)
    print(f"{len(ALGOS) - failures}/{len(ALGOS)} algorithms validated")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
