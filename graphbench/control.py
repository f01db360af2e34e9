"""The control of the check that decides ``correct``, at a cell's own size.

    python3 -m graphbench.control --workload urand24.sssp --seeds 11,12,13

The control is the reference put in the program's place with one
guarantee broken (``algos/<algorithm>.py``'s ``control``: BFS predecessors
by the largest-id parent, SSSP in bfloat16). For each seed it makes the
cell's graph and sources as a run does, answers the first
``check_sample`` sources of the pool with the control, and compares them
with the reference as a run's check compares the program's answers: the
worst count of vertices whose answer differs (the number a run compares),
and beside it the worst count per part of the answer. Each seed's line
says whether the check would pass; a sound check fails every one. The
benchmark's runs do not run this.
"""

import argparse
import sys
import time

import torch

from graphbench import graphs, harness


def control_readings(cell, seed: int, device: str = "cuda") -> dict:
    st = harness.prepare(cell, seed, device)
    src = graphs.rows_of(st.csr)
    worst = {"answer_mismatch": 0, **dict.fromkeys(cell.algo.ANSWER, 0)}
    for source in st.sources[:cell.traffic["check_sample"]]:
        n, parts = harness.answer_mismatch(
            cell.algo.control(st.csr, src, source),
            cell.algo.expected(st.csr, src, source))
        worst["answer_mismatch"] = max(worst["answer_mismatch"], n)
        for name, c in zip(cell.algo.ANSWER, parts):
            worst[name] = max(worst[name], c)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        got = control_readings(cell, seed)
        passes = harness.holds("answer_mismatch", got["answer_mismatch"])
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{k} {v}" for k, v in got.items())
              + f"; check {'passes' if passes else 'fails'}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
