#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each number the correctness check
compared beside its limit; the same numbers end standard error. It exits
non-zero and prints no result without as many CUDA devices as the cell asks
for, or if JAX or the JAX package (``climsr_tpu``) is loaded once the window
has closed.

``--control`` runs the cell's control instead of the program: the plain
reference in float8 put in the program's place and held to the same numbers
(it must come out not correct). The benchmark's own runs never pass it.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from perfbench import guard, harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_entry(cell, args.seed, args.seconds, bool(args.trace), device, START, args.control)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded in the run: {loaded}", file=sys.stderr)
        return 3
    print(f"notes {json.dumps(dict(out.notes, readings=out.checks), default=str)}", file=sys.stderr)
    if args.control:
        checks = harness.judge(cell, out.checks)
        line = {"control": True, "correct": harness.passed(checks), "checks": checks}
    else:
        line = harness.result_line(cell, out, bool(args.trace), torch.cuda.get_device_name(0), cell.chips)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
