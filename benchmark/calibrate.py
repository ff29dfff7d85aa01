"""The readings that a cell's limits are set from (limits/<cell>.json), on
the card, at the cell's own sizes, in one process:

    python3 benchmark/calibrate.py --workload <cell> --program-seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults 7,8,9]

* program: the program's numbers on each seed (the set-up steps that a
  run compares) against the reference, as a run computes them;
* control: the reference put in the program's place with TF32 on, the
  precision below the configuration's float32, judged by the reference in
  float32;
* faults: the reference in the program's place with the
  loss taken over half of the batch; a state left unchanged reads 1 in
  the change numbers by their definition and needs no run.

Every number is printed, not only those the cell compares,
one JSON line a reading, then the largest program reading and the least
control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(workload: str, program: list, control: list, faults: list,
             device=None, bench_root: str = ROOT) -> list:
    """[(what, seed, {number: value})] for every reading asked for."""
    import torch

    from benchmark.lib import compare, port, spec
    cell = spec.find_cell(workload, root=bench_root,
                          bench_dir=os.path.join(bench_root, "benchmark"))
    device = device or torch.device("cuda", 0)
    port.pin_precision(cell.config)
    adapter_cls = spec.path_adapter(cell.traffic["path"],
                                    os.path.join(bench_root, "benchmark")).Path
    out = []

    def numbers(a, record):
        return compare.train_numbers(record, a.reference_record(follow=record))

    for seed in program:
        a = adapter_cls(cell, seed, device)
        a.setup()
        record = a.program_record()
        a.release()
        out.append(("program", seed, numbers(a, record)))
    for what, seeds, precision, fault in (("control", control, "tf32", None),
                                          ("fault_half", faults, None, "half")):
        for seed in seeds:
            a = adapter_cls(cell, seed, device)
            a.param_names = a.reference_names()
            out.append((what, seed, numbers(a, a.reference_record(precision, fault))))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--faults", type=_seeds, default=[])
    args = p.parse_args(argv)
    rows = readings(args.workload, args.program_seeds, args.control_seeds, args.faults)
    for what, seed, nums in rows:
        print(json.dumps({"reading": what, "seed": seed, **nums}), flush=True)
    summary = {}
    for what, _, nums in rows:
        for name, v in nums.items():
            s = summary.setdefault(name, {})
            pick = max if what == "program" else min
            s[what] = pick(s.get(what, v), v)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
