"""The readings a cell's limits are set from, at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 1]

For each of ``--seeds`` one short window at the cell's own load, its
sampled items compared with the reference as a run compares them (the
program's readings: the lower end of each limit); for each of
``--control-seeds`` the same with the control in the program's place
(the upper end).  The control is the mix's ``control``: ``program``
runs the program's own bfloat16 path on the inputs rounded to bfloat16,
``reference`` the reference computed in bfloat16.  All seeds in one
process, the kernels built and warmed once.  One JSON line a seed, then
the largest program reading and the smallest control reading of each
number.
"""

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[0] = str(CHECKOUT)


def readings(cell, seeds, seconds, control=False):
    """[(seed, {call: reading})]."""
    import torch

    low = torch.bfloat16
    out = []
    for seed in seeds:
        inp = cell.make_inputs(seed)
        if control and cell.mix["control"] == "program":
            low_inp = cell.make_inputs(seed, dtype=low)
            cell.warm_up(low_inp)
            samples = cell.loop(low_inp, seconds=seconds, seed=seed)
            worst = cell.compare(inp, samples)
        else:
            cell.warm_up(inp)
            samples = cell.loop(inp, seconds=seconds, seed=seed)
            outputs = (cell.control_outputs(inp, samples, low) if control
                       else None)
            worst = cell.compare(inp, samples, outputs=outputs)
        out.append((seed, worst))
        print(json.dumps({"seed": seed, "control": control,
                          "readings": worst}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    from portbench import harness

    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = harness.Cell(args.workload, spec)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    program = readings(cell, seeds, args.seconds)
    control = readings(cell, controls, args.seconds, control=True)
    summary = {}
    for name, limit in cell.limits().items():
        summary[name] = {
            "lower": max(r[name] for _, r in program),
            "upper": min((r[name] for _, r in control), default=None),
            "limit": limit}
    print(json.dumps({"workload": args.workload, "summary": summary}))


if __name__ == "__main__":
    main()
