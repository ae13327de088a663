"""Readings that set a cell's correctness limits (``limits/<cell>.json``),
on the card at the cell's own size:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control] [--faults] [--out <file.jsonl>]

For each seed: the program's first three steps against the reference
(``check.gaps``: the compared numbers and ``grad_gap``), with
``--control`` the control (the reference in float8, ``reference/step.py``)
against it, and with ``--faults`` the program with each fault of
``faults.py`` the cell can have. One JSON line per seed. No window is run: the numbers come from
set-up.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed, device, control, faults):
    from benchmark import check, harness
    from benchmark import faults as fault_lib

    out = {"seed": seed}
    programs = {"program": None}
    if faults:
        programs.update({f: fault_lib.FAULTS[f]
                         for f in fault_lib.applicable(cell)})
    numbers = {}
    with harness.workdir() as wd:
        session = None
        for name, fault in programs.items():
            t0 = time.perf_counter()
            if fault is None:
                session = harness.Session(cell, seed, device, wd + "/p")
            else:
                with fault():
                    s = harness.Session(cell, seed, device, wd + f"/{name}")
                    numbers[name] = s.numbers
                    s.free()
                out[f"{name}_setup_s"] = time.perf_counter() - t0
                continue
            numbers[name] = session.numbers
            out["setup_s"] = time.perf_counter() - t0
        session.free()
        cfg = harness.resolved(session.pipe_cfg)
        t0 = time.perf_counter()
        ref = check.reference_numbers(session, cfg)
        out["reference_s"] = time.perf_counter() - t0
        if control:
            t0 = time.perf_counter()
            numbers["control"] = check.reference_numbers(session, cfg, "fp8")
            out["control_s"] = time.perf_counter() - t0
    out["gaps"] = {k: check.gaps(v, ref) for k, v in numbers.items()}
    out["numbers"] = {k: check.printable(v)
                      for k, v in dict(numbers, reference=ref).items()}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = json.dumps(readings(cell, seed, "cuda", args.control,
                                   args.faults))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
