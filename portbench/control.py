"""Readings for the limits of ``correct``: the program's numbers over many
seeds, and the control's, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \
        --seconds <s> [--control 3]

Each seed is one run of the cell (set-up, a window of ``--seconds``,
the check); on the first ``--control`` seeds the check also computes
the control: the plain reference in the program's place on the card in
TF32, the nearest precision below the configuration's float32 with TF32
off, from the same inputs and states.  Prints one JSON line per seed,
then, per number, the largest program reading and the smallest control
reading.  The benchmark's own runs never run the control.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    from portbench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    prog, ctl = {}, {}
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        code, res = harness.execute(
            ["--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", "0"], t0,
            control=i < args.control)
        if res is None:
            print(json.dumps({"seed": seed, "exit": code}))
            return code or 1
        line = {"seed": seed, "correct": res["correct"],
                "frames": res["attempted"],
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "info": res["info"],
                "control": res.get("control"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            prog[k] = max(prog.get(k, 0.0), v)
        for k, v in (line["control"] or {}).items():
            ctl[k] = min(ctl.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "program_max": prog, "control_min": ctl}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import portbench

    portbench.cache_env()
    sys.exit(main(sys.argv[1:]))
