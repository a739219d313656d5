"""The readings the output check's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Runs the cell once per seed in one process (the set-up of each seed anew,
the window ``--seconds`` long) and computes, beside each compared number,
the control: the reference in float8 put in the program's place, the gap of
its first choices under the float32 reference at each position of the same
prompts and served tokens.  Prints one JSON line per seed.  The benchmark's
own runs never run the control; the limits in ``limits/<cell>.json`` are set
from these readings (above the program's largest, below the control's
smallest).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, device=torch.device("cuda", 0),
                               t_start=t0, control=True)
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "checks": {k: v["value"] for k, v in res["checks"].items()},
                "info": res["info"], "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "device": res["device"],
                "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
