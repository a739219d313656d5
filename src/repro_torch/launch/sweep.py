"""Sweep entry point: run a grid scenario on the batched lane and print its
rows (counterpart of ``benchmarks/run.py --scenario X --lane batched``).

  PYTHONPATH=src python -m repro_torch.launch.sweep corun_sweep_1k
  PYTHONPATH=src python -m repro_torch.launch.sweep corun_sweep --set threads=2 --device cpu

Runs on the card unless ``--device cpu``.  Prints one CSV row per cell.
"""

from __future__ import annotations

import argparse
import csv
import sys
import time

from repro_torch.scenarios import SCENARIOS, parse_set_args, run_scenario


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="AXIS=VALUE", help="override an axis (comma lists are grids)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    overrides = parse_set_args(args.scenario, args.sets)
    t0 = time.perf_counter()
    rows = run_scenario(args.scenario, overrides, device=args.device)
    wall = time.perf_counter() - t0
    writer = csv.DictWriter(sys.stdout, fieldnames=list(rows[0]), lineterminator="\n")
    writer.writeheader()
    writer.writerows(rows)
    print(f"# {args.scenario}: {len(rows)} cells in {wall:.3f} s wall", file=sys.stderr)


if __name__ == "__main__":
    main()
