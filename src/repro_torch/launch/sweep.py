"""Scenario entry point: run one scenario of the port's registry and print
its rows (counterpart of ``benchmarks/run.py --scenario X --lane batched``).

  PYTHONPATH=src python -m repro_torch.launch.sweep --list
  PYTHONPATH=src python -m repro_torch.launch.sweep corun_sweep_1k
  PYTHONPATH=src python -m repro_torch.launch.sweep fig9_service --set tier=cxl --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep fig11_llm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep migrate_interference --trace trace.json
  PYTHONPATH=src python -m repro_torch.launch.sweep fig2_tiering --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep corun_sweep --lane scalar --processes 4

Grid scenarios run on the batched lane (``--lane scalar``: one event-driven
DES per job on the host, over ``--processes`` workers), ``fig2_tiering`` on
the scalar DES, ``fig11_llm`` on the serving engines (its tokens/s are the
simulated queue clock's).  Runs on the card unless ``--device cpu``.  Prints one CSV row per row of the scenario;
``--trace PATH`` (grid scenarios) also writes every job's per-window
telemetry records to PATH as JSON.
"""

from __future__ import annotations

import argparse
import csv
import enum
import json
import sys
import time

from repro_torch.scenarios import SCENARIOS, parse_set_args, run_scenario


def _text(v) -> str:
    """An axis default as ``--set`` text (enums by value, lists joined)."""
    if isinstance(v, enum.Enum):
        return str(v.value)
    if isinstance(v, (tuple, list)):
        return ",".join(_text(x) for x in v)
    return str(v)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", nargs="?", choices=list(SCENARIOS))
    ap.add_argument("--list", action="store_true",
                    help="print each scenario's name, title and axes, then exit")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="AXIS=VALUE", help="override an axis (comma lists are grids)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write each job's per-window records to PATH as JSON")
    ap.add_argument("--lane", choices=("batched", "scalar"), default="batched",
                    help="the grid scenarios' lane (default batched)")
    ap.add_argument("--processes", type=int, default=None,
                    help="worker processes of the scalar lane (default serial)")
    args = ap.parse_args(argv)
    if args.list:
        for sc in SCENARIOS.values():
            axes = " ".join(f"{a.name}={_text(a.default)}" for a in sc.axes)
            print(f"{sc.name}: {sc.title} [{axes}]")
        return
    if args.scenario is None:
        ap.error("a scenario name (or --list) is required")
    overrides = parse_set_args(args.scenario, args.sets)
    t0 = time.perf_counter()
    kw = dict(device=args.device, lane=args.lane, processes=args.processes)
    if args.trace:
        rows, traces = run_scenario(args.scenario, overrides, trace=True, **kw)
    else:
        rows = run_scenario(args.scenario, overrides, **kw)
    wall = time.perf_counter() - t0
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(traces, f)
    fields = list(dict.fromkeys(k for r in rows for k in r))
    writer = csv.DictWriter(sys.stdout, fieldnames=fields, restval="", lineterminator="\n")
    writer.writeheader()
    writer.writerows(rows)
    print(f"# {args.scenario}: {len(rows)} rows in {wall:.3f} s wall", file=sys.stderr)


if __name__ == "__main__":
    main()
