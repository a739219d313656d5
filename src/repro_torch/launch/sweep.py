"""Scenario entry point: run one scenario of the port's registry and print
its result table (counterpart of ``benchmarks/run.py --scenario X --lane batched``).

  PYTHONPATH=src python -m repro_torch.launch.sweep --list
  PYTHONPATH=src python -m repro_torch.launch.sweep corun_sweep_1k
  PYTHONPATH=src python -m repro_torch.launch.sweep fig9_service --set tier=cxl --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep fig11_llm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep migrate_interference --trace trace.json
  PYTHONPATH=src python -m repro_torch.launch.sweep fig2_tiering --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep corun_sweep --lane scalar --processes 4
  PYTHONPATH=src python -m repro_torch.launch.sweep fabric_miku --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep slo_knee --device cpu --lane scalar
  PYTHONPATH=src python -m repro_torch.launch.sweep fabric_spine_congestion --device cpu --sanitize --perfetto spine
  PYTHONPATH=src python -m repro_torch.launch.sweep fig3_bandwidth --device cpu --format json --profile
  PYTHONPATH=src python -m repro_torch.launch.sweep --list --format md > docs/torch_scenarios.md

Grid scenarios run on the batched lane (``--lane scalar``: one event-driven
DES per job on the host, over ``--processes`` workers), ``fig2_tiering`` on
the scalar DES, ``fig11_llm`` on the serving engines (its tokens/s are the
simulated queue clock's). The fabric scenarios' and the open-loop ones'
(``slo_knee``, ``flash_crowd``) jobs fall back to the scalar DES on either
lane. Runs on the card unless ``--device cpu``. Prints the scenario's
``ResultTable``: one CSV row per row (``--format csv``, the default) or the
JSON document of scenario, params, rows and meta (``--format json``);
``--profile`` also writes the wall-clock phase profile and the metrics
snapshot to stderr. ``--list --format md`` prints the markdown catalog
(``docs/torch_scenarios.md``). ``--trace PATH`` (grid scenarios) also
writes every job's per-window telemetry records to PATH as JSON;
``--perfetto NAME`` (grid scenarios) traces every 16th ToR admission of
every job on the scalar DES and writes the spans to NAME.perfetto.json as
Chrome trace events (Perfetto, chrome://tracing). ``--sanitize`` checks the
runtime sanitizer's invariants in every simulation, worker processes
included, and a violation fails the run. An unknown scenario exits with
code 2 and names the near misses.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.scenarios import SCENARIOS, UnknownScenarioError, get, parse_set_args, run_scenario
from repro_torch.scenarios.spec import format_default


def write_perfetto(request_traces, name: str) -> str:
    """Flatten the per-cell span payloads into ``NAME.perfetto.json`` (one
    trace process per cell, job and workload); returns the path, or ""
    when no sampled request retired."""
    from repro_torch.obs.trace import to_chrome

    records = [
        {**rec, "workload": f"cell{ci}/job{job['job']}/{rec['workload']}"}
        for ci, cell in enumerate(request_traces)
        for job in cell["jobs"] if job["trace"]
        for rec in job["trace"]["requests"]
    ]
    if not records:
        return ""
    path = f"{name}.perfetto.json"
    with open(path, "w") as f:
        json.dump(to_chrome(records), f, indent=1)
        f.write("\n")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", nargs="?", help="a registered scenario (see --list)")
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
    ap.add_argument("--perfetto", metavar="NAME", default=None,
                    help="trace every 16th admission of every job (scalar DES) and write "
                         "NAME.perfetto.json as Chrome trace events")
    ap.add_argument("--format", choices=("csv", "json", "md"), default="csv",
                    help="the result table as csv (default) or json; md only with "
                         "--list, the generated markdown catalog")
    ap.add_argument("--profile", action="store_true",
                    help="write the wall-clock phase profile (plan, sweep, reduce and "
                         "each scalar job's) and the metrics snapshot to stderr")
    ap.add_argument("--sanitize", action="store_true",
                    help="check the runtime sanitizer's invariants in every simulation "
                         "(REPRO_SANITIZE=1; its jobs run on the scalar DES)")
    args = ap.parse_args(argv)
    if args.sanitize:
        # The environment switch, so worker processes inherit it.
        os.environ["REPRO_SANITIZE"] = "1"
    if args.list:
        if args.format == "json":
            ap.error("--list supports --format md (markdown catalog) or the default "
                     "text listing")
        if args.format == "md":
            from repro_torch.scenarios.catalog import catalog_md

            print(catalog_md(), end="")
            return
        for sc in SCENARIOS.values():
            figure = f" [{sc.figure}]" if sc.figure else ""
            slow = " (slow)" if sc.slow else ""
            print(f"{sc.name}{figure}{slow} — {sc.title}")
            if sc.axes:
                print("    axes: " + ", ".join(
                    f"{a.name}{'*' if a.is_grid else ''}={format_default(a.default)}"
                    for a in sc.axes))
            if sc.metrics:
                print(f"    metrics: {', '.join(m.name for m in sc.metrics)}")
        return
    if args.format == "md":
        ap.error("--format md is only valid with --list")
    if args.scenario is None:
        ap.error("a scenario name (or --list) is required")
    try:
        get(args.scenario)
    except UnknownScenarioError as ex:
        print(f"error: {ex}", file=sys.stderr)
        sys.exit(2)
    overrides = parse_set_args(args.scenario, args.sets)
    t0 = time.perf_counter()
    table = run_scenario(args.scenario, overrides, device=args.device, lane=args.lane,
                         processes=args.processes, trace=bool(args.trace),
                         perfetto=bool(args.perfetto), profile=args.profile)
    wall = time.perf_counter() - t0
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(table.traces, f)
    if args.perfetto:
        path = write_perfetto(table.request_traces, args.perfetto)
        print(f"# wrote {path}" if path else
              f"# no sampled request retired; {args.perfetto}.perfetto.json not written",
              file=sys.stderr)
    if args.profile:
        print(f"profile: {json.dumps(table.meta.get('profile', {}))}", file=sys.stderr)
        print(f"metrics: {json.dumps(table.meta.get('metrics', {}))}", file=sys.stderr)
    if args.format == "json":
        print(table.to_json())
    else:
        sys.stdout.write(table.to_csv())
    print(f"# {args.scenario}: {len(table.rows)} rows in {wall:.3f} s wall", file=sys.stderr)


if __name__ == "__main__":
    main()
