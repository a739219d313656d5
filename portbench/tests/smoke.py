"""Smoke-size cells for the CPU tests: each configuration's smoke widths
(the ``smoke`` of its file) and each mix cut to two slots an engine and
short requests."""

import dataclasses
import json
import time
from pathlib import Path

import torch

from portbench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in BENCH["workloads"])

#: Each configuration's smoke widths, by name, from its file.
SMOKE = {c["name"]: json.loads((ROOT / c["file"]).read_text())["smoke"] for c in BENCH["configs"]}


def smoke_cell(name: str, root: Path = ROOT) -> harness.Cell:
    cell = harness.load_cell(root, name)
    mix = cell.mix
    mix = dataclasses.replace(
        mix, engines=[dataclasses.replace(e, slots=2, clients=2) for e in mix.engines],
        prompt=traffic.LengthDist(mix.prompt.dist, 8, 40),
        output=traffic.LengthDist("uniform", 2, 6), max_len=64, deck=8)
    return dataclasses.replace(cell, model=cell.smoke, mix=mix)


def rehearse(cell: harness.Cell, seed: int = 2**31 + 11, seconds: float = 1.0, **kw):
    return harness.run_cell(cell, seed, seconds, False, device=torch.device("cpu"),
                            t_start=time.perf_counter(), **kw)
