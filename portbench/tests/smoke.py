"""Smoke-size cells for the CPU tests: each configuration's port smoke
widths and each mix cut to two slots an engine and short requests."""

import dataclasses
import time
from pathlib import Path

import torch

from portbench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("hymba-tiered-chat", "mamba2-tiered-chat")

SMOKE = {
    "hymba-1.5b": dict(name="hymba-smoke", n_layers=4, d_model=128, n_q_heads=5, n_kv_heads=1,
                       head_dim=32, d_ff=256, vocab=512, block="hybrid", window_pattern="hymba",
                       sliding_window=16, rope_theta=10000.0, ssm_state=16, ssm_head_dim=32,
                       ssm_groups=1, ssm_expand=2, ssm_chunk=16, tied_embeddings=True,
                       dtype="bfloat16"),
    "mamba2-2.7b": dict(name="mamba2-smoke", n_layers=2, d_model=128, n_q_heads=0,
                        n_kv_heads=0, head_dim=0, d_ff=0, vocab=512, block="ssm",
                        rope_theta=None, ssm_state=16, ssm_head_dim=32, ssm_groups=1,
                        ssm_expand=2, ssm_chunk=16, tied_embeddings=True, dtype="bfloat16"),
}


def smoke_cell(name: str, root: Path = ROOT) -> harness.Cell:
    cell = harness.load_cell(root, name)
    mix = cell.mix
    mix = dataclasses.replace(
        mix, engines=[dataclasses.replace(e, slots=2, clients=2) for e in mix.engines],
        prompt=traffic.LengthDist(mix.prompt.dist, 8, 40),
        output=traffic.LengthDist("uniform", 2, 6), max_len=64, deck=8)
    return dataclasses.replace(cell, model=SMOKE[cell.config_name], mix=mix)


def rehearse(cell: harness.Cell, seed: int = 2**31 + 11, seconds: float = 1.0, **kw):
    return harness.run_cell(cell, seed, seconds, False, device=torch.device("cpu"),
                            t_start=time.perf_counter(), **kw)
