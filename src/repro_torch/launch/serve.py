"""Serving entry point: tiered co-located instances with MIKU request control
(port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 --mode miku
  PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --device cpu

``--arch`` takes the port's registry: llama31-8b, mamba2-2.7b, gemma2-27b,
h2o-danube-1.8b, stablelm-12b, qwen2.5-3b, hymba-1.5b, internvl2-2b (text
prompts, as the reference's engine serves it), the MoE families dbrx-132b
and llama4-maverick-400b-a17b, the port's own nemotron3-nano-30b-a3b
(Mamba-2, dropless MoE and attention layers in one stack; at ``--full``
its 63 GB of weights and their host copy outgrow one card), and
whisper-large-v3, which the engine
refuses with ``ValueError``: its requests would need frames, as in the
reference.

Modes: ``opt`` (each instance alone), ``racing`` (no control), ``miku``
(dynamic control).  Runs on the card unless ``--device cpu``.  The tok/s
printed is the simulated queue clock's (the reference's tier constants),
not a measurement of the device.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.configs import get_arch
from repro_torch.core.controller import MikuConfig, MikuController
from repro_torch.core.littles_law import EstimatorConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import (
    EngineConfig,
    Request,
    ServingEngine,
    TieredServingCluster,
    param_bytes,
)


def build_cluster(arch_id: str = "llama31-8b", *, full: bool = False,
                  n_requests: int = 24, mode: str = "miku", max_new: int = 24,
                  stream_chunks: int = 64, seed: int = 0, device=None,
                  params=None, trace: int = 0) -> TieredServingCluster:
    """A device-placed and a host-placed engine sharing random weights drawn
    from ``seed``, or the given ``params`` (of this config, on the device);
    ``trace=N`` samples every Nth transfer chunk's spans."""
    dev = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.config if full else spec.smoke
    if params is None:
        params = TransformerLM(cfg).init(torch.Generator(device=dev).manual_seed(seed), dev)

    def mk(name, placement, n):
        e = ServingEngine(
            EngineConfig(name=name, model=cfg, max_slots=4, max_len=96,
                         placement=placement, stream_chunks=stream_chunks),
            params,
        )
        for i in range(n):
            e.submit(Request(rid=i, prompt=list(range(1, 9)), max_new_tokens=max_new))
        return e

    controller = None
    if mode == "miku":
        chunk_service = param_bytes(params) / stream_chunks / 16.0  # host link B/ns
        controller = MikuController(
            MikuConfig(levels=(1, 2, 4, 8)),
            EstimatorConfig(t_fast=1.2e3, slow_read_threshold=8 * chunk_service,
                            min_window_inserts=4, min_slow_inserts=1),
        )
    engines = [mk("hbm", "device", n_requests),
               mk("host", "host", max(n_requests // 3, 1))]
    return TieredServingCluster(engines, controller=controller, window_ns=3e4, trace=trace)


def main(argv=None) -> Dict[str, Dict[str, float]]:
    """Run the CLI; returns the cluster's result dict (under ``opt``, each
    instance's run alone)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama31-8b",
                    help="a port registry id: llama31-8b, mamba2-2.7b, gemma2-27b, "
                         "h2o-danube-1.8b, stablelm-12b, qwen2.5-3b, hymba-1.5b, "
                         "internvl2-2b, dbrx-132b, llama4-maverick-400b-a17b, "
                         "nemotron3-nano-30b-a3b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the smoke config")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--mode", choices=("opt", "racing", "miku"), default="miku")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--max-ticks", type=int, default=10_000)
    args = ap.parse_args(argv)
    kw = dict(full=args.full, n_requests=args.requests, device=args.device)
    res: Dict[str, Dict[str, float]] = {}
    if args.mode == "opt":
        for placement in ("device", "host"):
            cl = build_cluster(args.arch, mode="racing", **kw)
            cl.engines = [e for e in cl.engines if e.cfg.placement == placement]
            res.update(cl.run(args.max_ticks))
    else:
        res = build_cluster(args.arch, mode=args.mode, **kw).run(args.max_ticks)
    for k, v in res.items():
        print(f"[serve/{args.mode}] {k}: {v['tokens_per_s']:.0f} simulated tok/s "
              f"({v['requests']:.0f} requests)")
    return res


if __name__ == "__main__":
    main()
