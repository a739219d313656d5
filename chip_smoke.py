"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. environment: card, power limit, torch/CUDA versions, kernel build time,
     and the registers and spills of each K1 instance <f32|bf16, Dh>;
  2. kernel sweep: the flash-decode kernel against its plain PyTorch version
     (tests/test_kernels.py's cases and tolerances, the serve shape, a long
     cache, and in bf16 and f32 a ragged long cache, one long row and a row
     with nothing valid), each with kernel, plain and library times, the
     bound (CUDA events; the serve shape's K/V stay in L2 between launches,
     the long caches' 134 MB-1.07 GB cannot), the kernel's split plan
     (n_split, blocks), the device kernels a call enqueues (read from a
     CUDA graph of one call) and their profiled time; cases at head_dim 32
     (the smoke configs') at the smoke serve shape in f32 and bf16 and a
     long cache; cases at head_dim 80 (h2o-danube: a 5,248-position cache,
     window 4096) and 160 (stablelm: the serve shape), each also with a
     window off a tile boundary, a softcap and both, and gemma2-27b's decode
     shape on its local (window 4096, softcap 50) and global (softcap 50)
     layers, whisper-large-v3's cross-attention (G = 1, 1,500 memory rows),
     hymba-1.5b's decode shape (G = 5, window 1024 and full), and the MoE
     families' decode shape at Dh 128 over 2 slots of 4,224 (dbrx-132b,
     G = 6; llama4-maverick, G = 5), all in f32 and bf16;
  3. small-input check: a two-layer model (head_dim 64, f32) served on the
     card and on the CPU (the plain path the CPU tests hold against the JAX
     reference) must give the same greedy tokens and the same result dict;
  4. decode-step check: llama31-8b at full width, random weights from a
     seeded generator, one prefill and decode steps through the kernel and
     through the plain attention, logits compared;
  5. serve: build_cluster(full=True, mode="miku") — a device engine and a
     host engine streaming its weights from pinned host memory — with the
     kernel's launch count read around the run;
  6. k2_check: the global-lambda bisection kernel against its float64 plain
     version on the card (the reference's test inputs and a seeded sweep of
     shapes), timed at the corun_sweep_1k shape;
  7. k3_check: the fused window solver against its float64 plain version on
     corun_sweep_1k's first window and on seeded random windows, timed at
     the corun_sweep_1k shape (k3_timing: call and kernel-alone time, warps
     per cell, dependent rounds per bisection);
  8. k4_sweep: the SSD chunked-scan kernels against their chunked plain
     version and the token recurrence, y and final state, and against the
     staged plain version with the kernels' roundings, on
     tests/test_kernels.py's cases, chunk invariance, and the mamba2 shapes
     (S = 2048, a ragged S = 200, the serve prompt, S = 8192, B = 4 at
     S = 2048), hymba's (N = 16: the serve prompt and S = 2048 at H = 50,
     P = 64; its smoke config's P = 32, chunk 16), each with call,
     kernel-alone (profiled), plain and bound
     times, heads per block, chunks and the device kernels a call enqueues
     (read from a CUDA graph of one call);
  9. sweep: run_scenario("corun_sweep_1k") and run_scenario("corun_sweep")
     through K3 on the card, with the launch counts read around each run,
     the first held against the plain lane on the card by the reference's
     kilo-grid gates (benchmarks/bench_des.py), and a torch.profiler run of
     it for the device busy share;
 10. ssm_check: mamba2-2.7b at full width (64 layers), random weights from a
     seeded generator, one 300-token prefill and 3 decode steps through the
     kernel and through the plain ssd_chunked, logits compared (f32 gated,
     bf16 printed), and in f32 a 2048-token prefill (16 chunks) at the same
     bounds; prefill_long: the bf16 model prefills one 2048-token
     prompt through K4 (wall, K4's profiled device time and share) and
     through the plain scan (wall, logits difference printed);
 11. serve_mamba2: build_cluster("mamba2-2.7b", full=True, mode="miku") with
     the launch counts of K4 and K1 read around the run, and a torch.profiler
     run of 3 batch-4 decode steps;
 12. serve_smoke: ``python -m repro_torch.launch.serve`` with its defaults
     (the llama31 smoke config, head_dim 32, MIKU), run in this process,
     with K1's launches read around it (2 layers x the engines' decode
     steps);
 13. fig11: run_scenario("fig11_llm") at the reference's defaults on the
     card, its rows held equal to the same call's rows on the CPU, K1's
     launches read around it (n_layers x the four clusters' decode steps),
     and its wall time;
 14. figures: the nine grid scenarios (fig3-fig10, loaded_latency) on the
     card, each job held against the plain lane on the card (exact cells
     equal; fluid cells by the sweep phase's gates), with each scenario's
     wall, K3 launches, K3 instances and device busy share, and fig10's
     racing_ddr and miku_ddr;
 15. mva: core.mva.analyze on the card against the CPU on tests/test_mva.py's
     inputs, rel 1e-5;
 16. figures3: fig13, fig14 and the three-tier studies (corun3_switch,
     corun3_pertier with the per-tier and merged laws, numa_remote) on the
     card, held against the plain lane as in 14, with the merged law's
     broadcast (equal mean caps of both slow tiers) and K3's <8, 8> instance
     gated;
 17. k3_instance_timing: K3's <8, 8> instance at the largest group of 16
     (its first window) and at a kilo-cell three-tier grid (C = 1024, W = 3,
     S = 4), against its plain version, with call, kernel-alone, plain and
     bound times and the instance's registers and spills from ptxas;
 18. tiering: migrate_interference and tiering_policies (vector tiering:
     MIGRATE pseudo-workloads, routing and issue gating rewritten every
     window) on the card, held against the plain lane as in 14, each
     tiering job's pages promoted and demoted, deferrals, migrated bytes
     and fast fraction beside the plain lane's, the reference's cross-lane
     bounds on them, the naive/MIKU headline on the card's rows, and the
     tiering pass's host ms, host copies and uploads per window;
 19. trace: run_scenario(trace=True) on the card: migrate_interference at
     60 us (tiering blocks in every record of a tiering job, the schema of
     the plain lane's traces, JSON) and corun3_pertier under the merged law
     (a decision block for both slow tiers);
 20. serve_kv: serve_smoke's cluster with the host engine's KV stream split
     by a KV PageMap, K1's launches read around it, its simulated tokens/s
     and fast/slow KV bytes equal to the same run on the CPU;
 21. families_check: gemma2-27b (cut to 8 layers), h2o-danube-1.8b,
     stablelm-12b (cut to 8 layers), qwen2.5-3b, hymba-1.5b, internvl2-2b
     and whisper-large-v3 at full width in f32: a long slot (5,120 tokens
     for gemma2 and danube: past the 4,096 window, in query blocks; 2,048
     for hymba; 300 for the others, internvl2's with 256 patch embeddings;
     8 for whisper, against 1,500 frames) and an 8-token slot, the long
     prefill's logits against the one-shot attention (2e-3) and, for
     hymba, against K4's plain version, then 3 decode steps through K1
     (twice a layer for whisper) against the plain attention (3e-3), the
     SSM state and the cross K/V in the slots; the same weights in bf16
     printed, not gated, with a 16-token greedy decode of whisper;
 22. serve_gemma2, the gemma2 serve path: gemma2-27b at its published
     widths and depth in bf16, one device engine (2 slots of 5,248) serving
     a 5,120-token and an 8-token prompt, 16 new tokens each; K1 launches
     must be 46 x decode steps, every token in vocab, every logit finite;
     the prefill and decode walls, measured tokens/s, peak device memory
     and a padded profile of one decode step;
 23. serve_families: ``python -m repro_torch.launch.serve --arch A`` at its
     defaults for gemma2, h2o-danube, stablelm, qwen2.5, hymba, internvl2,
     dbrx and llama4-maverick (smoke configs, past their windows of 16;
     llama4's capacity of 1 an expert drops requests at decode), K1
     launches = layers x decode steps, K4 = layers x prefills for hymba,
     the result dict equal to the CPU's; then gemma2's, hymba's, dbrx's and
     llama4's smoke configs in f32 through phase 3's check (greedy streams
     equal);
 24. serve_hymba, the hymba serve path: hymba-1.5b at its published widths
     and depth in bf16, first build_cluster(full=True, mode="miku") with its
     device and host engines, then one device engine (2 slots of 2,112)
     serving a 2,048-token and an 8-token prompt, 16 new tokens each; K1
     launches must be 32 x decode steps and K4 32 x prefills in each run,
     every token in vocab, every logit finite; the prefill and decode walls,
     measured tokens/s, peak device memory and a padded profile of one
     decode step beside its bound;
 25. moe_check: dbrx-132b (cut to 4 layers) and llama4-maverick (one
     dense/MoE pair) at full width in f32: a 2,048-token slot (2 query
     blocks, routed in one call) and an 8-token slot, the long prefill's
     logits against the one-shot attention (2e-3), 3 decode steps through
     K1 against the plain attention (3e-3), and the share of top-k
     routings both sides agree on; the first MoE layer's FFN on the long
     slot's 2,048 tokens (the card's own call in that prefill) against
     the same function on the CPU, expert by expert (1e-4, the same
     dropped requests); the f32 peak is reckoned first and must fit the
     card's free memory; the same weights drawn again in bf16 are printed,
     not gated;
 26. serve_moe, the MoE serve path: dbrx-132b (8 layers) and
     llama4-maverick (one pair) at their published widths in bf16, one
     device engine each (2 slots of 4,224) serving a 4,096-token and an
     8-token prompt, 16 new tokens each; K1 launches must be layers x
     decode steps, every token in vocab, every logit finite; the prefill
     and decode walls, measured tokens/s, peak device memory and a padded
     profile of one decode step with the expert products' device time,
     beside the bound of every weight read once (bar the untied input
     embedding's rows that no slot looks up) and the bound of only the
     routed experts read;
 27. train_qwen, the training path: qwen2.5-3b at its published widths and
     depth through ``Trainer`` at its defaults (global batch 8, seq 128,
     bf16 with an f32 master copy, AdamW, warmup_cosine, remat "none"), 6
     steps with total_steps 6, after its reckoned peak is held against the
     card's free memory: every loss finite, the last below the first, the
     peak within the reckoned one; step walls, tokens/s, the bound a step,
     one padded, profiled step (kernels, busy share, GEMM time, the
     forward's, clip's and AdamW's spans) and the step's three parts timed
     apart;
 28. train_ssm: mamba2-2.7b at its published widths cut to 8 layers, f32:
     the gradients through K4's autograd Function against the same
     gradients with ssd_chunked called directly on the card (every leaf
     within 1e-3 of its scale), then 2 train steps of 2 microbatches with
     K4's launches counted (8 x 2 x 2);
 29. train_resume: in a subprocess with deterministic algorithms, qwen2.5-3b's
     widths cut to 2 layers in bf16, 2 steps straight against 1 step, a
     checkpoint, a resume and 1 step, every leaf of params, m, v and the
     master copy within 1e-6; the bytes written, save and restore walls;
 30. train_remat: qwen2.5-3b's widths cut to 4 layers in f32 at seq 2048
     (two query blocks): the gradients with remat "full" and "dots"
     against "none" within 1e-5, each mode's peak and wall;
 31. dist_serve, the distribution path: llama31-8b at full width and depth
     in bf16 with every parameter and cache leaf a DTensor on a 1 x 1 mesh
     (``make_host_mesh``: NCCL from a FileStore) under DECODE_RULES, on the
     unmeshed tensors' storage: prompts of 1,024 and 8 tokens prefilled,
     then 8 greedy decode steps, against the same steps without a mesh:
     tokens equal, logits within 1e-6 of their scale, K1 = 32 x 8 = 256;
     each side's prefill and decode-step walls;
 32. dist_train: qwen2.5-3b whole through ``Trainer(mesh=...)`` on that
     mesh for 3 steps: losses within 1e-3 (relative) of train_qwen's first
     3, the peak beside train_qwen's; then train_ssm's gradients with the
     parameters DTensors (within 1e-3 of the unmeshed ones' scale) and its
     train steps on the mesh, K4's launches counted (8 x 2 x 2);
 33. dryrun: ``launch.dryrun.run_cell`` on the card's device type, fake
     tensors on the 256-rank production mesh (32 x 8) of a fake process
     group: llama31-8b train_4k, prefill_32k and decode_32k, gemma2-27b
     long_500k, mamba2-2.7b prefill_32k and dbrx-132b train_4k (the train
     cells at 1 microbatch, the CLI's default being 8); every cell
     ok, the device's allocated bytes unchanged, each cell's parameter
     bytes a device equal to bytes_per_device of their placements; each
     cell's trace time, counts and H100 roofline terms, and the phase's
     wall;
 34. scalar_lane: the scalar DES (host Python) on the card's host:
     tests/data/seed_fig_goldens.json's fig3 load column and fig5 load
     through run_bw_test / run_corun (rel 0.01, ToR inserts equal),
     miku_trace_des.json's decisions from a live MIKU co-run (equal), and
     the wall and events per second of BENCH_des.json's fig5 load co-run
     beside the host's CPU;
 35. lanes_check: corun_sweep's 96 jobs on the batched lane on the card
     (K3 launches must be 60) and on the scalar DES over a pool of
     min(8, cores) spawn workers: worst bandwidth error below 15% and mean
     below 3%, and on the grid's five cells of tests/test_batched.py:172-206
     their own bounds (5% and 10% on bandwidth, 10% on the slow tier's
     service time, restricted windows at most 3 apart); both walls;
 36. lane_fallback: a mixed list on the card, a tiering job whose policy the
     vector twin cannot run and two MIKU co-runs: the fallback recorded
     with the policy's name, its result equal to the scalar lane's (every
     field), K3 launched for the co-runs (6), every job a result;
 37. fig2: run_scenario("fig2_tiering") (its cells on the scalar DES): each
     op's upper_ddr_only and lower_cxl_only equal to the fig3 goldens of
     that op, every column printed, and the wall;
 38. fabric: the routed fabric on the card's host: the live spine co-run
     under the per-edge law equal to tests/data/fabric_trace_goldens.json
     (decisions, window records, fabric summary, bandwidths); the three
     fabric scenarios through run_scenario(lane="batched") on the card,
     every job a "fabric_topology" fallback, rows equal to the scalar
     lane's, the acceptance (racing ddr_pct_of_alone < 10, peredge > 60,
     spine restricted windows, stalls; port_limited 1 below the crossover
     and 0 at 2048; peredge sparing host0's CXL better than pertier);
 39. fabric_direct: corun_sweep's 96 cells with A-direct in place of A,
     batched on the card (K3 launches must be 60), every numeric field
     equal to the A grid's; a per-edge co-run on A-direct falling back to
     the scalar DES and equal to the per-tier co-run on A;
 40. open_loop: slo_knee's golden cell equal to
     tests/data/slo_knee_trace_goldens.json, slo_knee's 20 rows and
     flash_crowd's rows with their acceptance, and a mixed list of an
     arrival job beside two MIKU co-runs batched on the card (K3 launches
     must be 6), the fallback named "arrival" and equal to the scalar run;
 41. sanitize_des: the runtime sanitizer on the card's host: the scalar
     lane's 18 parity jobs sanitized and not, every stat, ToR insert and
     decision equal, no violation, the windows each checked; the goldens
     of 34, 38 and 40 under REPRO_SANITIZE=1; the reference's 500 us
     two-tier co-run plain and sanitized, the overhead ratio within the
     reference's bound (plain * 1.5 + 0.05 s);
 42. trace_des: the spine co-run traced at every 997th admission (64 at
     most), its Chrome export equal to tests/data/spine_perfetto_golden.json;
     a MIKU co-run traced at 16 with histograms, the profile and window
     records, equal to the plain run, its spans conserving;
 43. obs_fallback: two MIKU co-runs batched on the card beside a sanitized
     and a traced co-run, which fall back as "sanitize" and "trace", each
     equal to its scalar run; K3 launches those of the two co-runs alone (6);
 44. sweep_cli: ``python -m repro_torch.launch.sweep fabric_spine_congestion
     --sanitize --perfetto NAME`` in this process, its Chrome trace's schema,
     and an unknown name's exit code 2 with the near miss; then
     ``--format json`` (its rows the csv's), ``--profile`` (the phases on
     stderr), ``--list --format md`` (equal to ``catalog_md()``) and
     ``--format md`` without ``--list`` (exit 2);
 45. serve_traced: the serve phase's cluster again on its weights with
     ``trace=4`` under REPRO_SANITIZE=1: tokens, result dict and timeline
     equal to the serve run's, the transfer queue's sanitizer clean, the
     sampled chunks' spans conserving and counted, K1 = 32 x decode steps.
 46. result_table: run_scenario("corun_sweep_1k", profile=True) on the card
     returns a ResultTable: meta lane "batched", every job batched, 0
     fallbacks, K3 = 20, the profile's plan, sweep and reduce within the
     wall, the metrics' sweep.jobs up by the job count, to_csv and to_json
     holding the rows; a grid whose A-spine cells fall back reports the
     fallbacks partition_jobs counts, and again under REPRO_BATCH_BLOCK=1
     (a group a cell: K3 = the windows, more launches, the same rows and
     meta);
 47. runner_figs: every wrapper of memsim/runner.py on the card at the
     figures' horizons, K3 counted around each, its rows within the
     figures' p95 bound of the same cells of the plain lane's rows;
     miku_comparison(A, STORE).miku_ddr_frac_of_opt printed;
 48. tpu_platform: fig3_bandwidth and fig5_corun at platform=TPU (512 B
     bursts) batched on the card (K3 counted, its instances) against the
     scalar DES on the host by lanes_check's worst and mean bounds;
 49. replay: ReplaySubstrate over tests/data's four recorded traces through
     the port's ControlLoop reproduces every golden decision, and a live
     co-run's own deltas replay to its live decisions;
 50. tiers: put_on_tier to HOST_TIER pinned, to HBM_TIER on the card, the
     cold part of a llama31-8b KV cache round-tripped bit-equal, each
     copy's rate.
The figures' plain lane runs in CPU worker processes from the build on.
They run in this order: 1-5, 45, 21, 25, 22, 26, 24, 23, 12, 20, 13, 6, 7, 9, 14, 16, 18,
19, 34-44, 46-50, 17, 15, 8, 10, 11, 27-33.  Every line carries ``elapsed_s``, the seconds since the script started.
The line before the last lists every kernel's numbers; the last line is the
device summary.  Any failed check exits non-zero; without CUDA (or without
the rest of the repository beside this file) it exits non-zero at once.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
H100_F64_FLOPS = 34e12  # f64 outside the tensor cores
#: A profiler trace can lose its first kernel records, the more the older
#: the process, even after a pause before the first launch; never its
#: last.  So each trace opens on this many spin kernels of
#: PROFILE_PAD_CYCLES each (about 6.5 ms on an H100), whose lost records
#: are counted, and the work measured runs behind them.
PROFILE_PAD_KERNELS = 64
PROFILE_PAD_CYCLES = 200_000
#: Per trace, the padding records it lost; and (kernels, records seen,
#: calls) of each trace taken again because it did not hold every record
#: of the work measured.  Printed by the phase "profiler".
PROFILE_PADS_LOST: list = []
PROFILE_RETAKES: list = []

#: The reference's kilo-grid lane gates (benchmarks/bench_des.py:152-153):
#: at most this many cells may take different MIKU decisions than the plain
#: lane, and the decision-aligned cells' p95 bandwidth error stays below the
#: bound.
SWEEP1K_MAX_FLIPS = 12
SWEEP1K_P95_BOUND = 0.08
#: K3 on seeded random windows: the f32 relaxation of a discontinuous fixed
#: point (saturation at 98% utilisation, queue-forming flags) lands on the
#: other side of a threshold in a few cells, whatever the implementation:
#: the reference's own f32 solver (Pallas, interpreted) leaves 0-5.5% of the
#: cells of these windows beyond 2e-3 of the float64 loop
#: (tests/test_torch_batched.py holds it to this share).  So the random
#: windows require the same isfinite(lam) mask on every cell and at most
#: this share of cells beyond 2e-3; the real first window requires 2e-3 on
#: every cell.
K3_RANDOM_MAX_SHARE_BEYOND = 0.05
#: K1's device kernels: the split kernel and, when n_split > 1, the combine.
K1_KERNELS = ("decode_attention_kernel", "decode_combine_kernel")
#: A K1 sweep row's fields that the kernels line repeats.
K1_FIELDS = ("ms", "kernel_device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "max_abs_err", "n_split", "device_kernels_per_call")
#: The grid figures of the figures phase, the reference's declaration order.
FIGURES = ("fig3_bandwidth", "fig4_latency", "loaded_latency", "fig5_corun",
           "fig6_tor_correlation", "fig7_llc", "fig8_sync", "fig9_service", "fig10_miku")
#: The figures' plain lane (the float64 solver, on the CPU, where it runs 4x
#: faster than launching its small kernels on the card) runs in these
#: worker processes, started after the kernel build so that they overlap
#: the K1 sweep and the full-width decode check; fig10 (240 windows) alone.
PLAIN_LANE_WORKERS = (("fig10_miku",),
                      ("loaded_latency", "fig5_corun", "fig3_bandwidth", "fig4_latency"),
                      ("fig7_llc", "fig8_sync", "fig6_tor_correlation", "fig9_service"),
                      ("fig13_spark", "fig14_kv", "corun3_switch", "corun3_pertier",
                       "numa_remote"),
                      ("migrate_interference", "tiering_policies"))
#: The figures' decision-flip jobs against the plain lane: the kilo grid's
#: 12 in 1024 cells, scaled to the figures' 140 jobs and rounded down (63
#: of them run on the fluid engine, 6 of those with MIKU).
FIGURES_MAX_FLIPS = 1
#: The figures3 phase's scenarios: fig13, fig14 and the three-tier studies
#: (A-switch, A-numa; the merged law in corun3_pertier), the reference's
#: declaration order.
FIGURES3 = ("fig13_spark", "fig14_kv", "corun3_switch", "corun3_pertier", "numa_remote")
#: Their decision-flip jobs against the plain lane, over all five (52 jobs,
#: 24 on the fluid engine, 9 of them with MIKU).
FIGURES3_MAX_FLIPS = 1
#: The tiering phase's scenarios (the tiering subsystem on the batched
#: lane), the reference's declaration order, and their decision-flip jobs
#: against the plain lane over both (7 jobs, 3 with MIKU).
TIERING = ("migrate_interference", "tiering_policies")
TIERING_MAX_FLIPS = 1
#: The reference's cross-lane bounds on the tiering counters
#: (tests/test_batched_tiering.py:159-230), held between the card and the
#: plain lane: hotness_lru's fast fraction within this of the plain lane's
#: and above the floor, promotions and demotions at most the factor times
#: the plain lane's and above the minimum.
TIERING_FAST_FRACTION_TOL = 0.15
TIERING_FAST_FRACTION_FLOOR = 0.6
TIERING_COUNT_FACTOR = 2
TIERING_MIN_PROMOTIONS = 200
#: The per-window telemetry block of a tiering job's window record.
TIERING_RECORD_KEYS = ("promoted", "demoted", "enqueued", "deferred", "backlog_pages",
                       "migrated_bytes")
#: (C, W, S, padded workloads, padded stations) of the random K3 windows.
K3_RANDOM_CASES = ((1024, 2, 3, 0, 0), (256, 3, 4, 1, 0), (128, 8, 5, 2, 1),
                   (512, 5, 3, 0, 0))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0, **fields}),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def h100():
    """The package's hardware model of the card (``roofline.analysis``):
    the H100 SXM data sheet's rates."""
    from repro_torch.roofline.analysis import H100_SXM

    return H100_SXM


def attention_bound_ms(q, k, lengths, window=1 << 30):
    """Least time for one decode-attention call on these inputs: each input
    byte read once (only the K/V rows the mask keeps), the output written
    once, against the bf16/f32 operations they need (the package's K1 cost,
    ``roofline.op_costs.decode_attention_cost``); the larger of the two,
    and which one it is."""
    from repro_torch.roofline.op_costs import decode_attention_cost

    nbytes, flops = decode_attention_cost(tuple(q.shape), tuple(k.shape), k.element_size(),
                                          lengths.tolist(), window)
    hw = h100()
    peak = hw.peak_flops if q.dtype.itemsize == 2 else hw.peak_flops_f32
    t_bytes, t_ops = nbytes / hw.hbm_bw, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import _nvcc
        from repro_torch.kernels import decode_attention as k1
        from repro_torch.kernels import fluid_solver as fs
        from repro_torch.kernels import ops
        from repro_torch.kernels import ssd_scan as k4
        from repro_torch.kernels.ref import decode_attention_ref
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_cluster
    from repro_torch.models.transformer import ModelConfig, TransformerLM

    # Full-precision f32 products everywhere (the small check compares f32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # -- 1. environment and build --------------------------------------------
    t0 = time.perf_counter()
    libs = _nvcc.build(k1.SOURCE, fs.SOURCE, k4.SOURCE)  # one nvcc per source, together
    build_s = time.perf_counter() - t0
    plain_lane = start_plain_lane()
    ptxas = {lib.name: [line.split("ptxas info    : ")[-1] for line in
                        lib.with_suffix(".ptxas.txt").read_text().splitlines()
                        if "registers" in line or "spill" in line] for lib in libs}
    k1_instances = k1_ptxas(libs[0].with_suffix(".ptxas.txt"))
    emit("environment", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kernel_build_s=build_s, kernel_libraries=[lib.name for lib in libs],
         ptxas=ptxas, k1_instances=k1_instances)
    check(len(k1_instances) == 10, f"K1 instances in the ptxas report: {k1_instances}")

    # -- 2. kernel sweep -------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, hq, hkv, dh, s, dtype, lengths=None):
        q = torch.randn(b, hkv, hq // hkv, dh, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(dtype)
        if lengths is None:
            lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        return q, k, v, lengths

    cases = []  # name, (b, hq, hkv, dh, s), dtype, tol, kwargs, lengths
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for name, shape in (("mha", (1, 4, 4, 64, 128)), ("gqa4", (2, 8, 2, 64, 256)),
                            ("gqa8", (2, 16, 2, 128, 512)), ("g5", (1, 25, 5, 64, 128)),
                            ("mha20", (2, 20, 20, 64, 128))):
            cases.append((name, shape, dtype, tol, {}, None))
    for window, cap in ((64, None), (1 << 30, 50.0), (32, 30.0)):
        cases.append((f"window{window}_softcap{cap}", (2, 8, 4, 64, 256), torch.float32,
                      1e-5, dict(window=window, softcap=cap), [256, 256 // 3]))
    serve_lengths = torch.randint(8, 17, (4,), generator=gen, device=dev).tolist()
    cases.append(("serve", (4, 32, 8, 128, 96), torch.bfloat16, 2e-2, {}, serve_lengths))
    cases.append(("long_cache", (8, 32, 8, 128, 32768), torch.bfloat16, 2e-2, {},
                  [32768] * 8))
    # head_dim 32: the smoke configs' (fig11, serve's default), at the smoke
    # serve shape (4 slots, 4 q / 2 kv heads, max_len 96) and a long cache.
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append((f"dh32_serve_{tag}", (4, 4, 2, 32, 96), dtype, tol, {}, serve_lengths))
    cases.append(("dh32_long_cache", (8, 4, 2, 32, 32768), torch.bfloat16, 2e-2, {},
                  [32768] * 8))
    # head_dim 80 (h2o-danube) and 160 (stablelm) at full width: Dh 80 at a
    # 5k cache with danube's window of 4096, Dh 160 at the serve shape; each
    # with a window that starts off a tile boundary, a softcap, and both.
    # Then gemma2-27b's decode shape (32 q / 16 kv heads, a 5,120-token and
    # an 8-token slot, its query scale): local layers (window 4096, softcap
    # 50) and global layers (softcap 50).
    gemma2_scale = (4608 / 32) ** -0.5
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append((f"dh80_serve_{tag}", (4, 32, 8, 80, 5248), dtype, tol,
                      dict(window=4096), [5121, 9, 4097, 300]))
        cases.append((f"dh160_serve_{tag}", (4, 32, 8, 160, 96), dtype, tol, {},
                      serve_lengths))
        for dh in (80, 160):
            cases.append((f"dh{dh}_window_{tag}", (2, 8, 2, dh, 512), dtype, tol,
                          dict(window=100), [512, 300]))
            cases.append((f"dh{dh}_softcap_{tag}", (2, 8, 4, dh, 256), dtype, tol,
                          dict(softcap=30.0), [256, 85]))
            cases.append((f"dh{dh}_window_softcap_{tag}", (2, 8, 2, dh, 512), dtype, tol,
                          dict(window=64, softcap=50.0), [512, 77]))
        cases.append((f"gemma2_local_{tag}", (2, 32, 16, 128, 5248), dtype, tol,
                      dict(window=4096, softcap=50.0, scale=gemma2_scale), [5121, 9]))
        cases.append((f"gemma2_global_{tag}", (2, 32, 16, 128, 5248), dtype, tol,
                      dict(softcap=50.0, scale=gemma2_scale), [5121, 9]))
    # The last dense-path families at full width: whisper-large-v3's
    # cross-attention (MHA, G = 1, every one of the 1,500 memory rows valid:
    # off the tile and under MIN_SPLIT), and hymba-1.5b's decode shape (G = 5
    # over 2 slots of 2,112, the served lengths of its last step) on the
    # SWA-1024 layers and on its full layers.
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append((f"whisper_cross_{tag}", (2, 20, 20, 64, 1500), dtype, tol, {},
                      [1500, 1500]))
        cases.append((f"hymba_window_{tag}", (2, 25, 5, 64, 2112), dtype, tol,
                      dict(window=1024), [2063, 23]))
        cases.append((f"hymba_full_{tag}", (2, 25, 5, 64, 2112), dtype, tol, {}, [2063, 23]))
    # The MoE families' decode shape (2 slots of 4,224 positions, a 4,097-
    # and a 9-token row: serve_moe's first step), full attention at Dh 128:
    # dbrx-132b (48 q / 8 kv heads, G = 6) and llama4-maverick (40 q / 8 kv
    # heads, G = 5).
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append((f"dbrx_decode_{tag}", (2, 48, 8, 128, 4224), dtype, tol, {}, [4097, 9]))
        cases.append((f"llama4_decode_{tag}", (2, 40, 8, 128, 4224), dtype, tol, {},
                      [4097, 9]))
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        # Rows of very different lengths: most splits of the short rows are
        # empty; one long row alone; a row with nothing valid (a uniform
        # average over all S) beside a 3-token row.
        cases.append((f"long_ragged_{tag}", (4, 32, 8, 128, 32768), dtype, tol, {},
                      [1, 513, 4096, 32768]))
        cases.append((f"long_b1_{tag}", (1, 32, 8, 128, 32768), dtype, tol, {}, [32768]))
        cases.append((f"nothing_valid_{tag}", (2, 32, 8, 128, 4096), dtype, tol, {}, [0, 3]))

    sweep = {}
    for name, shape, dtype, tol, kw, lengths in cases:
        b, hq, hkv, dh, s = shape
        q, k, v, lens = inputs(b, hq, hkv, dh, s, dtype, lengths)
        out = k1.decode_attention_cuda(q, k, v, lens, **kw)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, lens, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        plan = k1.launch_plan(b, hkv, hq // hkv, s, dh, dtype, dev)
        row = dict(case=name, shape=dict(b=b, hq=hq, hkv=hkv, dh=dh, s=s),
                   dtype=str(dtype).split(".")[-1], tol=tol, max_abs_err=err, ok=ok,
                   n_split=plan["n_split"], blocks=plan["blocks"],
                   resident_blocks=plan["resident_blocks"])
        iters = 10 if s >= 32768 else 100
        row["ms"] = time_ms(lambda: k1.decode_attention_cuda(q, k, v, lens, **kw), iters)
        # Measured, not planned: the device kernels one call enqueues (the
        # split kernel, and the combine kernel when n_split > 1) and their time.
        launched = graph_kernels(lambda: k1.decode_attention_cuda(q, k, v, lens, **kw))
        row["device_kernels_per_call"] = len(launched)
        check(len(launched) == (1 if plan["n_split"] == 1 else 2)
              and all(any(n in kn for n in K1_KERNELS) for kn, _ in launched),
              f"decode attention {name}: kernels {launched} a call at n_split "
              f"{plan['n_split']}")
        row["kernel_device_ms"] = kernel_device_ms(
            lambda: k1.decode_attention_cuda(q, k, v, lens, **kw), K1_KERNELS, 10,
            kernels=len(launched))
        row["plain_ms"] = time_ms(lambda: decode_attention_ref(q, k, v, lens, **kw), iters)
        row["library_ms"] = None
        if kw.get("softcap") is None:
            # Yardstick only (the port never calls it): one PyTorch call for
            # the same function, GQA and the length/window mask included.
            # No single call applies a tanh softcap, so those cases have none.
            window = kw.get("window", 1 << 30)
            pos = torch.arange(s, device=dev)[None, :]
            n = lens[:, None]
            mask = ((pos < n) & (n - 1 - pos < window))[:, None, None, :]
            qs = q.reshape(b, hq, 1, dh)

            def library():
                return F.scaled_dot_product_attention(qs, k, v, attn_mask=mask,
                                                      scale=kw.get("scale"), enable_gqa=True)

            row["library_call"] = ("scaled_dot_product_attention(attn_mask=bool [B, 1, 1, S] "
                                   "length and window mask, enable_gqa=True)")
            row["library_ms"] = time_ms(library, iters)
            row["library_max_abs_err"] = (library().reshape(out.shape).float()
                                          - ref.float()).abs().max().item()
        row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, lens,
                                                              kw.get("window", 1 << 30))
        if name == "serve":
            # The model's entry (kernels.ops, model layout) through the torch
            # operator that the launcher sits behind: the host cost a call
            # adds on the decode path, beside ms above (the launcher alone).
            qm, km, vm = q.reshape(b, hq, dh), k.transpose(1, 2), v.transpose(1, 2)
            row["op_call_ms"] = time_ms(lambda: ops.decode_attention(qm, km, vm, lens, **kw),
                                        iters)
        sweep[name] = row
        emit("kernel_sweep", **row)
        check(ok, f"decode attention {name}: max abs err {err} > {tol}")
        del q, k, v, out, ref
    torch.cuda.empty_cache()

    # -- 3. small-input check: card vs the CPU plain path -----------------------
    small = ModelConfig(name="small-dh64", n_layers=2, d_model=256, n_q_heads=8,
                        n_kv_heads=2, head_dim=64, d_ff=512, vocab=512,
                        rope_theta=500_000.0, dtype=torch.float32)
    small_check(small, prompt=[5, 7, 11], max_new=6, max_len=32)

    # -- 4. decode-step check at full width -------------------------------------
    full = get_arch("llama31-8b").config
    # f32, gated: the kernel path and the plain attention differ only in
    # summation order, so the logits must meet the reference's own decode
    # bound (atol = rtol = 3e-3, tests/test_models.py).
    cfg32 = dataclasses.replace(full, dtype=torch.float32)
    model32 = TransformerLM(cfg32)
    params32 = model32.init(torch.Generator(device=dev).manual_seed(1), dev)
    f32 = decode_check(model32, params32, gen, dev, steps=3)
    emit("decode_check", dtype="float32", tol=3e-3, **f32)
    check(f32["allclose"], f"full-width f32 decode logits differ: {f32}")
    del params32
    torch.cuda.empty_cache()

    # -- 5. serve -----------------------------------------------------------------
    t0 = time.perf_counter()
    cluster = build_cluster("llama31-8b", full=True, n_requests=4, max_new=8,
                            mode="miku", seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    hbm, host = cluster.engines
    cfg = hbm.cfg.model
    emit("setup", config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_q_heads=cfg.n_q_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab, param_bytes=hbm.param_bytes, seconds=setup_s,
         device_memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    # The serving dtype (bf16), reported: each layer rounds its output to
    # bf16, so a summation-order difference flips bf16 ulps that travel
    # through 32 random-weight layers; the f32 check above is the gate.
    bf16 = decode_check(TransformerLM(cfg), hbm.params, gen, dev, steps=3)
    emit("decode_check", dtype="bfloat16", gated=False, **bf16)
    check(bf16["finite"], "non-finite bf16 logits")
    emit("decode_profile", **profile_decode(TransformerLM(cfg), hbm.params, dev))

    # The main path: launches counted from here.
    k1.LAUNCHES.reset()
    t0 = time.perf_counter()
    res = cluster.run(max_ticks=10**9)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = k1.LAUNCHES.count
    steps = hbm.decode_steps + host.decode_steps
    h2d_bytes = host.offloader.bytes_to_device
    h2d_s = host.offloader.copy_seconds()
    tel = cluster.control.telemetry()
    emit("serve", mode="miku", n_layers=cfg.n_layers,
         engines={e.cfg.name: dict(placement=e.cfg.placement, requests=res[e.cfg.name]
                                   ["requests"], tokens=res[e.cfg.name]["tokens"],
                                   decode_steps=e.decode_steps) for e in cluster.engines},
         simulated_tokens_per_s={k: v["tokens_per_s"] for k, v in res.items()},
         simulated_note="queue clock with the reference's tier constants, not measured",
         wall_s=wall_s, miku_windows=tel["windows"],
         miku_restricted_windows=tel["restricted_windows"],
         h2d_bytes=h2d_bytes, h2d_device_s=h2d_s, h2d_gb_per_s=h2d_bytes / h2d_s / 1e9,
         k1_launches=launches, layers_x_decode_steps=cfg.n_layers * steps,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(res["hbm"]["requests"] == 4 and res["host"]["requests"] >= 1,
          f"serve did not finish its requests: {res}")
    for e in cluster.engines:
        for r in e.done:
            check(len(r.output) == 8 and all(0 <= t < cfg.vocab for t in r.output),
                  f"bad output for request {r.rid} of {e.cfg.name}: {r.output}")
    check(launches == cfg.n_layers * steps and launches > 0,
          f"kernel launches {launches} != layers x decode steps {cfg.n_layers * steps}")

    # serve_traced runs the same cluster on these weights, traced and
    # sanitized; the serve engines go first, so the memory peak stays one
    # cluster's.
    params = hbm.params
    untraced = dict(res=res, wall_s=wall_s, timeline=cluster.timeline,
                    tokens={e.cfg.name: sorted((r.rid, list(r.output)) for r in e.done)
                            for e in cluster.engines})
    del cluster, hbm, host, e
    torch.cuda.empty_cache()
    traced_serve = serve_traced(dev, params, untraced, smi)
    del params, untraced  # free the llama weights before the next paths
    torch.cuda.empty_cache()

    families_check(dev)
    moe_check(dev)
    gemma2 = serve_gemma2(dev)
    torch.cuda.empty_cache()
    moe = serve_moe(dev)
    hymba = serve_hymba(dev)
    torch.cuda.empty_cache()
    families = serve_families(dev)
    serve_smoke(dev)
    kv = serve_kv(dev)
    fig11 = fig11_phase(dev)

    k2_row = k2_check(dev)
    k3_row = k3_check(dev)
    lane = sweep_phase(dev)
    plain, plain_wait_s = join_plain_lane(plain_lane)
    emit("plain_lane", workers=len(PLAIN_LANE_WORKERS), wait_s=plain_wait_s,
         scenarios=sorted(plain))
    figures = figures_phase(dev, plain)
    figures3 = figures3_phase(dev, plain)
    tiering = tiering_phase(dev, plain)
    traced = trace_phase(dev)
    scalar_lane_phase(smi)
    lanes = lanes_check(dev)
    fallback = lane_fallback(dev)
    fig2_phase(dev)
    fabric_phase(dev)
    direct = fabric_direct(dev)
    open_loop = open_loop_phase(dev)
    sanitize_des(smi)
    trace_des(smi)
    obs = obs_fallback(dev)
    sweep_cli(smi)
    table = result_table(dev)
    runner_k3 = runner_figs(dev, plain)
    tpu = tpu_platform(dev)
    replay_phase(smi)
    tiers_phase(dev)
    k3_88 = k3_instance_timing(dev, figures3.pop("firsts"),
                               next(lib for lib in libs if lib.name.startswith("fluid_solver"))
                               .with_suffix(".ptxas.txt"))
    mva_phase(dev)
    k4_row = k4_sweep(dev)
    k4_launches = ssm_phases(dev)
    k4_train_launches, qwen = train_phases(dev)
    k1_dist_launches, k4_dist_launches, _ = dist_phases(dev, qwen)
    emit("profiler", traces=len(PROFILE_PADS_LOST), pad_kernels=PROFILE_PAD_KERNELS,
         pad_records_lost_max=max(PROFILE_PADS_LOST),
         traces_losing_pad_records=sum(n > 0 for n in PROFILE_PADS_LOST),
         pad_records_lost=PROFILE_PADS_LOST, retaken_traces=len(PROFILE_RETAKES),
         retakes=PROFILE_RETAKES)

    row, long_row = sweep["serve"], sweep["long_cache"]
    print(json.dumps({"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:98",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        # launches counts wrapper calls; each ran this many device kernels
        # (captured in the kernel sweep), taking kernel_device_ms in all.
        "device_kernels_per_call": row["device_kernels_per_call"],
        "kernel_device_ms": row["kernel_device_ms"],
        # The same call through kernels.ops and the torch operator.
        "op_call_ms": row["op_call_ms"],
        "long_cache_ms": long_row["ms"],
        "long_cache_kernel_device_ms": long_row["kernel_device_ms"],
        "long_cache_library_ms": long_row["library_ms"],
        "long_cache_bound_ms": long_row["bound_ms"],
        "long_cache_plain_ms": long_row["plain_ms"],
        "long_cache_max_abs_err": long_row["max_abs_err"],
        "long_cache_device_kernels_per_call": long_row["device_kernels_per_call"],
        # head_dim 32 (the smoke configs'): its launches in fig11's run, and
        # its readings at the smoke serve shape and a long cache.
        "fig11_launches": fig11["k1_launches"],
        # The smoke cluster with the host engine's KV split by a KV PageMap.
        "serve_kv_launches": kv["k1_launches"],
        "dh32": {name[len("dh32_"):]: {k: sweep[name][k] for k in K1_FIELDS}
                 for name in sweep if name.startswith("dh32_")},
        # The attention families: gemma2-27b at full width (its local and
        # global layers' decode shape: window 4096 and softcap 50), the
        # serve CLI of the four smoke configs, and head_dim 80 and 160.
        "serve_gemma2_launches": gemma2["k1_launches"],
        # Registers and spills of each <type, Dh> instance (ptxas).
        "instances": k1_instances,
        "serve_families_launches": families["k1_launches"],
        # The dense-path families: hymba-1.5b at full width (its tiered
        # cluster, then 2 slots of 2,112 positions), whisper's cross shape
        # and hymba's decode shape on its windowed and full layers.
        "serve_hymba_launches": hymba["k1_launches"],
        "serve_hymba_cluster_launches": hymba["cluster_k1_launches"],
        # The MoE families: dbrx-132b (G = 6) and llama4-maverick (G = 5)
        # served at full width (8 layers, one dense/MoE pair), and their
        # decode shape's cases.
        "serve_moe_launches": moe["k1_launches"],
        # llama31-8b served on a 1 x 1 mesh, every leaf a DTensor.
        "dist_serve_launches": k1_dist_launches,
        # The serve cluster again, its transfers traced and sanitized.
        "serve_traced_launches": traced_serve["k1_launches"],
        **{group: {name[len(group) + 1:]: {k: sweep[name][k] for k in K1_FIELDS}
                   for name in sweep if name.startswith(group + "_")}
           for group in ("gemma2", "dh80", "dh160", "whisper", "hymba", "dbrx", "llama4")},
    }, {
        "name": "global_lambda",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fluid_solver.cu",
        "replaces": "src/repro/memsim/batched/kernel.py:119",
        # No launch of its own on the sweep path: its bisection is a device
        # function that every step of fused_window_solve calls.
        "launches": lane["k2_standalone_launches"],
        "runs_inside": "fused_window_solve",
        **k2_row,
    }, {
        "name": "fused_window_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fluid_solver.cu",
        "replaces": "src/repro/memsim/batched/kernel.py:239",
        "launches": lane["k3_launches"],
        "figures_launches": figures["k3_launches"],
        "figures_instances": figures["k3_instances"],
        # The three-tier figures: the <8, 8> instance on a main path, and its
        # times at the largest group they stack and at a kilo-cell grid.
        "figures3_launches": figures3["k3_launches"],
        "figures3_instances": figures3["k3_instances"],
        "instance_8x8": k3_88,
        # The tiering subsystem's scenarios, and the traced runs.
        "tiering_launches": tiering["k3_launches"],
        "tiering_instances": tiering["k3_instances"],
        "trace_launches": traced["k3_launches"],
        # corun_sweep held against the scalar DES, and the batched lane
        # beside a job that falls back to it.
        "lanes_check_launches": lanes["k3_launches"],
        "lane_fallback_launches": fallback["k3_launches"],
        # corun_sweep on the all-transparent A-direct, and the batchable
        # co-runs beside an open-loop job that falls back by name.
        "fabric_direct_launches": direct["k3_launches"],
        "open_loop_launches": open_loop["k3_launches"],
        # The batchable co-runs beside a sanitized and a traced job, which
        # fall back by name.
        "obs_fallback_launches": obs["k3_launches"],
        # The scenario result API: corun_sweep_1k profiled and a fallback
        # grid; every runner wrapper; fig3 and fig5 on the TPU-unit platform.
        "result_table_launches": table["k3_launches"],
        "runner_figs_launches": runner_k3["k3_launches"],
        "tpu_platform_launches": tpu["k3_launches"],
        **k3_row,
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:89",
        "launches": k4_launches,
        # hymba-1.5b's SSM heads (N = 16): its serve path, its tiered
        # cluster, and the serve CLI on its smoke config.
        "serve_hymba_launches": hymba["k4_launches"],
        "serve_hymba_cluster_launches": hymba["cluster_k4_launches"],
        "serve_families_launches": families["k4_launches"]["hymba-1.5b"],
        # The training path: mamba2-2.7b's train steps through K4's autograd
        # Function (forward launches; the backward is the plain scan's).
        "train_ssm_launches": k4_train_launches,
        # The same train steps with the parameters DTensors on a 1 x 1 mesh.
        "train_ssm_mesh_launches": k4_dist_launches,
        **k4_row,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)



# -- the batched sweep lane: K2, K3 -------------------------------------------


def glam_inputs(rng, C, W, pad=0, tor_hi=512.0):
    """tests/test_batched.py::test_pallas_backend_matches_numpy's input
    distribution (numpy, float64); the last ``pad`` workload slots are
    padding (A = 0, cap = 0), ``tor_hi`` widens the ToR so that some cells
    are feasible at their cap."""
    A = rng.uniform(1, 16, (C, W))
    cap = rng.uniform(0.05, 3.0, (C, W))
    y_sta = rng.uniform(0.05, 2.0, (C, W))
    o_eff = rng.uniform(20, 640, (C, W))
    R_tor = rng.uniform(150, 2500, (C, W))
    tor = rng.uniform(64, tor_hi, C)
    irq = rng.choice([64.0, 80.0], C)
    if pad:
        A[:, -pad:] = cap[:, -pad:] = y_sta[:, -pad:] = o_eff[:, -pad:] = 0.0
    return A, cap, y_sta, o_eff, R_tor, tor, irq


def random_window_inputs(rng, C, W, S, pad_w=0, pad_s=0):
    """One seeded window of the fluid solver's inputs (numpy, float64):
    up to 16 cores and MLP 8-64 per workload, token-bucket rates on about a
    third of them, tier fractions and LLC hit shares drawn per workload,
    device service 16-300 ns, pipelines 50-450 ns, 28-192 slots per
    station, the ToR and IRQ of the two platforms; the last ``pad_w``
    workloads and ``pad_s`` stations are padding."""
    T = S - 1
    A = rng.integers(1, 17, (C, W)).astype(float)
    o_eff = A * rng.choice([8, 10, 16, 24, 40, 64], (C, W)).astype(float)
    y_rate = np.where(rng.random((C, W)) < 0.7, np.inf, rng.uniform(0.005, 0.2, (C, W)))
    frac = rng.dirichlet(np.ones(T), (C, W)) if T > 1 else np.ones((C, W, 1))
    p_llc = np.where(rng.random((C, W)) < 0.5, 0.0, rng.uniform(0, 1, (C, W)))
    route = np.concatenate([frac * (1 - p_llc)[:, :, None], p_llc[:, :, None]], axis=2)
    svc = rng.uniform(16, 300, (C, W, S))
    pipe = np.concatenate([rng.uniform(50, 450, (C, 1, T)).repeat(W, 1),
                           np.zeros((C, W, 1))], axis=2)
    route_svc = route * svc
    slots = rng.choice([28.0, 56.0, 96.0, 128.0, 192.0], (C, S))
    tor = rng.choice([512.0, 576.0], C)
    irq = rng.choice([64.0, 80.0], C)
    if pad_w:
        A[:, -pad_w:] = o_eff[:, -pad_w:] = 0.0
        route[:, -pad_w:] = route_svc[:, -pad_w:] = 0.0
    if pad_s:
        slots[:, -pad_s:] = 0.0
        route[:, :, -pad_s:] = route_svc[:, :, -pad_s:] = 0.0
    return [A, y_rate, o_eff, route, route_svc, svc + pipe, slots, tor, irq,
            np.zeros((C, S))]


def f32_rounded(arrays):
    """The values the f32 kernels see (clamped to 1e30, rounded to f32), in
    float64: the plain version gets the same inputs as the kernel."""
    return [np.minimum(a, 1e30).astype(np.float32).astype(np.float64) for a in arrays]


def glam_ops(C, W):
    """f32 operations of K2 on C cells: 49 feasibility tests (8 per workload
    for the holdings, 6 per workload for the queue-forming share, 3 more)
    and 48 bisection updates of 4."""
    return C * (49 * (14 * W + 3) + 48 * 4)


def window_solve_ops(C, W, S, n_outer):
    """f32 operations of K3 on C cells, counted from the loop nest of
    csrc/fluid_solver.cu::window_solve_cell (fixed trip counts, so the same
    for any data)."""
    station = 3 * W + 1 + S * (49 * (4 * W + 1) + 48 * 4 + 2)
    glam = 49 * (14 * W + 3) + 48 * 4
    rest = (W * (3 * S + 4) + W * (3 * S + 7) + 20 * W + S * (4 * W + 5)
            + W * (5 + 2 * S) + 7 + W + S * (7 * W + 10))
    return C * (2 * W * S + n_outer * (station + glam + rest))


def graph_kernels(fn) -> list:
    """The kernels that one call of ``fn`` enqueues, as (mangled name,
    (grid x, y, z)) pairs: the call captured in a CUDA graph, its kernel
    nodes read back through the driver API."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: the function, then gridDimX, Y, Z.
        params = (ctypes.c_uint8 * 256)()
        name = ctypes.c_char_p()
        check(cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) == 0
              and cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p.from_buffer(
                  params).value) == 0, "reading a kernel node's name failed")
        grid = tuple((ctypes.c_uint32 * 3).from_buffer(params, 8))
        names.append((name.value.decode(), grid))
    return names


def profiled(fn):
    """torch.profiler's device events of ``fn()`` (finished on the card),
    traced behind ``PROFILE_PAD_KERNELS`` spin kernels, which are left out;
    the padding records the trace lost go to ``PROFILE_PADS_LOST``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    pads = sum(e.count for e in events if "spin_kernel" in e.key)
    PROFILE_PADS_LOST.append(PROFILE_PAD_KERNELS - pads)
    return [e for e in events if "spin_kernel" not in e.key]


def kernel_device_ms(fn, names, iters: int = 20, kernels: int = 1,
                     tries: int = 3, by_kernel: bool = False):
    """Device time per call of the ``kernels`` kernels whose names contain
    one of ``names`` (each launched once a call of ``fn``), from
    torch.profiler over ``iters`` calls (the wrapper's own casts and copies
    excluded).  A trace that does not show each such kernel ``iters`` times
    is taken again (and noted in ``PROFILE_RETAKES``), up to ``tries``
    times.  With ``by_kernel``, the time of each of ``names`` that ran."""
    import torch

    names = (names,) if isinstance(names, str) else names

    def calls():
        for _ in range(iters):
            fn()

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        hits = [e for e in profiled(calls) if any(n in e.key for n in names)]
        if len(hits) == kernels and all(e.count == iters for e in hits):
            each = {n: sum(e.self_device_time_total for e in hits if n in e.key) / iters / 1e3
                    for n in names if any(n in e.key for e in hits)}
            return each if by_kernel else sum(each.values())
        PROFILE_RETAKES.append((names, [(e.key[:60], e.count) for e in hits], iters))
    fail(f"profiler saw {[(e.key[:60], e.count) for e in hits]} for {names} in "
         f"{iters} calls, {tries} times")


def bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / h100().hbm_bw, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_check(dev):
    """Phase 6: the global-lambda kernel (through the port's dispatcher)
    against global_lambda_ref in float64 on the card: the same +inf mask
    and rel 2e-3 on finite values (tests/test_batched.py's bounds)."""
    import torch

    from repro_torch.kernels.ref import global_lambda_ref
    from repro_torch.memsim.batched import kernel as bk

    cases = [("reference_test", np.random.default_rng(3), 6, 3, 0, 512.0)]
    rng = np.random.default_rng(2)
    for C in (1, 7, 128, 1024):
        for W in (1, 2, 3, 5, 8):
            cases.append((f"C{C}_W{W}", rng, C, W, (C + W) % 3 % W, 4096.0))
    worst, n_inf, n_cells = 0.0, 0, 0
    for name, r, C, W, pad, tor_hi in cases:
        args = [torch.as_tensor(a, device=dev)
                for a in f32_rounded(glam_inputs(r, C, W, pad, tor_hi))]
        out = bk.global_lambda(*args)
        torch.cuda.synchronize()
        ref = global_lambda_ref(*args)
        fin = torch.isfinite(ref)
        same = bool((torch.isfinite(out) == fin).all())
        rel = ((out[fin] - ref[fin]).abs() / ref[fin].abs()).max().item() if fin.any() else 0.0
        worst = max(worst, rel)
        n_inf += int((~fin).sum())
        n_cells += C
        check(same and rel <= 2e-3,
              f"global_lambda {name}: same inf mask {same}, max rel err {rel}")
    # The corun_sweep_1k shape: one window of both groups, C=1024, W=2.
    args = [torch.as_tensor(a, device=dev) for a in
            f32_rounded(glam_inputs(np.random.default_rng(4), 1024, 2, 0, 4096.0))]
    out, ref = bk.global_lambda(*args), global_lambda_ref(*args)
    fin = torch.isfinite(ref)
    row = dict(
        max_abs_err=(out[fin] - ref[fin]).abs().max().item(),
        ms=time_ms(lambda: bk.global_lambda(*args), 100),
        plain_ms=time_ms(lambda: global_lambda_ref(*args), 10),
        library_ms=None,
    )
    nbytes = (5 * 1024 * 2 + 3 * 1024) * 4 + 1024 * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, glam_ops(1024, 2), h100().peak_flops_f32)
    row["kernel_device_ms"] = kernel_device_ms(lambda: bk.global_lambda(*args),
                                               "global_lambda_kernel")
    emit("k2_check", cases=len(cases), cells=n_cells, inf_cells=n_inf, tol_rel=2e-3,
         max_rel_err=worst, shape=dict(C=1024, W=2), **row)
    return row


def k3_check(dev):
    """Phase 7: the fused window solver against fused_window_solve_ref in
    float64 on the card, on corun_sweep_1k's first window (both groups,
    C=1024) and on seeded random windows."""
    import torch

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.kernels.ref import fused_window_solve_ref
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.batched import kernel as bk
    from repro_torch.scenarios import run_scenario

    n_outer, damp = fluid._N_OUTER, fluid._DAMP

    def compare(args):
        """Kernel against plain version: whether isfinite(lam) agrees and y
        and Wq are finite everywhere, each cell's max rel error over y and
        Wq (NaN stays NaN), the max abs error of y, and the coupled cells."""
        y, wq, lam = fs.fused_window_solve_cuda(*args, n_outer, damp)
        torch.cuda.synchronize()
        yr, wr, lr = fused_window_solve_ref(*args, n_outer, damp)
        same = bool((torch.isfinite(lam) == torch.isfinite(lr)).all()
                    and torch.isfinite(y).all() and torch.isfinite(wq).all())
        err = torch.maximum(
            ((y - yr).abs() / yr.abs().clamp(min=1e-12)).amax(dim=1),
            ((wq - wr).abs() / wr.abs().clamp(min=1e-12)).amax(dim=1))
        return same, err, (y - yr).abs().max().item(), int(torch.isfinite(lr).sum()), y, wq

    # corun_sweep_1k's first window, as the lane hands it to the solver.
    first = []
    record = bk.fused_window_solve

    def capture(*args):
        first.append(args[:10])
        return record(*args)

    fluid.kernel.fused_window_solve = capture
    try:
        run_scenario("corun_sweep_1k", {"sim_ns": 10_000.0})
    finally:
        fluid.kernel.fused_window_solve = record
    check(len(first) == 2 and sum(a[0].shape[0] for a in first) == 1024,
          f"corun_sweep_1k's first window is not two groups of 1024 cells: {len(first)}")
    a, b = first
    args = [torch.as_tensor(x, device=dev) for x in
            f32_rounded([torch.cat([a[i], b[i]]).cpu().numpy() for i in range(10)])]
    same, err, max_abs, coupled, _, _ = compare(args)
    emit("k3_check", window="corun_sweep_1k first window", C=1024, W=2, S=3,
         coupled_cells=coupled, same_isfinite_lam_finite_y_wq=same, tol_rel=2e-3,
         max_rel_err_y_wq=err.max().item(), max_abs_err_y=max_abs)
    check(same and bool((err <= 2e-3).all()),
          f"fused_window_solve on corun_sweep_1k's first window: mask {same}, "
          f"max rel err {err.max().item()}")
    row = dict(
        max_abs_err=max_abs,
        ms=time_ms(lambda: fs.fused_window_solve_cuda(*args, n_outer, damp), 20),
        plain_ms=time_ms(lambda: fused_window_solve_ref(*args, n_outer, damp), 1),
        library_ms=None,
    )
    C, W, S = shape = args[3].shape
    nbytes = (3 * C * W + 3 * C * W * S + 2 * C * S + 2 * C + C * W + C * S + C) * 4
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, window_solve_ops(C, W, S, n_outer), h100().peak_flops_f32)
    # The sequential bisection steps a cell's chain had (the tests at the
    # cap included), and the dependent rounds the warp runs instead: the
    # stations' tests at the cap take one step on all lanes, the global
    # lambda's runs on a spare lane of its first round.
    scheme = fs.round_scheme(S)  # as the CUDA source defines it
    rounds = scheme["rounds_per_bisection"]
    row["serial_steps_per_cell"] = n_outer * (S * 49 + 49)
    row["dependent_rounds_per_cell"] = n_outer * (1 + rounds["station"]
                                                  + rounds["global_lambda"])
    row.update(scheme)

    rng = np.random.default_rng(5)
    beyond = cells = 0
    for C, W, S, pad_w, pad_s in K3_RANDOM_CASES:
        rargs = [torch.as_tensor(a, device=dev)
                 for a in f32_rounded(random_window_inputs(rng, C, W, S, pad_w, pad_s))]
        same, err, max_abs, coupled, y, wq = compare(rargs)
        n_beyond = int((~(err <= 2e-3)).sum())  # a NaN error counts as beyond
        beyond += n_beyond
        cells += C
        # Padded workloads and stations carry nothing: exactly 0, not NaN.
        pads_zero = bool((y[:, W - pad_w:] == 0).all() if pad_w else True) and bool(
            (wq[:, S - pad_s:] == 0).all() if pad_s else True)
        emit("k3_check", window="random", C=C, W=W, S=S, padded_workloads=pad_w,
             padded_stations=pad_s, coupled_cells=coupled,
             same_isfinite_lam_finite_y_wq=same, padding_exactly_zero=pads_zero,
             max_rel_err_y_wq=err.max().item(), p99_rel_err_y_wq=err.quantile(0.99).item(),
             cells_beyond_2e_3=n_beyond)
        check(same, f"fused_window_solve random C={C} W={W} S={S}: isfinite(lam) "
              "differs or y/Wq not finite")
        check(pads_zero, f"fused_window_solve random C={C} W={W} S={S}: padded "
              "workloads' y or padded stations' Wq not exactly 0")
    check(beyond <= K3_RANDOM_MAX_SHARE_BEYOND * cells,
          f"fused_window_solve random windows: {beyond} of {cells} cells beyond 2e-3")
    row["kernel_device_ms"] = kernel_device_ms(
        lambda: fs.fused_window_solve_cuda(*args, n_outer, damp),
        "fused_window_solve_kernel", 10)
    emit("k3_timing", shape=dict(zip("CWS", shape)), **row)
    return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "kernel_device_ms")}


def sweep_phase(dev):
    """Phase 9, the main path of K2 and K3: the kilo-cell co-run grid and
    the 96-cell grid on the batched lane, through K3, with the launch counts
    set to 0 just before each run and read just after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.kernels.ref import fused_window_solve_ref
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.batched.lane import partition_jobs
    from repro_torch.scenarios import plan, run_scenario

    def host_stages(name):
        """Host seconds of the run's first two stages, alone: expanding the
        grid into jobs, and planning the cells (exported state and the
        calibrated MIKU units)."""
        t0 = time.perf_counter()
        jobs = [j for _, _, js in plan(name) for j in js]
        t1 = time.perf_counter()
        partition_jobs(jobs)
        return dict(host_expand_s=t1 - t0, host_plan_cells_s=time.perf_counter() - t1)

    def run(name):
        fs.GLOBAL_LAMBDA_LAUNCHES.reset()
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        fluid.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run_scenario(name).rows
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = dict(scenario=name, cells=len(rows), wall_s=wall,
                   windows=fluid.COUNTS.windows,
                   k3_launches=fs.WINDOW_SOLVE_LAUNCHES.count,
                   k2_standalone_launches=fs.GLOBAL_LAMBDA_LAUNCHES.count,
                   host_copies=fluid.COUNTS.host_copies,
                   host_copies_per_window=fluid.COUNTS.host_copies / max(1, fluid.COUNTS.windows))
        check(out["k3_launches"] == out["windows"] > 0,
              f"{name}: {out['k3_launches']} K3 launches for {out['windows']} windows")
        check(all(all(map(_finite, (r["ddr_gbps"], r["cxl_gbps"]))) and r["ddr_gbps"] > 0
                  for r in rows), f"{name}: non-finite or zero bandwidth")
        return rows, out

    rows, main = run("corun_sweep_1k")  # the main path
    check(main["windows"] == 20, f"corun_sweep_1k ran {main['windows']} windows, not 20")
    # The plain lane on the card: the same run with the float64 solver.
    solve = fluid.kernel.fused_window_solve
    fluid.kernel.fused_window_solve = fused_window_solve_ref
    try:
        t0 = time.perf_counter()
        plain = run_scenario("corun_sweep_1k").rows
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    finally:
        fluid.kernel.fused_window_solve = solve
    errs, flips = [], 0
    for k, p in zip(rows, plain):
        if (k["restricted_windows"] > 0) != (p["restricted_windows"] > 0):
            flips += 1
            continue
        errs.append(max(abs(k[w] - p[w]) / max(p[w], 1e-9) for w in ("ddr_gbps", "cxl_gbps")))
    errs.sort()
    p95 = errs[int(0.95 * (len(errs) - 1))] if errs else 0.0
    restricted = sum(r["restricted_windows"] > 0 for r in rows)
    emit("sweep", **main, **host_stages("corun_sweep_1k"), plain_lane_wall_s=plain_wall,
         restricted_cells=restricted,
         decision_flip_cells=flips, max_flips=SWEEP1K_MAX_FLIPS,
         aligned_p95_rel_err=p95, aligned_worst_rel_err=errs[-1] if errs else 0.0,
         p95_bound=SWEEP1K_P95_BOUND)
    check(flips <= SWEEP1K_MAX_FLIPS and p95 <= SWEEP1K_P95_BOUND,
          f"corun_sweep_1k: {flips} decision flips, aligned p95 {p95}")
    check(restricted > 0, "corun_sweep_1k: MIKU restricted no cell")

    _, small = run("corun_sweep")
    emit("sweep", **small)

    # Where the sweep's time goes: one profiled run of the main path.
    run_scenario("corun_sweep_1k")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scenario("corun_sweep_1k")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    emit("sweep_profile", scenario="corun_sweep_1k", wall_s_profiled=wall,
         device_s=dev_us / 1e6, device_busy_share=dev_us / 1e6 / wall,
         device_kernels=sum(e.count for e in events),
         top_kernels=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                           calls=e.count) for e in top])
    return main


# -- the scalar DES lane: goldens, the lanes held against each other, the
# -- batched lane's fallback, fig2 ------------------------------------------------

#: The reference's bounds of the batched lane against the scalar DES
#: (tests/test_batched.py:172-222): over corun_sweep's 96 cells the worst and
#: the mean relative bandwidth error; on its five cells of
#: test_corun_racing_equivalence / test_corun_miku_equivalence (platform A,
#: 16 threads, mlp 160) their own bounds.
#: The routed fabric's scenarios (their jobs fall back to the scalar DES).
FABRIC_SCENARIOS = ("fabric_spine_congestion", "fabric_port_overflow", "fabric_miku")
LANES_WORST_BOUND = 0.15
LANES_MEAN_BOUND = 0.03
LANES_RACING_BW = 0.05
LANES_RACING_SERVICE = 0.10
LANES_MIKU_DDR = 0.05
LANES_MIKU_CXL = 0.10
LANES_MAX_RESTRICTED_DIFF = 3
#: The reference's rel bound on the pinned figure goldens
#: (tests/test_substrate.py:136-151).
GOLDENS_REL = 0.01


def host_cpu() -> str:
    """The host's CPU as ``/proc/cpuinfo``'s first processor names it (its
    model name, else its vendor, family and model fields), the machine and
    the core count: the DES runs on the host, so its walls are the host's."""
    import platform

    fields = {}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                if value.strip() not in ("", "unknown"):
                    fields.setdefault(key.strip(), value.strip())
    keys = (("model name",) if "model name" in fields else
            ("vendor_id", "cpu family", "model", "stepping", "CPU implementer",
             "CPU part", "Hardware"))
    model = ", ".join(f"{k} {fields[k]}" for k in keys if k in fields) or "unknown"
    return f"{model} ({platform.machine()}, {os.cpu_count()} cores)"


def des_mismatches(a, b) -> list:
    """The fields in which two scalar-lane SimResults differ, compared at
    tolerance 0 (as tests/test_torch_des.py compares the port with the
    reference)."""
    def decision(d):
        if hasattr(d, "items") and hasattr(d, "tiers"):
            return {t: (x.max_concurrency, x.rate_factor, x.phase.value) for t, x in d.items()}
        return (d.max_concurrency, d.rate_factor, d.phase.value)

    out = []
    for name in a.stats.keys() | b.stats.keys():
        x, y = a.stats.get(name), b.stats.get(name)
        if x is None or y is None or (x.completed, x.bytes, x.latency_sum, x.latency_samples) \
                != (y.completed, y.bytes, y.latency_sum, y.latency_samples):
            out.append(f"stats[{name}]")
    for t in a.tier_counters:
        x, y = a.tier_counters[t], b.tier_counters.get(t)
        if y is None or (x.inserts, x.occupancy_time, dict(x.class_counts)) \
                != (y.inserts, y.occupancy_time, dict(y.class_counts)):
            out.append(f"tier_counters[{t}]")
    for key in ("tor_peak", "tor_inserts", "tor_occupancy_integral",
                "per_tier_occupancy_integral", "tiering", "fabric", "arrival"):
        if getattr(a, key) != getattr(b, key):
            out.append(key)
    if [decision(d) for d in a.decisions] != [decision(d) for d in b.decisions]:
        out.append("decisions")
    if json.dumps(a.window_records, sort_keys=True) != json.dumps(b.window_records,
                                                                   sort_keys=True):
        out.append("window_records")
    return out


def scalar_lane_phase(smi: str):
    """The scalar DES on the card's host: tests/data/seed_fig_goldens.json's
    fig3 load column and fig5 load through ``run_bw_test`` / ``run_corun``
    (rel 0.01, ToR inserts equal), miku_trace_des.json's decisions from a
    live MIKU co-run (equal), and the wall and events per second of the
    fig5 load co-run (BENCH_des.json's ``fig5_corun_load_16t_300us``;
    events are completed requests, as benchmarks/bench_des.py counts
    them).  The golden files are read as data."""
    from repro_torch.core.des import run_bw_test, run_corun
    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.memsim.calibration import default_miku

    data = os.path.join(HERE, "tests", "data")
    with open(os.path.join(data, "seed_fig_goldens.json")) as f:
        gold = json.load(f)
    with open(os.path.join(data, "miku_trace_des.json")) as f:
        trace = [w["decision"] for w in json.load(f)["windows"]]
    p = platform_a()
    fig3 = []
    for row in gold["fig3"]:
        if row["op"] != "load":
            continue
        res = run_bw_test(p, op=OpClass.LOAD, tier=row["tier"], n_threads=16, sim_ns=120_000)
        got = res.bandwidth(f"bw-{row['tier']}-load")
        fig3.append(dict(tier=row["tier"], gbps=got, golden=row["bandwidth_gbps"],
                         rel_err=abs(got - row["bandwidth_gbps"]) / row["bandwidth_gbps"]))
    walls, completed = [], 0
    for _ in range(3):
        t0 = time.perf_counter()
        both = run_corun(p, op=OpClass.LOAD, n_threads=16, sim_ns=300_000)
        walls.append(time.perf_counter() - t0)
        completed = sum(s.completed for s in both.stats.values())
    g = gold["fig5"]["load"]
    fig5 = dict(ddr_gbps=both.bandwidth("ddr"), cxl_gbps=both.bandwidth("cxl"),
                tor_inserts=both.tor_inserts, golden=g,
                rel_err=max(abs(both.bandwidth(w) - g[f"{w}_gbps"]) / g[f"{w}_gbps"]
                            for w in ("ddr", "cxl")))
    t0 = time.perf_counter()
    live = run_corun(p, op=OpClass.STORE, n_threads=16, sim_ns=400_000,
                     controller=default_miku(p))
    miku_wall = time.perf_counter() - t0
    got_trace = [dict(max_concurrency=d.max_concurrency, rate_factor=d.rate_factor,
                      phase=d.phase.value) for d in live.decisions]
    walls.sort()
    emit("scalar_lane", fig3_load=fig3, fig5_load=fig5, goldens_rel=GOLDENS_REL,
         miku_trace_windows=len(trace), miku_trace_equal=got_trace == trace,
         miku_corun_wall_s=miku_wall, bench_config="fig5_corun_load_16t_300us",
         corun_wall_s=dict(best=walls[0], median=walls[1], runs=walls),
         completed_requests=completed, events_per_s=completed / walls[0],
         host_cpu=host_cpu(), card=smi)
    for row in fig3:
        check(row["rel_err"] <= GOLDENS_REL,
              f"scalar_lane: fig3 load {row['tier']} {row['gbps']} vs golden {row['golden']}")
    check(fig5["rel_err"] <= GOLDENS_REL and fig5["tor_inserts"] == g["tor_inserts"],
          f"scalar_lane: fig5 load {fig5} vs the golden")
    check(got_trace == trace, "scalar_lane: the live MIKU co-run's decisions differ from "
          "miku_trace_des.json")
    return dict(events_per_s=completed / walls[0], corun_wall_s=walls[0])


def lanes_check(dev):
    """corun_sweep's 96 jobs on the batched lane on the card (K3's count set
    to 0 just before and read just after: 60 launches, as in the sweep
    phase) and on the scalar DES over a pool of spawn workers, held against
    each other by the reference's bounds: worst and mean bandwidth error
    over the grid, and on its five cells of tests/test_batched.py:172-206
    their own bounds, restricted windows at most 3 apart."""
    import torch

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.sweep import run_sweep
    from repro_torch.scenarios import plan

    planned = plan("corun_sweep")
    jobs = [j for _, _, js in planned for j in js]
    cells = [cell for cell, _, js in planned for _ in js]
    fs.WINDOW_SOLVE_LAUNCHES.reset()
    fluid.COUNTS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = run_sweep(jobs, device=dev)
    torch.cuda.synchronize()
    batched_wall = time.perf_counter() - t0
    launches, windows = fs.WINDOW_SOLVE_LAUNCHES.count, fluid.COUNTS.windows
    procs = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    scalar = run_sweep(jobs, lane="scalar", processes=procs)
    scalar_wall = time.perf_counter() - t0
    errs, restricted_diffs, named = [], [], []
    for cell, b, s in zip(cells, batched, scalar):
        e = {w: abs(b.bandwidth(w) - s.bandwidth(w)) / max(s.bandwidth(w), 1e-9)
             for w in ("ddr", "cxl")}
        errs.extend(e.values())
        rs = sum(1 for d in s.decisions if d.restricted)
        rb = sum(1 for d in b.decisions if d.restricted)
        if cell["miku"]:
            restricted_diffs.append(abs(rs - rb))
        if (cell["platform"], cell["threads"], cell["mlp"]) == ("A", 16, 160):
            svc = [r.tier_counters["cxl"].mean_service_time for r in (b, s)]
            named.append(dict(op=cell["op"].value, miku=cell["miku"], rel_err=e,
                              cxl_service_rel_err=abs(svc[0] - svc[1]) / max(svc[1], 1e-9),
                              decisions=(len(b.decisions), len(s.decisions)),
                              restricted=(rb, rs)))
    worst, mean = max(errs), sum(errs) / len(errs)
    emit("lanes_check", scenario="corun_sweep", cells=len(jobs), k3_launches=launches,
         windows=windows, batched_wall_s=batched_wall, scalar_wall_s=scalar_wall,
         scalar_processes=procs, worst_rel_err=worst, mean_rel_err=mean,
         worst_bound=LANES_WORST_BOUND, mean_bound=LANES_MEAN_BOUND,
         restricted_window_diffs=sum(restricted_diffs),
         restricted_window_diff_max=max(restricted_diffs),
         cells_with_restricted_diff=sum(d > 0 for d in restricted_diffs),
         reference_cells=named, host_cpu=host_cpu())
    check(launches == windows == 60, f"lanes_check: {launches} K3 launches for {windows} "
          "windows, not 60")
    check(worst < LANES_WORST_BOUND and mean < LANES_MEAN_BOUND,
          f"lanes_check: worst {worst}, mean {mean} against the scalar DES")
    check(len(named) == 6, f"lanes_check: {len(named)} reference cells in the grid")
    for row in named:
        where = f"lanes_check {row['op']} miku={row['miku']}"
        if not row["miku"]:
            check(max(row["rel_err"].values()) <= LANES_RACING_BW
                  and row["cxl_service_rel_err"] <= LANES_RACING_SERVICE,
                  f"{where}: {row}")
        elif row["op"] != "nt_store":
            check(row["rel_err"]["ddr"] <= LANES_MIKU_DDR
                  and row["rel_err"]["cxl"] <= LANES_MIKU_CXL
                  and row["decisions"][0] == row["decisions"][1]
                  and abs(row["restricted"][0] - row["restricted"][1])
                  <= LANES_MAX_RESTRICTED_DIFF, f"{where}: {row}")
    return dict(k3_launches=launches, scalar_wall_s=scalar_wall, worst=worst, mean=mean)


class FrozenPolicy:
    """tests/test_batched.py:305-344's tiering policy outside the vectorized
    hierarchy: the scalar hook runs it, the vector twin cannot."""

    name = "frozen_test_policy"

    def decide(self, pagemap, ctx):
        del pagemap, ctx
        return []


def lane_fallback(dev):
    """A mixed list on the card: the FrozenPolicy tiering job, which the
    batched lane cannot stack, and two MIKU co-runs that stack.  The
    fallback is recorded with the policy's name, its result equals
    ``run_sweep(lane="scalar")`` bit for bit, K3 runs the co-runs (its
    count set to 0 just before and read just after) and every job has a
    result."""
    import torch

    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.batched.lane import partition_jobs, run_sweep_batched
    from repro_torch.memsim.sweep import SimJob, run_sweep
    from repro_torch.memsim.workloads import bw_test
    from repro_torch.tiering import HotSetPattern, RegionSpec, TieringSpec
    from repro_torch.tiering.policies import POLICIES

    p = platform_a()
    spec = TieringSpec(regions=(RegionSpec(workload="cxl", n_pages=128,
                                           placement={"cxl": 1.0}, pattern=HotSetPattern()),),
                       policy=FrozenPolicy.name)
    jobs = [SimJob(platform=p, workloads=[bw_test("cxl", OpClass.LOAD, 4, name="cxl")],
                   sim_ns=60_000.0, tiering=spec)]
    for op in (OpClass.LOAD, OpClass.STORE):
        jobs.append(SimJob(platform=p, workloads=[
            bw_test("ddr", op, 16, name="ddr", miku_managed=False),
            bw_test("cxl", op, 16, name="cxl")], sim_ns=60_000.0, miku=True))
    POLICIES[FrozenPolicy.name] = FrozenPolicy
    try:
        partition = partition_jobs(jobs)
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        fluid.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = run_sweep_batched(jobs, device=dev, partition=partition)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, windows = fs.WINDOW_SOLVE_LAUNCHES.count, fluid.COUNTS.windows
        (scalar,) = run_sweep(jobs[:1], lane="scalar")
    finally:
        POLICIES.pop(FrozenPolicy.name, None)
    fallbacks = partition[1]
    diff = des_mismatches(results[0], scalar)
    emit("lane_fallback", jobs=len(jobs), fallbacks=fallbacks, k3_launches=launches,
         windows=windows, wall_s=wall, fallback_equals_scalar=not diff, mismatches=diff,
         tiering=results[0].tiering,
         batched_gbps=[{w: r.bandwidth(w) for w in r.stats} for r in results[1:]])
    check([i for i, _ in fallbacks] == [0] and FrozenPolicy.name in fallbacks[0][1],
          f"lane_fallback: fallbacks {fallbacks}")
    check(not diff, f"lane_fallback: the fallback differs from the scalar run in {diff}")
    check(launches == windows == 6, f"lane_fallback: {launches} K3 launches for {windows} "
          "windows, not 6")
    # Every demand workload moved data (the fallback's migration workload
    # stays gated closed: its policy enqueues no copy).
    check(all(r is not None for r in results) and all(
        _finite(r.bandwidth(w)) and r.bandwidth(w) > 0
        for r in results for w in ("ddr", "cxl") if w in r.stats),
        "lane_fallback: a job without a result")
    return dict(k3_launches=launches)


def fig2_phase(dev):
    """``run_scenario("fig2_tiering")`` on the default device (its cells run
    on the scalar DES): each op's upper_ddr_only and lower_cxl_only equal
    seed_fig_goldens.json's fig3 row of that op (the same jobs), every
    column finite."""
    from repro_torch.scenarios import run_scenario

    with open(os.path.join(HERE, "tests", "data", "seed_fig_goldens.json")) as f:
        fig3 = {(r["op"], r["tier"]): r["bandwidth_gbps"] for r in json.load(f)["fig3"]}
    t0 = time.perf_counter()
    rows = run_scenario("fig2_tiering", device=dev).rows
    wall = time.perf_counter() - t0
    emit("fig2", rows=rows, wall_s=wall, host_cpu=host_cpu())
    check(len(rows) == 3, f"fig2: {len(rows)} rows")
    for r in rows:
        check((r["upper_ddr_only"], r["lower_cxl_only"])
              == (fig3[(r["op"], "ddr")], fig3[(r["op"], "cxl")]),
              f"fig2 {r['op']}: upper/lower {r['upper_ddr_only']}/{r['lower_cxl_only']} "
              "differ from the fig3 goldens")
        check(all(_finite(v) and v > 0 for k, v in r.items() if isinstance(v, float)),
              f"fig2 {r['op']}: non-finite or zero column {r}")


# -- the routed fabric and open-loop arrivals (their jobs run on the scalar DES) --


def fabric_phase(dev):
    """The routed fabric on the card's host.  The live spine co-run under the
    per-edge law reproduces tests/data/fabric_trace_goldens.json (each
    window's per-edge decisions and records, the fabric summary, the
    bandwidths).  The three fabric scenarios run through
    ``run_scenario(lane="batched")`` on the card: every job is a
    ``"fabric_topology"`` fallback, each row equals the scalar lane's, and
    tests/test_fabric.py's acceptance of fabric_spine_congestion holds, with
    the crossover of fabric_port_overflow and the spared host of
    fabric_miku."""
    from repro_torch.core.des import TieredMemorySim
    from repro_torch.core.littles_law import OpClass
    from repro_torch.fabric import peredge_miku, spine_leaf_platform
    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched.lane import partition_jobs
    from repro_torch.memsim.workloads import bw_test
    from repro_torch.scenarios import plan, run_scenario

    with open(os.path.join(HERE, "tests", "data", "fabric_trace_goldens.json")) as f:
        blob = json.load(f)
    pm = spine_leaf_platform()
    op, n = OpClass(blob["op"]), blob["n_threads"]
    wls = [bw_test("ddr", op, n, name="ddr", miku_managed=False, host="host0"),
           bw_test("cxl", op, n, name="cxl0", host="host0"),
           bw_test("cxl", op, n, name="cxl1", host="host1")]
    t0 = time.perf_counter()
    res = TieredMemorySim(pm, wls, seed=0, granularity=4, controller=peredge_miku(pm, 4),
                          window_ns=blob["window_ns"], record_windows=True,
                          control_scope="edge").run(blob["sim_ns"])
    golden_wall = time.perf_counter() - t0
    edges = tuple(blob["edge_names"])
    decisions_equal = len(res.decisions) == len(blob["windows"]) and all(
        d.tiers == edges and all(
            (d.for_tier(e).max_concurrency, d.for_tier(e).rate_factor,
             d.for_tier(e).phase.value)
            == tuple(w["decision"][e][k] for k in ("max_concurrency", "rate_factor", "phase"))
            for e in edges)
        for d, w in zip(res.decisions, blob["windows"]))
    golden = dict(windows=len(blob["windows"]), decisions_equal=decisions_equal,
                  records_equal=res.window_records == blob["windows"],
                  fabric_equal=res.fabric == blob["fabric"],
                  bandwidths={w: res.bandwidth(w) for w in blob["bandwidths"]},
                  bandwidths_equal=all(res.bandwidth(w) == bw
                                       for w, bw in blob["bandwidths"].items()),
                  completed=sum(s.completed for s in res.stats.values()), wall_s=golden_wall)
    rows, walls, fallbacks = {}, {}, {}
    fs.WINDOW_SOLVE_LAUNCHES.reset()
    for name in FABRIC_SCENARIOS:
        jobs = [j for _, _, js in plan(name) for j in js]
        fallbacks[name] = [reason for _, reason in partition_jobs(jobs)[1]]
        t0 = time.perf_counter()
        rows[name] = run_scenario(name, device=dev, lane="batched").rows
        walls[name] = time.perf_counter() - t0
        check(len(fallbacks[name]) == len(jobs)
              and set(fallbacks[name]) == {"fabric_topology"},
              f"fabric {name}: fallbacks {fallbacks[name]} for {len(jobs)} jobs")
    launches = fs.WINDOW_SOLVE_LAUNCHES.count
    scalar = {name: run_scenario(name, device=dev, lane="scalar").rows for name in rows}
    spine = {r["law"]: r for r in rows["fabric_spine_congestion"]}
    port = {r["port_queue"]: r["port_limited"] for r in rows["fabric_port_overflow"]}
    miku = {r["law"]: r for r in rows["fabric_miku"]}
    emit("fabric", golden=golden, rows=rows, walls_s=walls, fallbacks=fallbacks,
         rows_equal_scalar={name: rows[name] == scalar[name] for name in rows},
         k3_launches=launches, host_cpu=host_cpu())
    check(decisions_equal and golden["records_equal"] and golden["fabric_equal"]
          and golden["bandwidths_equal"],
          f"fabric: the spine co-run differs from fabric_trace_goldens.json: {golden}")
    for name in rows:
        check(rows[name] == scalar[name], f"fabric {name}: batched-lane rows differ from "
              "the scalar lane's")
    check(spine["racing"]["ddr_pct_of_alone"] < 10.0
          and spine["peredge"]["ddr_pct_of_alone"] > 60.0
          and spine["peredge"]["spine_restricted_windows"] > 0
          and spine["racing"]["spine_stall_events"] > spine["peredge"]["spine_stall_events"],
          f"fabric_spine_congestion: acceptance fails on {spine}")
    check(port == {64: 1, 256: 1, 1024: 1, 2048: 0},
          f"fabric_port_overflow: port_limited {port}")
    check(miku["peredge"]["cxl0_pct_of_alone"] > miku["pertier"]["cxl0_pct_of_alone"],
          f"fabric_miku: peredge spares host0's CXL no better than pertier: {miku}")
    check(launches == 0, f"fabric: {launches} K3 launches for jobs that all fall back")


def fabric_direct(dev):
    """The degenerate all-transparent ``A-direct`` on the card: corun_sweep's
    96 cells with A-direct in place of A, batched (K3's count set to 0 just
    before and read just after: 60, as on A in lanes_check), each row equal
    in every numeric field to the A grid's in this process; then one
    per-edge co-run on A-direct, which falls back to the scalar DES by name
    and equals the per-tier co-run on A (tests/test_fabric.py's degenerate
    identity)."""
    import torch

    from repro_torch.core.device_model import PLATFORMS
    from repro_torch.core.littles_law import OpClass
    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.batched.lane import partition_jobs, run_sweep_batched
    from repro_torch.memsim.sweep import SimJob, run_sweep
    from repro_torch.memsim.workloads import bw_test
    from repro_torch.scenarios import run_scenario

    grids = {}
    for platforms in (("A-direct", "B"), ("A", "B")):
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        fluid.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run_scenario("corun_sweep", {"platform": platforms}, device=dev).rows
        torch.cuda.synchronize()
        grids[platforms[0]] = dict(rows=rows, wall_s=time.perf_counter() - t0,
                                   k3_launches=fs.WINDOW_SOLVE_LAUNCHES.count,
                                   windows=fluid.COUNTS.windows)
    direct, plain = grids["A-direct"], grids["A"]
    diff = [i for i, (a, b) in enumerate(zip(direct["rows"], plain["rows"]))
            if {k: v for k, v in a.items() if k != "platform"}
            != {k: v for k, v in b.items() if k != "platform"}]

    def corun(platform, law, host):
        wls = [bw_test("ddr", OpClass.LOAD, 16, name="ddr", miku_managed=False, host=host),
               bw_test("cxl", OpClass.LOAD, 16, name="cxl", host=host)]
        return SimJob(platform=PLATFORMS[platform], workloads=wls, sim_ns=120_000.0,
                      miku=True, miku_law=law, record_windows=True)

    edge_job = corun("A-direct", "peredge", "host0")
    partition = partition_jobs([edge_job])
    t0 = time.perf_counter()
    (edge,) = run_sweep_batched([edge_job], device=dev, partition=partition)
    edge_wall = time.perf_counter() - t0
    (tier,) = run_sweep([corun("A", "pertier", None)], lane="scalar")
    mismatch = des_mismatches(edge, tier)
    emit("fabric_direct", cells=len(direct["rows"]), k3_launches=direct["k3_launches"],
         windows=direct["windows"], a_k3_launches=plain["k3_launches"],
         wall_s=direct["wall_s"], a_wall_s=plain["wall_s"], rows_differing=diff,
         identity_fallbacks=partition[1], identity_mismatches=mismatch,
         identity_decisions=len(edge.decisions), identity_wall_s=edge_wall,
         identity_gbps={w: edge.bandwidth(w) for w in edge.stats})
    check(len(direct["rows"]) == 96 and not diff,
          f"fabric_direct: rows {diff} differ from the A grid's")
    check(direct["k3_launches"] == direct["windows"] == 60,
          f"fabric_direct: {direct['k3_launches']} K3 launches for {direct['windows']} "
          "windows, not 60")
    check(partition[1] == [(0, "fabric_topology")],
          f"fabric_direct: the per-edge co-run's fallback {partition[1]}")
    check(not mismatch and edge.decisions and edge.fabric is None,
          f"fabric_direct: the per-edge co-run on A-direct differs from the per-tier one "
          f"on A in {mismatch}")
    return dict(k3_launches=direct["k3_launches"])


def open_loop_phase(dev):
    """Open-loop arrivals on the card's host: slo_knee's golden cell
    reproduces tests/data/slo_knee_trace_goldens.json's windows, slo_knee's
    20 rows and flash_crowd's rows keep their acceptance (run on the
    batched lane, whose arrival jobs fall back by name), and a mixed list of
    one arrival job beside two MIKU co-runs runs batched on the card: K3
    for the co-runs (its count set to 0 just before and read just after: 6),
    the fallback named "arrival", its result the scalar lane's."""
    import dataclasses as dc

    import torch

    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.batched.lane import partition_jobs, run_sweep_batched
    from repro_torch.memsim.sweep import SimJob, run_job, run_sweep
    from repro_torch.memsim.workloads import bw_test, serve_test
    from repro_torch.scenarios import plan, run_scenario
    from repro_torch.workload import ArrivalSpec

    with open(os.path.join(HERE, "tests", "data", "slo_knee_trace_goldens.json")) as f:
        blob = json.load(f)
    ((_, _, (job,)),) = plan("slo_knee", {"placement": blob["placement"],
                                          "policy": blob["policy"], "rate": blob["rate"]})
    t0 = time.perf_counter()
    res = run_job(dc.replace(job, record_windows=True))
    golden_wall = time.perf_counter() - t0
    got = [{k: v for k, v in r.items() if k != "latency_hist"} for r in res.window_records]
    golden_equal = json.loads(json.dumps(got)) == blob["windows"]
    rows, walls = {}, {}
    for name in ("slo_knee", "flash_crowd"):
        t0 = time.perf_counter()
        rows[name] = run_scenario(name, device=dev).rows
        walls[name] = time.perf_counter() - t0
    flash = {r["policy"]: r for r in rows["flash_crowd"]}

    p = platform_a()
    jobs = [SimJob(platform=p, workloads=[
        serve_test(4, arrival=ArrivalSpec("poisson", rate=0.01, seed=7), ddr_fraction=0.5),
        bw_test("cxl", OpClass.LOAD, 16, name="hog")], sim_ns=60_000.0, miku=True,
        record_windows=True, latency_hist=True)]
    for op in (OpClass.LOAD, OpClass.STORE):
        jobs.append(SimJob(platform=p, workloads=[
            bw_test("ddr", op, 16, name="ddr", miku_managed=False),
            bw_test("cxl", op, 16, name="cxl")], sim_ns=60_000.0, miku=True))
    partition = partition_jobs(jobs)
    fs.WINDOW_SOLVE_LAUNCHES.reset()
    fluid.COUNTS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_sweep_batched(jobs, device=dev, partition=partition)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, windows = fs.WINDOW_SOLVE_LAUNCHES.count, fluid.COUNTS.windows
    (scalar,) = run_sweep(jobs[:1], lane="scalar")
    diff = des_mismatches(results[0], scalar)
    emit("open_loop", golden_windows=len(blob["windows"]), golden_equal=golden_equal,
         golden_wall_s=golden_wall, rows=rows, walls_s=walls, fallbacks=partition[1],
         k3_launches=launches, windows=windows, mixed_wall_s=wall,
         fallback_equals_scalar=not diff, mismatches=diff, arrival=results[0].arrival,
         batched_gbps=[{w: r.bandwidth(w) for w in r.stats} for r in results[1:]],
         host_cpu=host_cpu())
    check(golden_equal, "open_loop: slo_knee's golden cell differs from "
          "slo_knee_trace_goldens.json")
    check(len(rows["slo_knee"]) == 20 and all(
        r["generated"] == r["issued"] + r["shed"] + r["backlog"] and r["issued"] > 0
        for r in rows["slo_knee"]), f"open_loop: slo_knee rows {rows['slo_knee']}")
    check(flash["miku"]["peak_queue_depth"] < flash["racing"]["peak_queue_depth"]
          and flash["miku"]["backlog"] == 0 < flash["racing"]["backlog"],
          f"open_loop: flash_crowd's acceptance fails on {flash}")
    check(partition[1] == [(0, "arrival")], f"open_loop: fallbacks {partition[1]}")
    check(not diff, f"open_loop: the fallback differs from the scalar run in {diff}")
    check(launches == windows == 6, f"open_loop: {launches} K3 launches for {windows} "
          "windows, not 6")
    check(all(_finite(r.bandwidth(w)) and r.bandwidth(w) > 0
              for r in results for w in r.stats),
          "open_loop: a job without a result")
    return dict(k3_launches=launches)


# -- the runtime sanitizer, the request and transfer tracers, the sweep CLI --

#: The reference's bound on the sanitizer's cost (tests/test_analysis.py's
#: test_sanitizer_overhead_is_bounded, a 500 us two-tier co-run):
#: sanitized wall < plain wall * 1.5 + 0.05 s.
SANITIZE_OVERHEAD_FACTOR = 1.5
SANITIZE_OVERHEAD_SLACK_S = 0.05
#: serve_traced's transfer tracer: every 4th chunk.
SERVE_TRACE_EVERY = 4


@contextlib.contextmanager
def sanitize_switch(value=None):
    """REPRO_SANITIZE set to ``value`` (if one is given) within, and on exit
    what it was before."""
    saved = os.environ.get("REPRO_SANITIZE")
    if value is not None:
        os.environ["REPRO_SANITIZE"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = saved


def des_parity_jobs():
    """The scalar lane's 18 parity jobs (tests/test_torch_des.py's CASES,
    built from the port's classes): flat and co-run bandwidth and latency
    tests, MIKU per tier and merged on three tiers, NUMA placement, LLC
    partitions, phases, telemetry, the three tiering policies, granularity
    1 and two seeds."""
    from repro_torch.core.des import WorkloadSpec
    from repro_torch.core.device_model import PLATFORMS as P
    from repro_torch.core.littles_law import OpClass as Op
    from repro_torch.memsim import workloads as w
    from repro_torch.memsim.sweep import SimJob
    from repro_torch.tiering import HotSetPattern, RegionSpec, TieringSpec

    def job(platform, workloads, sim_ns, **kw):
        return SimJob(platform=P[platform], workloads=workloads, sim_ns=sim_ns, **kw)

    def corun(op, **kw):
        return [w.bw_test("ddr", op, 16, name="ddr", miku_managed=False),
                w.bw_test("cxl", op, 16, name="cxl", **kw)]

    def spec(policy):
        return TieringSpec(regions=(RegionSpec(
            workload="app", n_pages=256, placement={"cxl": 1.0},
            pattern=HotSetPattern(hot_fraction=0.2, hot_weight=0.9, drift_pages=8.0)),),
            policy=policy, fast_capacity_pages=128)

    three = [w.bw_test("ddr", Op.LOAD, 8, name="ddr", miku_managed=False),
             w.bw_test("cxl", Op.LOAD, 8, name="cxl"),
             w.bw_test("cxl_sw", Op.LOAD, 8, name="sw")]
    app = [w.bw_test("ddr", Op.LOAD, 8, name="app")]
    return {
        "bw_ddr_load": job("A", [w.bw_test("ddr", Op.LOAD, 16)], 40_000.0),
        "bw_cxl_store": job("B", [w.bw_test("cxl", Op.STORE, 16)], 40_000.0),
        "lat_test": job("A", [w.lat_test("cxl", Op.LOAD, 2)], 40_000.0, granularity=1),
        "lat_share": job("A", [w.lat_share(4)], 30_000.0, granularity=1),
        "corun_racing": job("A", corun(Op.LOAD), 50_000.0),
        "corun_miku_pertier": job("A", corun(Op.STORE), 60_000.0, miku=True),
        "switch_merged": job("A-switch", list(three), 50_000.0, miku=True,
                             miku_law="merged"),
        "switch_pertier": job("A-switch", list(three), 50_000.0, miku=True),
        "numa_placement": job("A-numa", [
            WorkloadSpec(name="striped", op=Op.LOAD, tier="ddr", n_cores=8,
                         miku_managed=False,
                         placement={"ddr": 0.5, "ddr_remote": 0.3, "cxl": 0.2}),
            w.bw_test("cxl", Op.LOAD, 8, name="cxl")], 40_000.0, miku=True),
        "llc_partition": job("A", [
            w.bw_test("ddr", Op.LOAD, 8, name="hit", wss_mb=64.0, llc_alloc_mb=16.0),
            w.bw_test("cxl", Op.LOAD, 8, name="cxl")], 40_000.0),
        "alternating_phases": job("A", w.alternating_bw_pair(Op.LOAD, 8, 15_000.0),
                                  50_000.0, miku=True),
        "record_windows_hist": job("A", corun(Op.LOAD), 50_000.0, miku=True,
                                   record_windows=True, latency_hist=True),
        "tiering_static": job("A", list(app), 50_000.0, record_windows=True,
                              tiering=spec("static")),
        "tiering_hotness_lru": job("A-switch", list(app), 60_000.0, record_windows=True,
                                   tiering=spec("hotness_lru")),
        "tiering_miku_coordinated": job(
            "A", app + [w.bw_test("cxl", Op.LOAD, 8, name="cxl")], 60_000.0, miku=True,
            record_windows=True, tiering=spec("miku_coordinated")),
        "granularity_1": job("A", corun(Op.NT_STORE), 20_000.0, granularity=1),
        "seed_0": job("A", corun(Op.LOAD, ddr_fraction=0.3), 30_000.0, seed=0),
        "seed_3": job("A", corun(Op.LOAD, ddr_fraction=0.3), 30_000.0, seed=3),
    }


def sanitized_goldens():
    """The DES's pinned goldens through the runners scalar_lane, fabric and
    open_loop hold them with, under ``REPRO_SANITIZE=1`` (every sim they
    build is sanitized, raising on a violation): seed_fig_goldens.json's
    fig3 load column and fig5 load (rel 0.01, ToR inserts equal),
    miku_trace_des.json's 40 decisions, fabric_trace_goldens.json's spine
    co-run and slo_knee_trace_goldens.json's cell (equal).  Returns, per
    golden, whether it holds and its sanitizer summaries."""
    import dataclasses as dc

    from repro_torch.core.des import TieredMemorySim, run_bw_test, run_corun
    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.fabric import peredge_miku, spine_leaf_platform
    from repro_torch.memsim.calibration import default_miku
    from repro_torch.memsim.sweep import run_job
    from repro_torch.memsim.workloads import bw_test
    from repro_torch.scenarios import plan

    def load(name):
        with open(os.path.join(HERE, "tests", "data", name)) as f:
            return json.load(f)

    p = platform_a()
    gold, out, summaries = load("seed_fig_goldens.json"), {}, {}
    with sanitize_switch("1"):
        for row in gold["fig3"]:
            if row["op"] == "load":
                res = run_bw_test(p, op=OpClass.LOAD, tier=row["tier"], n_threads=16,
                                  sim_ns=120_000)
                got = res.bandwidth(f"bw-{row['tier']}-load")
                out[f"fig3_{row['tier']}"] = \
                    abs(got - row["bandwidth_gbps"]) / row["bandwidth_gbps"] <= GOLDENS_REL
                summaries[f"fig3_{row['tier']}"] = res.sanitizer
        g = gold["fig5"]["load"]
        res = run_corun(p, op=OpClass.LOAD, n_threads=16, sim_ns=300_000)
        out["fig5"] = res.tor_inserts == g["tor_inserts"] and all(
            abs(res.bandwidth(w) - g[f"{w}_gbps"]) / g[f"{w}_gbps"] <= GOLDENS_REL
            for w in ("ddr", "cxl"))
        summaries["fig5"] = res.sanitizer
        want = [w["decision"] for w in load("miku_trace_des.json")["windows"]]
        res = run_corun(p, op=OpClass.STORE, n_threads=16, sim_ns=400_000,
                        controller=default_miku(p))
        out["miku"] = [dict(max_concurrency=d.max_concurrency, rate_factor=d.rate_factor,
                            phase=d.phase.value) for d in res.decisions] == want
        summaries["miku"] = res.sanitizer
        blob = load("fabric_trace_goldens.json")
        pm, op, n = spine_leaf_platform(), OpClass(blob["op"]), blob["n_threads"]
        wls = [bw_test("ddr", op, n, name="ddr", miku_managed=False, host="host0"),
               bw_test("cxl", op, n, name="cxl0", host="host0"),
               bw_test("cxl", op, n, name="cxl1", host="host1")]
        res = TieredMemorySim(pm, wls, seed=0, granularity=4, controller=peredge_miku(pm, 4),
                              window_ns=blob["window_ns"], record_windows=True,
                              control_scope="edge").run(blob["sim_ns"])
        out["fabric"] = (res.window_records == blob["windows"]
                         and res.fabric == blob["fabric"]
                         and all(res.bandwidth(w) == bw
                                 for w, bw in blob["bandwidths"].items()))
        summaries["fabric"] = res.sanitizer
        blob = load("slo_knee_trace_goldens.json")
        ((_, _, (job,)),) = plan("slo_knee", {"placement": blob["placement"],
                                              "policy": blob["policy"], "rate": blob["rate"]})
        res = run_job(dc.replace(job, record_windows=True))
        got = [{k: v for k, v in r.items() if k != "latency_hist"} for r in res.window_records]
        out["slo_knee"] = json.loads(json.dumps(got)) == blob["windows"]
        summaries["slo_knee"] = res.sanitizer
    return out, summaries


def sanitize_des(smi: str):
    """The runtime sanitizer on the card's host.  The scalar lane's 18
    parity jobs run with ``sanitize=True`` and without: every stat, the
    ToR inserts and the decisions equal, no violation, the windows each
    checked printed.  The pinned goldens hold with every sim sanitized.
    The reference's 500 us two-tier co-run, plain and sanitized, three
    times each, interleaved (the host's walls spread): the overhead ratio
    of the best walls and the reference's own bound on it."""
    import dataclasses as dc

    from repro_torch.core.des import TieredMemorySim
    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.memsim.sweep import run_job
    from repro_torch.memsim.workloads import bw_test

    t0 = time.perf_counter()
    jobs, mism, checked, violations = des_parity_jobs(), {}, {}, {}
    for name, job in jobs.items():
        plain = run_job(job)
        san = run_job(dc.replace(job, sanitize=True))
        mism[name] = des_mismatches(san, plain)
        checked[name] = san.sanitizer["windows_checked"]
        violations[name] = san.sanitizer["violations"]
    jobs_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    goldens, summaries = sanitized_goldens()
    goldens_wall = time.perf_counter() - t0
    p = platform_a()
    wls = [bw_test("ddr", OpClass.LOAD, 16), bw_test("cxl", OpClass.LOAD, 16)]
    walls = {"plain": [], "sanitized": []}
    for _ in range(3):
        for key, sanitize in (("plain", False), ("sanitized", True)):
            t0 = time.perf_counter()
            TieredMemorySim(p, wls, seed=0, sanitize=sanitize).run(500_000.0)
            walls[key].append(time.perf_counter() - t0)
    plain_s, san_s = min(walls["plain"]), min(walls["sanitized"])
    bound_s = plain_s * SANITIZE_OVERHEAD_FACTOR + SANITIZE_OVERHEAD_SLACK_S
    emit("sanitize_des", jobs=len(jobs), jobs_wall_s=jobs_wall,
         mismatches={k: v for k, v in mism.items() if v}, windows_checked=checked,
         violations={k: v for k, v in violations.items() if v}, goldens=goldens,
         golden_windows_checked={k: s["windows_checked"] for k, s in summaries.items()},
         golden_violations={k: s["violations"] for k, s in summaries.items()
                            if s["violations"]},
         goldens_wall_s=goldens_wall, overhead_config="2 x 16-thread load bw-tests, 500 us",
         overhead_walls_s=walls, overhead_ratio=san_s / plain_s, overhead_bound_s=bound_s,
         host_cpu=host_cpu(), card=smi)
    check(not any(mism.values()), f"sanitize_des: sanitized jobs differ in {mism}")
    check(not any(violations.values()), f"sanitize_des: violations {violations}")
    check(all(checked.values()), f"sanitize_des: a job checked no window: {checked}")
    check(all(goldens.values()), f"sanitize_des: sanitized goldens {goldens}")
    check(not any(s["violations"] for s in summaries.values()),
          f"sanitize_des: violations on the goldens {summaries}")
    check(san_s < bound_s, f"sanitize_des: sanitized {san_s:.3f} s against plain "
          f"{plain_s:.3f} s, over the bound {bound_s:.3f} s")


def trace_des(smi: str):
    """Request tracing on the card's host.  The spine co-run traced at
    every 997th admission (64 at most): its Chrome export equals
    tests/data/spine_perfetto_golden.json.  A MIKU co-run traced at 16,
    with latency histograms, the phase profile and window records: every
    stat, counter and decision equal to the plain run's, and its spans
    conserve the ToR residency.  Prints the traced request counts."""
    import dataclasses as dc

    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.memsim.sweep import SimJob, run_job
    from repro_torch.memsim.workloads import bw_test
    from repro_torch.obs import TraceConfig, default_registry, to_chrome
    from repro_torch.scenarios import get

    cell = {"op": OpClass.LOAD, "law": "peredge", "n_threads": 16, "spine_slots": 8,
            "spine_service_ns": 36.0, "sim_ns": 120_000.0}
    corun = get("fabric_spine_congestion").build(None, cell)[2]
    counter = default_registry().counter("des.traced_requests")
    before = counter.value
    t0 = time.perf_counter()
    spine = run_job(dc.replace(corun, trace=TraceConfig(sample_every=997, limit=64)))
    spine_wall = time.perf_counter() - t0
    with open(os.path.join(HERE, "tests", "data", "spine_perfetto_golden.json")) as f:
        golden = json.load(f)
    golden_equal = to_chrome(spine.trace["requests"]) == golden

    p = platform_a()
    job = SimJob(platform=p, workloads=[
        bw_test("ddr", OpClass.LOAD, 16, name="ddr", miku_managed=False),
        bw_test("cxl", OpClass.LOAD, 16, name="cxl")], sim_ns=150_000.0, miku=True)
    t0 = time.perf_counter()
    plain = run_job(job)
    plain_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    instr = run_job(dc.replace(job, trace=16, latency_hist=True, profile=True,
                               record_windows=True))
    instr_wall = time.perf_counter() - t0
    diff = [m for m in des_mismatches(instr, plain) if m != "window_records"]
    bad_spans = [i for i, rec in enumerate(instr.trace["requests"]) if not spans_conserve(rec)]
    hist_n = {w: instr.stats[w].latency_hist.n for w in instr.stats}
    emit("trace_des", spine_golden_equal=golden_equal, spine_traced=spine.trace["n_traced"],
         spine_wall_s=spine_wall, corun_traced=instr.trace["n_traced"],
         corun_in_flight=instr.trace["n_in_flight"], corun_dropped=instr.trace["n_dropped"],
         traced_requests_counter=counter.value - before, mismatches=diff,
         spans_not_conserving=bad_spans, latency_hist_n=hist_n,
         window_records=len(instr.window_records),
         profile_phases=sorted(instr.profile["phases"]), plain_wall_s=plain_wall,
         instrumented_wall_s=instr_wall, host_cpu=host_cpu(), card=smi)
    check(golden_equal, "trace_des: the spine co-run's trace differs from "
          "spine_perfetto_golden.json")
    check(spine.trace["n_traced"] == 64, f"trace_des: spine traced {spine.trace['n_traced']}")
    check(not diff, f"trace_des: the instrumented co-run differs from the plain one in {diff}")
    check(instr.trace["n_traced"] > 0 and not bad_spans,
          f"trace_des: {instr.trace['n_traced']} traced, spans not conserving {bad_spans}")
    check(counter.value - before == spine.trace["n_traced"] + instr.trace["n_traced"],
          "trace_des: des.traced_requests does not count the traced requests")
    check(all(hist_n[w] == instr.stats[w].latency_count for w in hist_n),
          f"trace_des: histograms {hist_n} miss completions")


def spans_conserve(rec, tol=1e-6) -> bool:
    """A finalized span record partitions [t_tor, t_retire] (after its IRQ
    wait): contiguous, non-negative spans, enqueue <= ToR <= retire."""
    spans = rec["spans"]
    if not spans or not rec["t_issue"] <= rec["t_tor"] <= rec["t_retire"]:
        return False
    t = rec["t_issue"] if spans[0]["kind"] == "irq" else rec["t_tor"]
    for sp in spans:
        if abs(sp["t0"] - t) > tol or sp["t1"] < sp["t0"]:
            return False
        t = sp["t1"]
    return abs(t - rec["t_retire"]) <= tol


def obs_fallback(dev):
    """A mixed list on the card: two MIKU co-runs that stack, beside a
    sanitized co-run and a traced one.  The two fall back as "sanitize"
    and "trace" and each equals its scalar run; K3 runs the two co-runs
    (its count set to 0 just before and read just after), as many times as
    for those two alone."""
    import dataclasses as dc

    import torch

    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.batched.lane import partition_jobs, run_sweep_batched
    from repro_torch.memsim.sweep import SimJob, run_sweep
    from repro_torch.memsim.workloads import bw_test

    p = platform_a()
    # sanitize=False: batchable whatever REPRO_SANITIZE says.
    co = [SimJob(platform=p, workloads=[
        bw_test("ddr", op, 16, name="ddr", miku_managed=False),
        bw_test("cxl", op, 16, name="cxl")], sim_ns=60_000.0, miku=True, sanitize=False)
        for op in (OpClass.LOAD, OpClass.STORE, OpClass.NT_STORE)]
    jobs = [co[0], dc.replace(co[2], sanitize=True), co[1],
            dc.replace(co[0], trace=16, record_windows=True)]
    fs.WINDOW_SOLVE_LAUNCHES.reset()
    run_sweep_batched(co[:2], device=dev)
    torch.cuda.synchronize()
    alone = fs.WINDOW_SOLVE_LAUNCHES.count
    partition = partition_jobs(jobs)
    fs.WINDOW_SOLVE_LAUNCHES.reset()
    fluid.COUNTS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_sweep_batched(jobs, device=dev, partition=partition)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, windows = fs.WINDOW_SOLVE_LAUNCHES.count, fluid.COUNTS.windows
    scalar = run_sweep([jobs[1], jobs[3]], lane="scalar")
    diff = {i: des_mismatches(results[i], s) for i, s in zip((1, 3), scalar)}
    extra = dict(sanitizer=results[1].sanitizer == scalar[0].sanitizer,
                 trace=results[3].trace == scalar[1].trace)
    emit("obs_fallback", jobs=len(jobs), fallbacks=partition[1], k3_launches=launches,
         k3_launches_batched_alone=alone, windows=windows, wall_s=wall,
         mismatches=diff, payloads_equal=extra,
         sanitizer_windows_checked=results[1].sanitizer["windows_checked"],
         traced=results[3].trace["n_traced"],
         batched_gbps=[{w: results[i].bandwidth(w) for w in results[i].stats}
                       for i in (0, 2)])
    check(partition[1] == [(1, "sanitize"), (3, "trace")],
          f"obs_fallback: fallbacks {partition[1]}")
    check(not any(diff.values()) and all(extra.values()),
          f"obs_fallback: a fallback differs from its scalar run: {diff}, {extra}")
    check(results[1].sanitizer["violations"] == [], "obs_fallback: sanitizer violations")
    check(launches == alone == windows == 6,
          f"obs_fallback: {launches} K3 launches ({alone} for the co-runs alone, "
          f"{windows} windows), not 6")
    check(all(_finite(r.bandwidth(w)) and r.bandwidth(w) > 0 for r in results
              for w in r.stats), "obs_fallback: a job without a result")
    return dict(k3_launches=launches)


def serve_traced(dev, params, untraced, smi: str):
    """The serve phase's cluster again on its parameters (the weights are
    not drawn again), built with ``trace=4`` under ``REPRO_SANITIZE=1``:
    greedy tokens, result dict and timeline equal to the untraced run's,
    no violation from the transfer queue's sanitizer, the sampled chunks'
    spans conserving (enqueue <= service <= complete), as many as every
    4th chunk up to the tracer's limit, and K1 32 times a decode step (its
    count set to 0 just before the run and read just after)."""
    import torch

    from repro_torch.kernels import decode_attention as k1
    from repro_torch.launch.serve import build_cluster

    with sanitize_switch("1"):
        cluster = build_cluster("llama31-8b", full=True, n_requests=4, max_new=8,
                                mode="miku", device=dev, params=params,
                                trace=SERVE_TRACE_EVERY)
        q = cluster.queue
        k1.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.run(max_ticks=10**9)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = k1.LAUNCHES.count
    hbm, host = cluster.engines
    cfg = hbm.cfg.model
    steps = hbm.decode_steps + host.decode_steps
    tokens = {e.cfg.name: sorted((r.rid, list(r.output)) for r in e.done)
              for e in cluster.engines}
    tracer = q._tracer
    recs = q.trace_records
    want_recs = min(tracer.limit, (tracer.count - 1) // tracer.every + 1)
    ordered = all(r["t_issue"] <= r["spans"][-1]["t0"] <= r["t_retire"] for r in recs)
    san = q._san.summary()
    emit("serve_traced", trace_every=SERVE_TRACE_EVERY, sanitize="REPRO_SANITIZE=1",
         tokens_equal=tokens == untraced["tokens"], result_equal=res == untraced["res"],
         timeline_equal=cluster.timeline == untraced["timeline"],
         timeline_ticks=len(cluster.timeline), timeline_runs=len(cluster.timeline._runs),
         chunks=tracer.count, trace_records=len(recs), trace_records_expected=want_recs,
         spans_ordered=ordered, spans_conserving=all(spans_conserve(r) for r in recs),
         sanitizer=dict(san, violations=len(san["violations"])), wall_s=wall_s,
         untraced_wall_s=untraced["wall_s"], k1_launches=launches,
         layers_x_decode_steps=cfg.n_layers * steps, card=smi)
    check(tokens == untraced["tokens"], "serve_traced: greedy tokens differ from the serve run")
    check(res == untraced["res"], f"serve_traced: result {res} != {untraced['res']}")
    check(cluster.timeline == untraced["timeline"],
          "serve_traced: the timeline differs from the untraced run's")
    check(san["violations"] == [] and san["submitted"] == {"slow": tracer.count},
          f"serve_traced: the queue's sanitizer reports {san}")
    check(len(recs) == want_recs > 0 and ordered and all(spans_conserve(r) for r in recs),
          f"serve_traced: {len(recs)} transfer records for {tracer.count} chunks")
    check(launches == cfg.n_layers * steps and launches > 0,
          f"serve_traced: K1 launches {launches} != layers x decode steps "
          f"{cfg.n_layers * steps}")
    return dict(k1_launches=launches)


def sweep_cli(smi: str):
    """``python -m repro_torch.launch.sweep fabric_spine_congestion
    --sanitize --perfetto NAME`` in this process: it writes
    NAME.perfetto.json in ``to_chrome``'s schema (one process per cell, job
    and workload); an unknown name exits with code 2 and names the near
    miss on stderr.  The environment switch is restored after."""
    import io

    from repro_torch.launch import sweep as cli

    out, err = io.StringIO(), io.StringIO()
    with sanitize_switch():
        with tempfile.TemporaryDirectory() as tmp:
            name = os.path.join(tmp, "spine")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                cli.main(["fabric_spine_congestion", "--sanitize", "--perfetto", name])
            wall = time.perf_counter() - t0
            sanitize_set = os.environ.get("REPRO_SANITIZE") == "1"
            with open(f"{name}.perfetto.json") as f:
                doc = json.load(f)
        bad, code = io.StringIO(), None
        with contextlib.redirect_stderr(bad):
            try:
                cli.main(["fabric_spine_congstion"])
            except SystemExit as ex:
                code = ex.code
    events = doc["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    procs = sorted(e["args"]["name"] for e in events if e["name"] == "process_name")
    schema = (doc["displayTimeUnit"] == "ns" and spans
              and all({"name", "cat", "ts", "dur", "pid", "tid", "args"} <= set(e)
                      and e["ts"] >= 0 and e["dur"] >= 0 for e in spans)
              and all({"name", "ph", "pid", "tid", "args"} <= set(e) for e in events))
    rows = out.getvalue().splitlines()
    emit("sweep_cli", argv="fabric_spine_congestion --sanitize --perfetto NAME",
         wall_s=wall, rows=rows, sanitize_set=sanitize_set, trace_events=len(events),
         spans=len(spans), processes=procs, schema_ok=bool(schema),
         unknown_exit_code=code, unknown_stderr=bad.getvalue().splitlines()[:1],
         host_cpu=host_cpu(), card=smi)
    check(len(rows) == 3 and sanitize_set, f"sweep_cli: rows {rows}")
    check(schema and procs and all(p.startswith("cell") for p in procs),
          f"sweep_cli: the Chrome trace's schema: {procs}")
    check(code == 2 and "did you mean: fabric_spine_congestion?" in bad.getvalue(),
          f"sweep_cli: unknown scenario exit {code}, stderr {bad.getvalue()[:200]}")

    # The result table's formats, the profile and the catalog.
    import csv

    from repro_torch.scenarios.catalog import catalog_md

    def cli_run(argv):
        o, e, rc = io.StringIO(), io.StringIO(), 0
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            try:
                cli.main(argv)
            except SystemExit as ex:
                rc = ex.code
        return rc, o.getvalue(), e.getvalue()

    argv = ["fig4_latency", "--set", "threads=1,4"]
    t0 = time.perf_counter()
    _, csv_out, _ = cli_run(argv)
    _, json_out, prof_err = cli_run(argv + ["--format", "json", "--profile"])
    _, md, _ = cli_run(["--list", "--format", "md"])
    md_code, _, md_err = cli_run(["fig4_latency", "--format", "md"])
    formats_wall = time.perf_counter() - t0
    doc = json.loads(json_out)
    csv_rows = list(csv.DictReader(io.StringIO(csv_out)))
    json_as_csv = [{k: str(v) for k, v in r.items()} for r in doc["rows"]]
    prof_line = next((line for line in prof_err.splitlines() if line.startswith("profile: ")),
                     "profile: {}")
    phases = sorted(json.loads(prof_line[len("profile: "):]).get("phases", {}))
    emit("sweep_cli", argv="fig4_latency --set threads=1,4 [--format json --profile]",
         rows=len(doc["rows"]), json_rows_equal_csv=json_as_csv == csv_rows,
         profile_phases=phases, metrics_on_stderr="metrics: " in prof_err,
         catalog_md_equal=md == catalog_md(), catalog_bytes=len(md),
         format_md_exit_code=md_code, format_md_stderr=md_err.splitlines()[-1:],
         wall_s=formats_wall)
    check(json_as_csv == csv_rows and len(csv_rows) == 4,
          f"sweep_cli: --format json's rows differ from the csv's: {doc['rows']}")
    check(phases == ["plan", "reduce", "sweep"] and "metrics: " in prof_err,
          f"sweep_cli: --profile wrote {prof_err[:300]}")
    check(md == catalog_md(), "sweep_cli: --list --format md differs from catalog_md()")
    check(md_code == 2, f"sweep_cli: --format md without --list exited {md_code}")


# -- the scenario result API, the figure runners, the TPU-unit platform, the
# -- decision-law replay and tier placement ------------------------------------


def result_table(dev):
    """``run_scenario("corun_sweep_1k", profile=True)`` on the card returns a
    ResultTable: the batched lane ran every job (0 fallbacks), K3 launched 20
    times (its count set to 0 just before and read just after, as in the
    sweep phase), the profile's plan, sweep and reduce sum to no more than
    the wall, the metrics snapshot's ``sweep.jobs`` rose by the job count,
    ``to_csv`` has a line a row and a header, ``to_json``'s rows are the
    rows.  Then a short grid whose A-spine cells fall back
    ("fabric_topology"): its ``fallback_reason_counts`` equal partition_jobs'
    fallbacks counted after the run.  The same grid under
    ``REPRO_BATCH_BLOCK=1`` runs each batched cell as a group of its own:
    K3 launches once a window of each (more than the grid's default run),
    the meta is unchanged and the rows agree within rel 1e-12 (float64
    cells solved alone)."""
    import torch

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.memsim.batched.lane import partition_jobs
    from repro_torch.obs.metrics import default_registry
    from repro_torch.scenarios import ResultTable, plan, run_scenario

    jobs = sum(len(js) for _, _, js in plan("corun_sweep_1k"))
    before = default_registry().counter("sweep.jobs").value
    fs.WINDOW_SOLVE_LAUNCHES.reset()
    fluid.COUNTS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = run_scenario("corun_sweep_1k", profile=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, windows = fs.WINDOW_SOLVE_LAUNCHES.count, fluid.COUNTS.windows
    meta = table.meta
    phases = {k: v["seconds"] for k, v in meta["profile"]["phases"].items()}
    rose = meta["metrics"]["counters"]["sweep.jobs"] - before
    csv_lines = table.to_csv().count("\n")
    json_rows = json.loads(table.to_json())["rows"]

    mixed = {"platform": ("A", "A-spine"), "op": "load", "threads": (2, 16), "mlp": (160,),
             "sim_ns": 60_000.0}
    mixed_jobs = [j for _, _, js in plan("corun_sweep", mixed) for j in js]
    fs.WINDOW_SOLVE_LAUNCHES.reset()
    t0 = time.perf_counter()
    grid = run_scenario("corun_sweep", mixed)
    torch.cuda.synchronize()
    mixed_wall = time.perf_counter() - t0
    mixed_launches = fs.WINDOW_SOLVE_LAUNCHES.count
    prev_block = os.environ.pop("REPRO_BATCH_BLOCK", None)
    os.environ["REPRO_BATCH_BLOCK"] = "1"
    try:
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        fluid.COUNTS.reset()
        chunked = run_scenario("corun_sweep", mixed)
        torch.cuda.synchronize()
    finally:
        del os.environ["REPRO_BATCH_BLOCK"]
        if prev_block is not None:
            os.environ["REPRO_BATCH_BLOCK"] = prev_block
    chunk_launches, chunk_windows = fs.WINDOW_SOLVE_LAUNCHES.count, fluid.COUNTS.windows
    chunk_errs = _row_errors(chunked.rows, grid.rows)
    partition = partition_jobs(mixed_jobs)
    counts = {}
    for _, reason in partition[1]:
        counts[reason] = counts.get(reason, 0) + 1
    emit("result_table", scenario="corun_sweep_1k", jobs=jobs, rows=len(table.rows),
         meta={k: v for k, v in meta.items() if k not in ("profile", "metrics")},
         profile_phases_s=phases, profile_sum_s=sum(phases.values()), wall_s=wall,
         sweep_jobs_rose=rose, k3_launches=launches, windows=windows,
         csv_lines=csv_lines, json_rows_equal=json_rows == table.rows,
         columns=table.columns, fallback_grid=dict(
             jobs=len(mixed_jobs), meta=grid.meta, partition_counts=counts,
             k3_launches=mixed_launches, wall_s=mixed_wall),
         block_1=dict(k3_launches=chunk_launches, windows=chunk_windows,
                      meta_equal=chunked.meta == grid.meta,
                      rows_bit_equal=chunked.rows == grid.rows,
                      worst_rel_err=max(chunk_errs)))
    check(isinstance(table, ResultTable) and meta["lane"] == "batched"
          and meta["batched_jobs"] == jobs == len(table.rows)
          and meta["scalar_fallback_jobs"] == 0 and meta["fallback_reason_counts"] == {},
          f"result_table: meta {meta}")
    check(launches == windows == 20, f"result_table: {launches} K3 launches for {windows} "
          "windows, not 20")
    check(set(phases) == {"plan", "sweep", "reduce"} and sum(phases.values()) <= wall,
          f"result_table: profile {phases} against the wall {wall}")
    check(rose == jobs, f"result_table: sweep.jobs rose by {rose}, not {jobs}")
    check(csv_lines == len(table.rows) + 1 and json_rows == table.rows,
          "result_table: to_csv / to_json do not hold the rows")
    check(grid.meta["fallback_reason_counts"] == counts == {"fabric_topology": 4}
          and grid.meta["batched_jobs"] == 4 and mixed_launches > 0,
          f"result_table: the fallback grid's meta {grid.meta}, partition {counts}")
    check(chunk_launches == chunk_windows and chunk_launches > mixed_launches
          and chunked.meta == grid.meta and max(chunk_errs) <= 1e-12,
          f"result_table: REPRO_BATCH_BLOCK=1 gave {chunk_launches} K3 launches for "
          f"{chunk_windows} windows (default block {mixed_launches}), meta "
          f"{chunked.meta}, worst rel err {max(chunk_errs)}")
    return dict(k3_launches=launches + mixed_launches + chunk_launches)


def _row_errors(got, want):
    """Relative errors of every numeric field of two row lists (non-numeric
    fields must be equal: a mismatch is an infinite error)."""
    errs = []
    for g, w in zip(got, want):
        if set(g) != set(w):
            return [float("inf")]
        for k, v in w.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                errs.append(0.0 if g[k] == v else float("inf"))
            else:
                errs.append(abs(g[k] - v) / max(abs(v), 1e-9))
    return errs if len(got) == len(want) else [float("inf")]


def runner_figs(dev, plain):
    """Every wrapper of ``memsim/runner.py`` on the card, at the figures
    phase's horizons (the scenarios' defaults), K3's count set to 0 just
    before each and read just after.  Each wrapper's rows are held against
    the same cells of the figures' plain lane (the float64 solver on the
    CPU, from the workers) by the figures' gate: the p95 relative error of
    the numeric fields within SWEEP1K_P95_BOUND.  That a wrapper returns
    ``run_scenario``'s rows less its dropped keys is
    tests/test_torch_runner.py's check.  ``tiering_schemes`` runs fig2, whose cells are
    scalar DES runs on the host; ``miku_comparison(A, STORE)``'s
    ``miku_ddr_frac_of_opt`` is printed."""
    import torch

    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim import runner

    pm = platform_a()
    store = OpClass.STORE

    def on_a(name, keep=lambda r: True):
        return [{k: v for k, v in r.items() if k != "platform"}
                for r in plain[name]["rows"] if r["platform"] == "A" and keep(r)]

    # wrapper, its call, the scenario it runs, the plain lane's rows of the
    # same cells (None: no plain lane)
    cases = [
        ("bandwidth_matrix", lambda: runner.bandwidth_matrix(pm), "fig3_bandwidth",
         on_a("fig3_bandwidth")),
        ("latency_matrix", lambda: runner.latency_matrix(pm), "fig4_latency",
         on_a("fig4_latency")),
        ("corun_matrix", lambda: runner.corun_matrix(pm), "fig5_corun", on_a("fig5_corun")),
        ("tor_insert_bandwidth_correlation",
         lambda: [{"pearson_r": runner.tor_insert_bandwidth_correlation(pm)}],
         "fig6_tor_correlation",
         [{"pearson_r": r["pearson_r"]} for r in on_a("fig6_tor_correlation")]),
        ("llc_partition_sweep", lambda: runner.llc_partition_sweep(pm, 60.0), "fig7_llc",
         on_a("fig7_llc", lambda r: r["wss_mb"] == 60.0)),
        ("sync_interference", lambda: runner.sync_interference(pm), "fig8_sync",
         on_a("fig8_sync")),
        ("service_time_curve", lambda: runner.service_time_curve(pm), "fig9_service",
         on_a("fig9_service")),
        ("miku_comparison", lambda: [dataclasses.asdict(runner.miku_comparison(pm, store))],
         "fig10_miku", on_a("fig10_miku", lambda r: r["op"] == "store")),
        ("pertier_comparison", lambda: runner.pertier_comparison(), "corun3_pertier",
         list(plain["corun3_pertier"]["rows"])),
        ("tiering_schemes", lambda: [runner.tiering_schemes(pm, OpClass.LOAD)],
         "fig2_tiering", None),
    ]
    total, rows_out, frac = 0, {}, None
    for name, call, scenario, plain_rows in cases:
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fs.WINDOW_SOLVE_LAUNCHES.count
        errs = sorted(_row_errors(got, plain_rows)) if plain_rows is not None else [0.0]
        p95 = errs[int(0.95 * (len(errs) - 1))]
        row = dict(wrapper=name, scenario=scenario, rows=len(got), wall_s=wall,
                   k3_launches=launches,
                   plain_lane_p95_rel_err=p95, plain_lane_worst_rel_err=errs[-1],
                   plain_lane="figures' CPU workers" if plain_rows is not None
                   else "none (scalar DES cells)")
        if name == "miku_comparison":
            frac = runner.MikuComparison(**got[0]).miku_ddr_frac_of_opt
            row["miku_ddr_frac_of_opt"] = frac
        emit("runner_figs", **row)
        check(p95 <= SWEEP1K_P95_BOUND, f"runner_figs {name}: p95 {p95} against the plain lane")
        check(all(_finite(v) for r in got for v in r.values() if isinstance(v, float)),
              f"runner_figs {name}: non-finite rows")
        total += launches
        rows_out[name] = len(got)
    emit("runner_figs", wrapper="all", k3_launches=total, rows=rows_out,
         miku_ddr_frac_of_opt=frac, p95_bound=SWEEP1K_P95_BOUND)
    check(total > 0, "runner_figs: no K3 launch")
    return dict(k3_launches=total)


def tpu_platform(dev):
    """The reference's simulated TPU host (``PLATFORMS["TPU"]``: 512 B
    bursts, 512 ToR entries), the first non-cacheline platform K3 solves:
    fig3_bandwidth and fig5_corun at ``platform=TPU`` on the batched lane on
    the card (K3's count set to 0 just before and read just after, the
    instances it ran) and on the scalar DES on the card's host (serially:
    21 short jobs), held against each other by lanes_check's bounds (worst
    and mean relative error over the bandwidth columns)."""
    import torch

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.scenarios import run_scenario

    total, errs = 0, []
    for name in ("fig3_bandwidth", "fig5_corun"):
        shapes = set()
        solve = fluid.kernel.fused_window_solve

        def record_solve(*args):
            shapes.add(tuple(args[3].shape))
            return solve(*args)

        fluid.kernel.fused_window_solve = record_solve
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        fluid.COUNTS.reset()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched = run_scenario(name, {"platform": "TPU"})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            fluid.kernel.fused_window_solve = solve
        launches, windows = fs.WINDOW_SOLVE_LAUNCHES.count, fluid.COUNTS.windows
        t0 = time.perf_counter()
        scalar = run_scenario(name, {"platform": "TPU"}, lane="scalar")
        scalar_wall = time.perf_counter() - t0
        e = [abs(b[k] - s[k]) / max(s[k], 1e-9) for b, s in zip(batched.rows, scalar.rows)
             for k in s if k.endswith("_gbps")]
        errs += e
        instances = sorted({fs.window_solve_instance(W, S) for _, W, S in shapes})
        emit("tpu_platform", scenario=name, rows=len(batched.rows), meta=batched.meta,
             k3_launches=launches, windows=windows,
             k3_groups=[dict(C=C, W=W, S=S) for C, W, S in sorted(shapes)],
             k3_instances=[f"<{w}, {s}>" for w, s in instances], wall_s=wall,
             scalar_wall_s=scalar_wall,
             worst_rel_err=max(e), mean_rel_err=sum(e) / len(e),
             bandwidths=[{k: (b[k], s[k]) for k in s if k.endswith("_gbps")}
                         for b, s in zip(batched.rows, scalar.rows)],
             host_cpu=host_cpu())
        check(batched.meta["scalar_fallback_jobs"] == 0 and launches == windows > 0,
              f"tpu_platform {name}: {launches} K3 launches for {windows} windows, "
              f"meta {batched.meta}")
        check(len(batched.rows) == len(scalar.rows) and all(
            {k: v for k, v in b.items() if not isinstance(v, float)}
            == {k: v for k, v in s.items() if not isinstance(v, float)}
            for b, s in zip(batched.rows, scalar.rows)), f"tpu_platform {name}: rows differ")
        total += launches
    worst, mean = max(errs), sum(errs) / len(errs)
    emit("tpu_platform", scenario="all", k3_launches=total, worst_rel_err=worst,
         mean_rel_err=mean, worst_bound=LANES_WORST_BOUND, mean_bound=LANES_MEAN_BOUND)
    check(worst < LANES_WORST_BOUND and mean < LANES_MEAN_BOUND,
          f"tpu_platform: worst {worst}, mean {mean} against the scalar DES")
    return dict(k3_launches=total)


def replay_phase(smi: str):
    """The decision-law proof on the card's host: ReplaySubstrate replays
    tests/data's four recorded counter traces through the port's
    ControlLoop and default_miku (merged_miku for the merged trace) and
    reproduces every golden decision; a live MIKU co-run's own window
    deltas, replayed through a fresh controller, give its live decisions."""
    from repro_torch.core.des import TieredMemorySim
    from repro_torch.core.device_model import platform_a, platform_a_switch
    from repro_torch.core.littles_law import OpClass, TierCounters, TierWindow
    from repro_torch.core.substrate import ControlLoop, ReplaySubstrate
    from repro_torch.memsim.calibration import default_miku, merged_miku
    from repro_torch.memsim.workloads import bw_test

    def counters(d):
        return TierCounters(inserts=d["inserts"], occupancy_time=d["occupancy_time"],
                            class_counts={OpClass(k): v for k, v in d["class_counts"].items()})

    def replay(deltas, law):
        sub = ReplaySubstrate(deltas)
        loop = ControlLoop(sub, law, window_ns=1.0)
        while not sub.exhausted:
            loop.fire()
        return loop.decisions, sub.applied == loop.decisions

    def triple(d):
        return (d.max_concurrency, d.rate_factor, d.phase.value)

    data = os.path.join(HERE, "tests", "data")
    out, ok = {}, True
    t0 = time.perf_counter()
    for name in ("miku_trace_des.json", "miku_trace_tq.json"):
        with open(os.path.join(data, name)) as f:
            windows = json.load(f)["windows"]
        got, applied = replay([(counters(w["fast"]), counters(w["slow"])) for w in windows],
                              default_miku(platform_a()))
        equal = [triple(d) for d in got] == [
            (w["decision"]["max_concurrency"], w["decision"]["rate_factor"],
             w["decision"]["phase"]) for w in windows]
        out[name] = dict(windows=len(windows), equal=equal, applied=applied)
        ok &= equal and applied
    for law in ("pertier", "merged"):
        name = f"pertier_trace_{law}.json"
        with open(os.path.join(data, name)) as f:
            blob = json.load(f)
        names = tuple(blob["tier_names"])
        build = default_miku if law == "pertier" else merged_miku
        got, applied = replay([TierWindow(tuple(counters(w["tiers"][t]) for t in names),
                                          names) for w in blob["windows"]],
                              build(platform_a_switch()))
        equal = len(got) == len(blob["windows"]) and all(
            d.tiers == names[1:] and all(
                triple(d.for_tier(t)) == tuple(w["decision"][t][k] for k in (
                    "max_concurrency", "rate_factor", "phase")) for t in names[1:])
            for d, w in zip(got, blob["windows"]))
        out[name] = dict(windows=len(blob["windows"]), equal=equal, applied=applied)
        ok &= equal and applied
    p = platform_a()
    wls = [bw_test("ddr", OpClass.STORE, 16, name="ddr", miku_managed=False),
           bw_test("cxl", OpClass.STORE, 16, name="cxl")]
    sim = TieredMemorySim(p, wls, seed=0, controller=default_miku(p), window_ns=10_000.0,
                          record_windows=True)
    res = sim.run(400_000.0)
    got, applied = replay([rec.delta for rec in sim.control.records], default_miku(p))
    live_equal = [[triple(x) for x in d.decisions] for d in got] == \
        [[triple(x) for x in d.decisions] for d in res.decisions]
    restricted = sum(d.restricted for d in res.decisions)
    wall = time.perf_counter() - t0
    emit("replay", traces=out, live_windows=len(res.decisions), live_equal=live_equal,
         live_restricted_windows=restricted, wall_s=wall, host_cpu=host_cpu(), card=smi)
    check(ok, f"replay: a recorded trace's decisions differ: {out}")
    check(live_equal and applied and restricted > 0,
          f"replay: the live co-run's deltas replay to other decisions ({restricted} "
          "restricted windows)")


def tiers_phase(dev):
    """Tier placement on the card: ``put_on_tier`` to HOST_TIER gives a
    pinned CPU tensor, to HBM_TIER a CUDA tensor, and the round trip of the
    cold part of a llama31-8b KV cache (TieredLayout: 8,192 tokens, the hot
    2,048 on the card, 2,048-token pages; 32 layers, 8 KV heads of 128, bf16)
    is bit-equal; each direction's copy time is printed with its rate."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tiers import HBM_TIER, HOST_TIER, TieredLayout, put_on_tier

    cfg = get_arch("llama31-8b").config
    lay = TieredLayout(total_tokens=8192, hot_tokens=2048, page_tokens=2048)
    gen = torch.Generator(device=dev).manual_seed(7)
    kv = torch.randn(cfg.n_layers, 2, lay.cold_tokens, cfg.n_kv_heads, cfg.head_dim,
                     generator=gen, device=dev).to(torch.bfloat16)
    nbytes = kv.numel() * kv.element_size()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = put_on_tier(kv, HOST_TIER, dev)
    torch.cuda.synchronize()
    d2h = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = put_on_tier(host, HBM_TIER, dev)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    page = put_on_tier(host[:, :, lay.page_slice(1)], HBM_TIER, dev)
    cpu = put_on_tier(kv, HOST_TIER, "cpu")
    same = torch.equal(back, kv) and torch.equal(page, kv[:, :, lay.page_slice(1)])
    emit("tiers", shape=list(kv.shape), dtype="bfloat16", bytes=nbytes,
         cold_bytes=lay.cold_bytes(cfg.n_kv_heads, cfg.head_dim, cfg.n_layers),
         cold_pages=lay.n_cold_pages, host_pinned=host.is_pinned(),
         host_device=str(host.device), back_device=str(back.device), round_trip_equal=same,
         cpu_device_pinned=cpu.is_pinned(), d2h_s=d2h, h2d_s=h2d,
         d2h_gb_per_s=nbytes / d2h / 1e9, h2d_gb_per_s=nbytes / h2d / 1e9)
    check(host.device.type == "cpu" and host.is_pinned(), "tiers: HOST_TIER is not pinned")
    check(back.device.type == "cuda" and same, "tiers: the round trip differs")
    check(nbytes == lay.cold_bytes(cfg.n_kv_heads, cfg.head_dim, cfg.n_layers),
          "tiers: the layout's cold bytes differ from the tensor's")
    check(not cpu.is_pinned() and cpu.device.type == "cpu",
          "tiers: an explicit CPU device gave a pinned tensor")
    del kv, host, back, page, cpu
    torch.cuda.empty_cache()


# -- the smoke serve CLI, fig11, the grid figures, MVA ---------------------------


class engines_built:
    """Within it, ``.engines`` collects every ServingEngine constructed (the
    CLI and the fig11 cell build theirs internally)."""

    def __enter__(self):
        from repro_torch.serving import engine as eng_lib

        cls, init = eng_lib.ServingEngine, eng_lib.ServingEngine.__init__
        self._restore = lambda: setattr(cls, "__init__", init)
        self.engines = engines = []

        def record(eng, *args, **kwargs):
            init(eng, *args, **kwargs)
            engines.append(eng)

        cls.__init__ = record
        return self

    def __exit__(self, *exc):
        self._restore()


def serve_smoke(dev):
    """Phase 12: ``python -m repro_torch.launch.serve`` with its defaults
    (the smoke config, head_dim 32, on the card), run in this process with
    K1's launch count set to 0 just before and read just after."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.launch import serve

    cfg = get_arch("llama31-8b").smoke
    out = io.StringIO()
    with engines_built() as built, contextlib.redirect_stdout(out):
        k1.LAUNCHES.reset()
        t0 = time.perf_counter()
        serve.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1.LAUNCHES.count
    steps = sum(e.decode_steps for e in built.engines)
    lines = out.getvalue().splitlines()
    emit("serve_smoke", command="python -m repro_torch.launch.serve", output=lines,
         config=cfg.name, head_dim=cfg.head_dim, n_layers=cfg.n_layers, wall_s=wall,
         engines={e.cfg.name: dict(requests=len(e.done), decode_steps=e.decode_steps)
                  for e in built.engines},
         k1_launches=launches, layers_x_decode_steps=cfg.n_layers * steps,
         simulated_note="tok/s on the queue clock with the reference's tier constants")
    check(launches == cfg.n_layers * steps and launches > 0,
          f"serve_smoke: K1 launches {launches} != layers x decode steps "
          f"{cfg.n_layers * steps}")
    check(len(lines) == 2 and all(e.finished for e in built.engines),
          f"serve_smoke: the default serve did not finish its requests: {lines}")


def fig11_phase(dev):
    """Phase 13: the §6 case study at the reference's defaults on the card,
    K1's launch count set to 0 just before and read just after; its rows
    must equal the same call's rows on the CPU (they are the simulated
    queue clock's, so they depend on byte counts only)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.scenarios import run_scenario

    cfg = get_arch("llama31-8b").smoke
    with engines_built() as built:
        k1.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run_scenario("fig11_llm").rows
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1.LAUNCHES.count
    steps = sum(e.decode_steps for e in built.engines)
    t0 = time.perf_counter()
    cpu_rows = run_scenario("fig11_llm", device="cpu").rows
    cpu_wall = time.perf_counter() - t0
    emit("fig11", rows=rows, rows_equal_cpu=rows == cpu_rows, wall_s=wall,
         cpu_wall_s=cpu_wall, engines=len(built.engines), decode_steps=steps,
         k1_launches=launches, layers_x_decode_steps=cfg.n_layers * steps,
         simulated_note="tokens/s simulated (TPU-v5e tier constants), not measured")
    check(rows == cpu_rows, "fig11: the card's rows differ from the CPU's")
    check(all(_finite(v) for r in rows for v in r.values() if isinstance(v, float)),
          "fig11: non-finite rows")
    check(launches == cfg.n_layers * steps and launches > 0,
          f"fig11: K1 launches {launches} != layers x decode steps {cfg.n_layers * steps}")
    return dict(k1_launches=launches, wall_s=wall)


def _record_sweep():
    """Patch the planner so that each run_scenario's jobs and results are
    kept; returns (the record, a function that restores the planner)."""
    from repro_torch.scenarios import planner

    got, sweep = {}, planner.run_sweep

    def record(jobs, **kw):
        got["jobs"], got["results"] = jobs, sweep(jobs, **kw)
        return got["results"]

    planner.run_sweep = record
    return got, lambda: setattr(planner, "run_sweep", sweep)


def plain_lane_worker(path, names):
    """Run ``names`` on the port's plain lane (CPU tensors: the float64
    solver) and pickle each one's rows, results and wall to ``path``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    from repro_torch.scenarios import run_scenario

    torch.set_num_threads(1)
    got, restore = _record_sweep()
    out = {}
    try:
        for name in names:
            t0 = time.perf_counter()
            rows = run_scenario(name, device="cpu").rows
            out[name] = dict(rows=rows, results=got["results"],
                             wall_s=time.perf_counter() - t0)
    finally:
        restore()
    with open(path, "wb") as f:
        pickle.dump(out, f)


def start_plain_lane():
    """Start PLAIN_LANE_WORKERS (no card: CUDA_VISIBLE_DEVICES is empty);
    they are killed at exit if still running."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plain_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    workers = []
    for i, names in enumerate(PLAIN_LANE_WORKERS):
        path = os.path.join(tmp, f"plain{i}.pkl")
        err = open(path + ".err", "w")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--plain-lane-worker", path, *names],
                                env=env, stdout=subprocess.DEVNULL, stderr=err)
        workers.append((proc, path, err))

    def stop():
        for proc, _, err in workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()

    atexit.register(stop)
    return dict(workers=workers, started=time.perf_counter())


def join_plain_lane(plain_lane, timeout_s=600.0):
    """The workers' results by scenario, and the seconds spent waiting here
    for them to end; fails if one did not end well."""
    out, t0 = {}, time.perf_counter()
    for proc, path, err in plain_lane["workers"]:
        left = plain_lane["started"] + timeout_s - time.perf_counter()
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            fail(f"the plain-lane worker for {proc.args[4:]} ran past {timeout_s} s")
        err.flush()
        tail = open(path + ".err").read()[-2000:]
        check(rc == 0, f"the plain-lane worker for {proc.args[4:]} exited {rc}: {tail}")
        with open(path, "rb") as f:
            out.update(pickle.load(f))
    return out, time.perf_counter() - t0


def grid_phase(phase, names, plain, capture_first=False):
    """Run the grid scenarios ``names`` on the card, K3's count set to 0
    just before each and read just after, every job held against the plain
    lane's results ``plain`` (the float64 solver, run on the CPU by the
    workers that started after the build).  Emits one ``phase`` line per
    scenario and returns the totals over them: K3 launches and instances,
    exact jobs and mismatches, fluid jobs, decision-flip jobs, the aligned
    relative bandwidth errors, each scenario's rows and, with
    ``capture_first``, the first window's K3 inputs of each group shape."""
    import torch

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import exact, fluid
    from repro_torch.memsim.batched.stacking import plan_cell
    from repro_torch.scenarios import run_scenario

    firsts = {}  # (C, W, S) -> the first window's ten input tensors

    def run(name):
        """Rows, jobs, results and counts of one run on the card."""
        shapes = set()
        solve = fluid.kernel.fused_window_solve

        def record_solve(*args):
            shape = tuple(args[3].shape)  # route: (C, W, S)
            shapes.add(shape)
            if capture_first and shape not in firsts:
                firsts[shape] = [a.clone() for a in args[:10]]
            return solve(*args)

        got, restore = _record_sweep()
        fluid.kernel.fused_window_solve = record_solve
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        fluid.COUNTS.reset()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = run_scenario(name).rows
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
            fluid.kernel.fused_window_solve = solve
        c = fluid.COUNTS
        return rows, got["jobs"], got["results"], dict(
            wall_s=wall, k3_launches=fs.WINDOW_SOLVE_LAUNCHES.count,
            windows=c.windows, shapes=sorted(shapes),
            host_copies_per_window=c.host_copies / max(1, c.windows),
            uploads_per_window=c.uploads / max(1, c.windows),
            tiering_passes=c.tiering_steps,
            tiering_host_ms_per_window=c.tiering_s * 1e3 / max(1, c.windows))

    def same_exact(a, b):
        return (a.tor_inserts == b.tor_inserts and a.tor_peak == b.tor_peak
                and all(a.stats[w].completed == b.stats[w].completed
                        and a.stats[w].bytes == b.stats[w].bytes
                        and a.stats[w].timeline == b.stats[w].timeline
                        and a.stats[w].latency_hist == b.stats[w].latency_hist
                        for w in a.stats))

    total = dict(k3_launches=0, instances=set(), exact_jobs=0, exact_mismatches=0,
                 fluid_jobs=0, flips=0, errs=[], rows={}, results={}, firsts=firsts)
    for name in names:
        rows, jobs, res, info = run(name)
        walls = []

        def again():
            t0 = time.perf_counter()
            run_scenario(name)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        dev_s = sum(e.self_device_time_total for e in profiled(again)) / 1e6
        n_exact = n_flip = mism = 0
        check(len(plain[name]["results"]) == len(jobs), f"{name}: plain lane job count")
        for job, k, p in zip(jobs, res, plain[name]["results"]):
            if exact.exact_regime(plan_cell(job)) is not None:
                n_exact += 1
                mism += not same_exact(k, p)
                continue
            if (sum(d.restricted for d in k.decisions) > 0) != (
                    sum(d.restricted for d in p.decisions) > 0):
                n_flip += 1
                continue
            total["errs"].append(max(abs(k.bandwidth(w) - p.bandwidth(w))
                                     / max(p.bandwidth(w), 1e-9) for w in k.stats))
        instances = sorted({fs.window_solve_instance(W, S) for _, W, S in info["shapes"]})
        row = dict(scenario=name, rows=len(rows), jobs=len(jobs), exact_jobs=n_exact,
                   fluid_jobs=len(jobs) - n_exact, exact_mismatches=mism,
                   decision_flip_jobs=n_flip, wall_s=info["wall_s"],
                   plain_lane_cpu_wall_s=plain[name]["wall_s"], windows=info["windows"],
                   k3_launches=info["k3_launches"],
                   host_copies_per_window=info["host_copies_per_window"],
                   uploads_per_window=info["uploads_per_window"],
                   k3_groups=[dict(C=C, W=W, S=S) for C, W, S in info["shapes"]],
                   k3_instances=[f"<{w}, {s}>" for w, s in instances],
                   device_busy_share=dev_s / walls[0], wall_s_profiled=walls[0])
        if name == "fig10_miku":
            row["fig10"] = [{k: r[k] for k in ("platform", "op", "racing_ddr", "miku_ddr")}
                            for r in rows]
        if info["tiering_passes"]:
            row.update(tiering_passes=info["tiering_passes"],
                       tiering_host_ms_per_window=info["tiering_host_ms_per_window"])
        if name == "corun3_pertier":
            row["corun3_pertier"] = [{k: r[k] for k in (
                "law", "ddr_pct_of_opt", "cxl_mean_cap", "cxl_sw_mean_cap",
                "cxl_sw_restricted_windows")} for r in rows]
        emit(phase, **row)
        check(info["k3_launches"] == info["windows"],
              f"{name}: {info['k3_launches']} K3 launches for {info['windows']} windows")
        check(all(_finite(v) for r in rows for v in r.values() if isinstance(v, float)),
              f"{name}: non-finite rows")
        total["flips"] += n_flip
        total["k3_launches"] += info["k3_launches"]
        total["instances"].update(instances)
        total["exact_jobs"] += n_exact
        total["exact_mismatches"] += mism
        total["fluid_jobs"] += len(jobs) - n_exact
        total["rows"][name] = rows
        total["results"][name] = res
    total["errs"].sort()
    errs = total["errs"]
    total["p95"] = errs[int(0.95 * (len(errs) - 1))] if errs else 0.0
    total["worst"] = errs[-1] if errs else 0.0
    total["instance_names"] = [f"<{w}, {s}>" for w, s in sorted(total["instances"])]
    return total


def emit_grid_totals(phase, total, max_flips, **extra):
    """The ``all`` line of a grid phase, and its gates: exact-lane jobs equal
    to the plain lane's, at most ``max_flips`` decision-flip jobs, the
    aligned p95 relative bandwidth error within the kilo grid's bound."""
    emit(phase, scenario="all", exact_jobs=total["exact_jobs"],
         exact_mismatches=total["exact_mismatches"], fluid_jobs=total["fluid_jobs"],
         decision_flip_jobs=total["flips"], max_flips=max_flips,
         aligned_p95_rel_err=total["p95"], aligned_worst_rel_err=total["worst"],
         p95_bound=SWEEP1K_P95_BOUND, k3_launches=total["k3_launches"],
         k3_instances=total["instance_names"], **extra)
    check(total["exact_mismatches"] == 0,
          f"{phase}: exact-lane cells differ from the plain lane")
    check(total["flips"] <= max_flips and total["p95"] <= SWEEP1K_P95_BOUND,
          f"{phase}: {total['flips']} decision-flip jobs, aligned p95 {total['p95']}")


def figures_phase(dev, plain):
    """Phase 14: the nine grid figures on the card (:func:`grid_phase`),
    fluid cells by the sweep phase's gates over all nine; K3 runs only its
    ``<2, 3>`` instance there.  Returns K3's launches and the instances it
    ran."""
    total = grid_phase("figures", FIGURES, plain)
    emit_grid_totals("figures", total, FIGURES_MAX_FLIPS,
                     plain_lane_workers=len(PLAIN_LANE_WORKERS))
    check(total["k3_launches"] > 0 and total["instances"] == {(2, 3)},
          f"figures: K3 ran the instances {total['instance_names']}")
    return dict(k3_launches=total["k3_launches"], k3_instances=total["instance_names"])


def figures3_phase(dev, plain):
    """Phase 16: fig13, fig14 and the three-tier scenarios on the card
    (:func:`grid_phase`): the figures phase's gates over the five, the
    merged law's broadcast in corun3_pertier's rows, and K3's ``<8, 8>``
    instance among those it ran (W = 3-4 workloads or S = 4 stations).
    Returns K3's launches and instances and the first window of each group
    shape."""
    total = grid_phase("figures3", FIGURES3, plain, capture_first=True)
    rows = {r["law"]: r for r in total["rows"]["corun3_pertier"]}
    emit_grid_totals("figures3", total, FIGURES3_MAX_FLIPS)
    check(rows["merged"]["cxl_mean_cap"] == rows["merged"]["cxl_sw_mean_cap"],
          f"figures3: the merged law's caps differ between the slow tiers: {rows['merged']}")
    check(total["k3_launches"] > 0 and (8, 8) in total["instances"],
          f"figures3: K3 ran the instances {total['instance_names']}, not <8, 8>")
    return dict(k3_launches=total["k3_launches"], k3_instances=total["instance_names"],
                firsts=total["firsts"])


def tiering_phase(dev, plain):
    """Phase 18: migrate_interference and tiering_policies (the tiering
    subsystem: W = 3 groups whose third workload is a MIGRATE
    pseudo-workload, routing and issue gating that change every window) on
    the card (:func:`grid_phase`, the figures' gates over both), each
    tiering job's counters beside the plain lane's, the reference's
    cross-lane bounds on them, and the naive/MIKU headline on the card's
    rows.  Returns K3's launches and instances."""
    total = grid_phase("tiering", TIERING, plain)
    emit_grid_totals("tiering", total, TIERING_MAX_FLIPS)
    keys = ("pages_promoted", "pages_demoted", "deferred_jobs", "migrated_bytes")
    jobs = []
    for name in TIERING:
        for i, (k, p) in enumerate(zip(total["results"][name], plain[name]["results"])):
            if k.tiering is None:
                continue
            row = dict(scenario=name, job=i, policy=k.tiering["policy"])
            for key in keys:
                row[key], row[f"plain_{key}"] = k.tiering[key], p.tiering[key]
                row[f"diff_{key}"] = k.tiering[key] - p.tiering[key]
            ((region, frac),) = k.tiering["fast_fraction"].items()
            row.update(region=region, fast_fraction=frac,
                       plain_fast_fraction=p.tiering["fast_fraction"][region],
                       diff_fast_fraction=frac - p.tiering["fast_fraction"][region])
            jobs.append(row)
    mig = {r["variant"]: r for r in total["rows"]["migrate_interference"]}
    headline = {v: {k: mig[v][k] for k in ("ddr_pct_of_demand_only", "deferred_jobs",
                                         "pages_promoted", "mig_gbps")} for v in mig}
    emit("tiering", scenario="counters", jobs=jobs, headline=headline)
    for k, p in zip(total["rows"]["tiering_policies"], plain["tiering_policies"]["rows"]):
        where = f"tiering_policies {k['platform']} {k['policy']}"
        if p["policy"] == "static":
            check(k["pages_promoted"] == p["pages_promoted"] == 0,
                  f"{where}: a static placement promoted pages")
            continue
        check(abs(k["app_fast_fraction"] - p["app_fast_fraction"]) <= TIERING_FAST_FRACTION_TOL
              and k["app_fast_fraction"] > TIERING_FAST_FRACTION_FLOOR,
              f"{where}: fast fraction {k['app_fast_fraction']}, plain lane "
              f"{p['app_fast_fraction']}")
        check(min(k["pages_promoted"], p["pages_promoted"]) > TIERING_MIN_PROMOTIONS
              and k["pages_promoted"] <= TIERING_COUNT_FACTOR * p["pages_promoted"]
              and k["pages_demoted"] <= TIERING_COUNT_FACTOR * p["pages_demoted"],
              f"{where}: promoted/demoted {k['pages_promoted']}/{k['pages_demoted']}, "
              f"plain lane {p['pages_promoted']}/{p['pages_demoted']}")
    check(mig["naive"]["ddr_pct_of_demand_only"] < 90.0
          and mig["miku"]["ddr_pct_of_demand_only"] > 97.0 and mig["miku"]["deferred_jobs"] > 0,
          f"migrate_interference on the card: naive migration does not hurt DDR or MIKU "
          f"does not restore it: {headline}")
    check(total["k3_launches"] > 0, "tiering: no K3 launch")
    return dict(k3_launches=total["k3_launches"], k3_instances=total["instance_names"])


def trace_schema_mismatches(card, plain) -> list:
    """Where the card's trace payload differs in schema from the plain
    lane's, compared as the reference's cross-lane trace test does
    (tests/test_batched_tiering.py:260-289): cells, jobs, workloads, window
    counts and numbers, and the keys of every record and block."""
    out = []
    if len(card) != len(plain):
        return [f"{len(card)} cells != {len(plain)}"]
    for cc, cp in zip(card, plain):
        if cc["cell"] != cp["cell"] or len(cc["jobs"]) != len(cp["jobs"]):
            out.append(f"cell {cc['cell']}")
            continue
        for jc, jp in zip(cc["jobs"], cp["jobs"]):
            if jc["workloads"] != jp["workloads"] or len(jc["windows"]) != len(jp["windows"]):
                out.append(f"job {jc['job']}: workloads or window count")
                continue
            for rc, rp in zip(jc["windows"], jp["windows"]):
                where = f"job {jc['job']} window {rp['window']}"
                if set(rc) != set(rp) or rc["window"] != rp["window"]:
                    out.append(f"{where}: keys {sorted(rc)} != {sorted(rp)}")
                    continue
                for block in ("tiers", "decision"):
                    if block in rp and (set(rc[block]) != set(rp[block]) or any(
                            set(rc[block][t]) != set(v) for t, v in rp[block].items())):
                        out.append(f"{where}: {block}")
                if "tiers" in rp and any(set(rc["tiers"][t]["class_counts"])
                                         != set(v["class_counts"])
                                         for t, v in rp["tiers"].items()):
                    out.append(f"{where}: class_counts")
                if "tiering" in rp and set(rc["tiering"]) != set(rp["tiering"]):
                    out.append(f"{where}: tiering")
    return out


def trace_phase(dev):
    """Phase 19: traced runs on the card, K3's count set to 0 just before
    each and read just after.  migrate_interference at 60 µs with
    ``trace=True``: every window record of a tiering job carries the tiering
    block, the traces' schema equals the plain lane's (the CPU, in this
    process) the way the reference's cross-lane trace test compares them,
    and they serialize; corun3_pertier under the merged law, traced: its
    records carry a decision block for both slow tiers, equal (the
    broadcast)."""
    import torch

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.memsim.batched import fluid
    from repro_torch.scenarios import run_scenario

    def traced(name, overrides, device=None):
        fs.WINDOW_SOLVE_LAUNCHES.reset()
        fluid.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = run_scenario(name, overrides, device=device, trace=True)
        rows, traces = table.rows, table.traces
        torch.cuda.synchronize()
        return rows, traces, dict(wall_s=time.perf_counter() - t0,
                                  k3_launches=fs.WINDOW_SOLVE_LAUNCHES.count,
                                  windows=fluid.COUNTS.windows)

    over = {"sim_ns": 60_000.0}
    _, traces, info = traced("migrate_interference", over)
    _, plain, _ = traced("migrate_interference", over, device="cpu")
    mismatches = trace_schema_mismatches(traces, plain)
    tiered = [j for c in traces for j in c["jobs"] if any("tiering" in w for w in j["windows"])]
    missing = [(j["job"], w["window"]) for j in tiered for w in j["windows"]
               if not set(TIERING_RECORD_KEYS) <= set(w.get("tiering", ()))]
    payload = json.dumps(traces)
    emit("trace", scenario="migrate_interference", overrides=over, **info,
         jobs=sum(len(c["jobs"]) for c in traces), tiering_jobs=len(tiered),
         records=sum(len(j["windows"]) for c in traces for j in c["jobs"]),
         json_bytes=len(payload), schema_mismatches=mismatches[:10],
         records_missing_tiering_keys=missing[:10],
         last_tiering_block=tiered[-1]["windows"][-1]["tiering"] if tiered else None)
    check(info["k3_launches"] == info["windows"] > 0,
          f"trace: {info['k3_launches']} K3 launches for {info['windows']} windows")
    check(len(tiered) == 2 and not missing, f"trace: tiering blocks missing: {missing[:5]}")
    check(not mismatches, f"trace: the card's schema differs from the plain lane's: "
          f"{mismatches[:5]}")

    _, traces3, info3 = traced("corun3_pertier", {"law": "merged"})
    recs = [w for c in traces3 for j in c["jobs"] for w in j["windows"] if "decision" in w]
    bad = [w["window"] for w in recs if set(w["decision"]) != {"cxl", "cxl_sw"}
           or w["decision"]["cxl"] != w["decision"]["cxl_sw"]]
    json.dumps(traces3)
    emit("trace", scenario="corun3_pertier", overrides={"law": "merged"}, **info3,
         records_with_decisions=len(recs), bad_records=bad[:10],
         first_decision=recs[0]["decision"] if recs else None)
    check(info3["k3_launches"] == info3["windows"] > 0,
          f"trace corun3_pertier: {info3['k3_launches']} K3 launches for "
          f"{info3['windows']} windows")
    check(recs and not bad, f"trace corun3_pertier: {len(recs)} records with decisions, "
          f"these without both slow tiers' (equal) blocks: {bad[:5]}")
    return dict(k3_launches=info["k3_launches"] + info3["k3_launches"])


def serve_kv(dev):
    """Phase 20: serve_smoke's cluster (the smoke config, MIKU) with the
    host engine's KV stream split by a KV PageMap (a region named after the
    engine, half its pages on each tier, a drifting hot set), on the card
    with K1's count set to 0 just before and read just after, then on the
    CPU: the simulated tokens/s and the fast/slow KV bytes must be equal."""
    import torch

    from repro_torch.kernels import decode_attention as k1
    from repro_torch.launch.serve import build_cluster
    from repro_torch.tiering import HotSetPattern, PageMap

    def run(device):
        cluster = build_cluster(device=device)
        host = cluster.engines[1]
        n_pages = -(-host.cfg.max_slots * host.cfg.max_len * host.kv_bytes_per_token // 4096)
        pm = PageMap(("hbm", "host"), fast_capacity_pages=n_pages // 2)
        pm.add_region(host.cfg.name, n_pages, 4096, {"hbm": 0.5, "host": 0.5},
                      HotSetPattern(drift_pages=1.0))
        host.kv_pagemap = pm
        kv = [0, 0]
        split = host.kv_tier_bytes

        def tally(kv_bytes):
            fast, slow = split(kv_bytes)
            kv[0] += fast
            kv[1] += slow
            return fast, slow

        host.kv_tier_bytes = tally
        k1.LAUNCHES.reset()
        if device is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.run(10_000)
        if device is None:
            torch.cuda.synchronize()
        return dict(result=res, kv_fast_bytes=kv[0], kv_slow_bytes=kv[1], n_pages=n_pages,
                    wall_s=time.perf_counter() - t0, k1_launches=k1.LAUNCHES.count,
                    decode_steps=sum(e.decode_steps for e in cluster.engines),
                    n_layers=host.cfg.model.n_layers)

    card = run(None)
    cpu = run("cpu")
    same = (card["result"] == cpu["result"] and card["kv_fast_bytes"] == cpu["kv_fast_bytes"]
            and card["kv_slow_bytes"] == cpu["kv_slow_bytes"])
    emit("serve_kv", simulated_tokens_per_s={k: v["tokens_per_s"]
                                             for k, v in card["result"].items()},
         kv_fast_bytes=card["kv_fast_bytes"], kv_slow_bytes=card["kv_slow_bytes"],
         kv_pages=card["n_pages"], equal_to_cpu=same, wall_s=card["wall_s"],
         cpu_wall_s=cpu["wall_s"], decode_steps=card["decode_steps"],
         k1_launches=card["k1_launches"],
         layers_x_decode_steps=card["n_layers"] * card["decode_steps"],
         simulated_note="tok/s on the queue clock with the reference's tier constants")
    check(same, f"serve_kv: the card's run differs from the CPU's: {card} vs {cpu}")
    check(card["kv_fast_bytes"] > 0 and card["kv_slow_bytes"] > 0,
          "serve_kv: the KV PageMap split no bytes")
    check(card["k1_launches"] == card["n_layers"] * card["decode_steps"] > 0,
          f"serve_kv: K1 launches {card['k1_launches']} != layers x decode steps")
    return dict(k1_launches=card["k1_launches"])


def k3_instance_timing(dev, firsts, ptxas_path):
    """Phase 17: K3's ``<8, 8>`` instance timed at the largest group the
    figures3 phase stacked (its first window, as the lane handed it over)
    and at a kilo-cell three-tier grid (C = 1024, W = 3, S = 4: the first
    window of corun3_switch's co-runs, tiled), each held against
    fused_window_solve_ref (the random windows' rule: the same
    isfinite(lam), finite y and Wq, at most 5% of cells beyond 2e-3), with
    call, kernel-alone, plain and bound times and the instance's registers
    and spills from ptxas."""
    import torch

    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.kernels.ref import fused_window_solve_ref
    from repro_torch.memsim.batched import fluid

    n_outer, damp = fluid._N_OUTER, fluid._DAMP
    ptxas = k3_ptxas(ptxas_path)
    check("registers" in ptxas.get((8, 8), {}),
          f"k3_instance_timing: no ptxas report of the <8, 8> instance in {ptxas_path}")
    big = [sh for sh in firsts if fs.window_solve_instance(sh[1], sh[2]) == (8, 8)]
    check(bool(big), f"k3_instance_timing: no <8, 8> group among {sorted(firsts)}")
    largest = max(big, key=lambda sh: (sh[0], sh[1] * sh[2]))
    tri = [sh for sh in big if sh[1:] == (3, 4)]
    check(bool(tri), f"k3_instance_timing: no W=3, S=4 group among {sorted(firsts)}")
    reps = -(-1024 // tri[0][0])
    cases = [("largest_group", firsts[largest]),
             ("kilo_three_tier", [torch.cat([a] * reps)[:1024] for a in firsts[tri[0]]])]
    out = {}
    for case, args in cases:
        args = [a.to(torch.float32).to(torch.float64) for a in args]
        C, W, S = args[3].shape
        check(fs.window_solve_instance(W, S) == (8, 8), f"{case}: not the <8, 8> instance")
        y, wq, lam = fs.fused_window_solve_cuda(*args, n_outer, damp)
        torch.cuda.synchronize()
        yr, wr, lr = fused_window_solve_ref(*args, n_outer, damp)
        same = bool((torch.isfinite(lam) == torch.isfinite(lr)).all()
                    and torch.isfinite(y).all() and torch.isfinite(wq).all())
        err = torch.maximum(((y - yr).abs() / yr.abs().clamp(min=1e-12)).amax(dim=1),
                            ((wq - wr).abs() / wr.abs().clamp(min=1e-12)).amax(dim=1))
        beyond = int((~(err <= 2e-3)).sum())
        row = dict(case=case, instance="<8, 8>", shape=dict(C=C, W=W, S=S),
                   same_isfinite_lam_finite_y_wq=same, max_rel_err_y_wq=err.max().item(),
                   cells_beyond_2e_3=beyond, max_abs_err=(y - yr).abs().max().item(),
                   ms=time_ms(lambda: fs.fused_window_solve_cuda(*args, n_outer, damp), 20),
                   plain_ms=time_ms(lambda: fused_window_solve_ref(*args, n_outer, damp), 1),
                   kernel_device_ms=kernel_device_ms(
                       lambda: fs.fused_window_solve_cuda(*args, n_outer, damp),
                       "fused_window_solve_kernel", 10),
                   library_ms=None, **ptxas.get((8, 8), {}))
        nbytes = (3 * C * W + 3 * C * W * S + 2 * C * S + 2 * C + C * W + C * S + C) * 4
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, window_solve_ops(C, W, S, n_outer), h100().peak_flops_f32)
        emit("k3_instance_timing", **row)
        check(same and beyond <= K3_RANDOM_MAX_SHARE_BEYOND * C,
              f"k3_instance_timing {case}: mask {same}, {beyond} of {C} cells beyond 2e-3")
        out[case] = {k: row[k] for k in ("shape", "max_abs_err", "ms", "kernel_device_ms",
                                         "plain_ms", "bound_ms", "bound_by", "registers",
                                         "spill_stores_bytes", "spill_loads_bytes")
                     if k in row}
    out["ptxas_2x3"] = ptxas.get((2, 3), {})
    return out


def k3_ptxas(path):
    """Registers and spill bytes of each fused_window_solve_kernel<W, S>
    instance, by (W, S), from the build's ptxas report."""
    return ptxas_instances(path, r"fused_window_solve_kernelILi(\d+)ELi(\d+)E",
                           lambda k: (int(k.group(1)), int(k.group(2))))


def k1_ptxas(path):
    """Registers and spill bytes of each decode_attention_kernel<T, Dh>
    instance, by "<f32|bf16, Dh>", from the build's ptxas report."""
    return ptxas_instances(
        path, r"decode_attention_kernelI(13__nv_bfloat16|f)Li(\d+)E",
        lambda k: f"<{'f32' if k.group(1) == 'f' else 'bf16'}, {k.group(2)}>")


def ptxas_instances(path, pattern, key):
    """Registers and spill bytes of each kernel whose mangled name matches
    ``pattern``, by ``key(match)``, from a ptxas report."""
    import re

    out, cur = {}, None
    for line in open(path).read().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?( |$)",
                      line)
        if m:
            k = re.search(pattern, m.group(1))
            cur = key(k) if k else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(spill_stores_bytes=int(m.group(1)),
                                           spill_loads_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def mva_phase(dev):
    """Phase 15: core.mva.analyze on the card against the CPU, on
    tests/test_mva.py's inputs, rel 1e-5."""
    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.core.mva import analyze

    p = platform_a()
    cases = ([(op, 16, 0) for op in OpClass] + [(OpClass.LOAD, 0, 16)]
             + [(OpClass.LOAD, n, 0) for n in range(1, 34)]
             + [(OpClass.LOAD, 0, n) for n in range(1, 34)])
    fields = ("throughput_fast", "throughput_slow", "residency_fast", "residency_slow",
              "bandwidth_fast_gbps", "bandwidth_slow_gbps")
    worst, t_card = 0.0, 0.0
    for op, f, sl in cases:
        t0 = time.perf_counter()
        card = analyze(p, op, f, sl)
        vals = [float(getattr(card, k)) for k in fields]
        t_card += time.perf_counter() - t0
        cpu = analyze(p, op, f, sl, device="cpu")
        for v, k in zip(vals, fields):
            want = float(getattr(cpu, k))
            worst = max(worst, abs(v - want) / max(abs(want), 1e-30))
    example = analyze(p, OpClass.LOAD, 16, 0)
    emit("mva", cases=len(cases), rounds=200, tol_rel=1e-5, max_rel_err=worst,
         card_ms_per_call=t_card / len(cases) * 1e3,
         load_16_threads_ddr_gbps=float(example.bandwidth_fast_gbps))
    check(worst <= 1e-5, f"mva: the card differs from the CPU by rel {worst}")


# -- the SSM path: K4 ------------------------------------------------------------

#: (case, (b, s, h, p, n), chunk, dtype, tol): tests/test_kernels.py's sweep
#: in f32 and bf16, then the mamba2 shapes: a long prompt, a ragged S and
#: the serve run's 8-token prompt (one chunk of 8), a 64-chunk prompt and
#: four rows of a 2k prompt.
K4_CASES = [(f"sweep{i}_{name}", shape, chunk, dtype, tol)
            for name, dtype, tol in (("f32", "float32", 1e-4), ("bf16", "bfloat16", 5e-2))
            for i, (shape, chunk) in enumerate((((1, 64, 2, 32, 16), 16),
                                                ((2, 128, 4, 32, 16), 32),
                                                ((1, 256, 2, 64, 128), 64)))]
K4_CASES += [
    ("mamba2_s2048_bf16", (1, 2048, 80, 64, 128), 128, "bfloat16", 5e-2),
    ("mamba2_s2048_f32", (1, 2048, 80, 64, 128), 128, "float32", 1e-4),
    ("mamba2_s200_f32", (1, 200, 80, 64, 128), 128, "float32", 1e-4),
    ("mamba2_s200_bf16", (1, 200, 80, 64, 128), 128, "bfloat16", 5e-2),
    ("serve", (1, 8, 80, 64, 128), 128, "bfloat16", 5e-2),
    ("mamba2_s8192_bf16", (1, 8192, 80, 64, 128), 128, "bfloat16", 5e-2),
    ("mamba2_b4_s2048_bf16", (4, 2048, 80, 64, 128), 128, "bfloat16", 5e-2),
    # hymba-1.5b's SSM heads (H 50, P 64, N 16): the serve CLI's 8-token
    # prompt and serve_hymba's 2,048-token one; its smoke config (H 8, P 32,
    # N 16, chunk 16) at the serve CLI's prompt and across a ragged chunk.
    ("hymba_serve_bf16", (1, 8, 50, 64, 16), 128, "bfloat16", 5e-2),
    ("hymba_serve_f32", (1, 8, 50, 64, 16), 128, "float32", 1e-4),
    ("hymba_s2048_bf16", (1, 2048, 50, 64, 16), 128, "bfloat16", 5e-2),
    ("hymba_s2048_f32", (1, 2048, 50, 64, 16), 128, "float32", 1e-4),
    ("hymba_smoke_s8_f32", (1, 8, 8, 32, 16), 16, "float32", 1e-4),
    ("hymba_smoke_s24_f32", (1, 24, 8, 32, 16), 16, "float32", 1e-4),
    ("hymba_smoke_s24_bf16", (1, 24, 8, 32, 16), 16, "bfloat16", 5e-2),
]
#: K4 against ssd_scan_staged_ref with the kernels' own roundings: in f32
#: the two differ in summation order only (the gate of the other plain
#: versions); in bf16 both round y to bf16 at the end, and expf and
#: torch.exp may differ in the last bit, which can flip the bf16 rounding
#: of an operand (W', x tail dt) by one ulp, so y may differ by one bf16
#: ulp (2^-8 of |y|) and the f32 state by the sum of a few such flips.
K4_STAGED_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: K4's device kernels: one for a single chunk (ssd_chunk_kernel<T, true>),
#: else Stage A, B and C.
K4_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_chunk_kernel")


def ssd_bound_ms(b, s, h, p, n, chunk, esize):
    """Least time of one scan on these shapes (the package's K4 cost,
    ``roofline.op_costs.ssd_scan_cost``): x, B and C read once in their
    dtype, dt and a in f32, y written once, the final state in f32;
    against the operations the chunked algorithm needs: C B^T once per
    (batch row, chunk) at G = 1 (causal half), per head the causal
    (C B^T * decay) @ dx, the state's contribution from the second chunk on
    and every chunk's state update.  bf16 inputs against the bf16
    tensor-core rate, f32 against the f32 rate."""
    from repro_torch.roofline.op_costs import ssd_scan_cost

    nbytes, flops = ssd_scan_cost(b, s, h, p, n, chunk, esize)
    hw = h100()
    return bound(nbytes, flops, hw.peak_flops if esize == 2 else hw.peak_flops_f32)


def k4_inputs(gen, b, s, h, p, n, dtype, dev):
    """Scan inputs as the model hands them over: x, B and C are strided
    views of one [B, S, H*P + 2N] projection (the distribution of
    tests/test_kernels.py: x * 0.5, B and C * 0.3), dt = softplus(normal),
    a = -exp(0.3 normal)."""
    import torch
    import torch.nn.functional as F

    xbc = torch.randn(b, s, h * p + 2 * n, generator=gen, device=dev)
    xbc[..., :h * p] *= 0.5
    xbc[..., h * p:] *= 0.3
    xbc = xbc.to(dtype)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = F.softplus(torch.randn(b, s, h, generator=gen, device=dev))
    a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
    return x, dt, bm, cm, a


def k4_sweep(dev):
    """Phase 8: K4 (through ops.ssd_scan, as the model calls it) against
    ssd_scan_chunked_ref and ssd_scan_ref on the card, y and final state,
    and against ssd_scan_staged_ref with the kernels' roundings, with
    kernel, plain and bound times, the launch plan (heads per block,
    chunks), the device kernels one call enqueues (read from a CUDA graph)
    and their profiled time; then chunk 32 against chunk 128.  Returns the
    serve shape's row for the kernels line, with the 2k prompt's as
    ``long_prompt_*`` and hymba's cases under ``hymba``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels.ref import (ssd_scan_chunked_ref, ssd_scan_ref,
                                         ssd_scan_staged_ref)

    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for name, (b, s, h, p, n), chunk, dtype, tol in K4_CASES:
        dtype = getattr(torch, dtype)
        x, dt, bm, cm, a = k4_inputs(gen, b, s, h, p, n, dtype, dev)
        y, st = ops.ssd_scan(x, dt, bm, cm, a, chunk=chunk)
        torch.cuda.synchronize()
        xk, dtk, bc = x.transpose(1, 2), dt.transpose(1, 2), torch.stack([bm, cm], dim=2)
        ck = min(chunk, s)
        yc, stc = ssd_scan_chunked_ref(xk, dtk, bc, a, chunk=ck)
        yr, str_ = ssd_scan_ref(xk, dtk, bc, a)
        errs, ok = {}, True
        for oracle, (yo, so) in (("chunked", (yc, stc)), ("recurrence", (yr, str_))):
            yo = yo.transpose(1, 2).float()
            errs[f"y_err_{oracle}"] = (y.float() - yo).abs().max().item()
            errs[f"state_err_{oracle}"] = (st - so).abs().max().item()
            ok &= torch.allclose(y.float(), yo, atol=tol, rtol=tol)
            ok &= torch.allclose(st, so, atol=tol, rtol=tol)
        ok &= bool(torch.isfinite(y).all() and torch.isfinite(st).all())
        tag = str(dtype).split(".")[-1]
        ys, ss = ssd_scan_staged_ref(xk, dtk, bc, a, chunk=ck, operand_dtype=(
            torch.bfloat16 if dtype == torch.bfloat16 else None))
        ys = ys.transpose(1, 2).float()
        stol = K4_STAGED_TOL[tag]
        errs["y_err_staged"] = (y.float() - ys).abs().max().item()
        errs["state_err_staged"] = (st - ss).abs().max().item()
        staged_ok = (torch.allclose(y.float(), ys, atol=stol, rtol=stol)
                     and torch.allclose(st, ss, atol=stol, rtol=stol))
        plan = k4.plan_for(b, s, h, p, n, ck, dtype, dev)
        row = dict(case=name, shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=ck),
                   dtype=tag, tol=tol, ok=ok, staged_tol=stol, staged_ok=staged_ok, **errs,
                   max_abs_err=max(errs["y_err_chunked"], errs["state_err_chunked"]),
                   n_chunks=plan["n_chunks"], heads_per_block=plan["heads_per_block"],
                   blocks_chunk=plan["blocks_chunk"])
        del ys, ss
        iters = 20 if s >= 1024 else 100

        def call():
            return ops.ssd_scan(x, dt, bm, cm, a, chunk=chunk)

        row["ms"] = time_ms(call, iters)
        # Measured, not planned: the device kernels one call enqueues, their
        # grids (Stage C's is (chunks, head groups, batch rows)) and their
        # device time alone.
        launched = graph_kernels(call)
        row["device_kernels_per_call"] = len(launched)
        row["chunk_grid"] = [g for kn, g in launched if "ssd_chunk_kernel" in kn]
        check(len(launched) == plan["device_kernels_per_call"]
              and all(any(k in kn for k in K4_KERNELS) for kn, _ in launched)
              and row["chunk_grid"] == [(plan["n_chunks"] if plan["n_chunks"] > 1 else 1,
                                         plan["head_groups"], b)],
              f"ssd_scan {name}: kernels {launched} a call, planned "
              f"{plan['device_kernels_per_call']}, {plan['head_groups']} head groups")
        row["stage_device_ms"] = kernel_device_ms(call, K4_KERNELS, 10,
                                                  kernels=len(launched), by_kernel=True)
        row["kernel_device_ms"] = sum(row["stage_device_ms"].values())
        row["plain_ms"] = time_ms(lambda: ssd_scan_chunked_ref(xk, dtk, bc, a, chunk=ck),
                                  max(1, iters // 10))
        row["library_ms"] = None  # no single PyTorch call computes the SSD scan
        row["bound_ms"], row["bound_by"] = ssd_bound_ms(b, s, h, p, n, chunk,
                                                        x.element_size())
        rows[name] = row
        emit("k4_sweep", **row)
        check(ok, f"ssd_scan {name}: {errs} beyond {tol}")
        check(staged_ok, f"ssd_scan {name}: {errs} beyond {stol} of the staged plain version")
        del x, dt, bm, cm, a, y, st, xk, dtk, bc, yc, stc, yr, str_
        torch.cuda.empty_cache()
    # The state carries across chunks: chunk 32 against chunk 128.
    x, dt, bm, cm, a = k4_inputs(gen, 1, 128, 2, 32, 16, torch.float32, dev)
    y32, s32 = ops.ssd_scan(x, dt, bm, cm, a, chunk=32)
    y128, s128 = ops.ssd_scan(x, dt, bm, cm, a, chunk=128)
    inv = dict(y_err=(y32 - y128).abs().max().item(), state_err=(s32 - s128).abs().max().item())
    emit("k4_sweep", case="chunk32_vs_chunk128", tol=1e-4, **inv)
    check(torch.allclose(y32, y128, atol=1e-4, rtol=1e-4)
          and torch.allclose(s32, s128, atol=1e-4, rtol=1e-4),
          f"ssd_scan chunk invariance: {inv}")
    torch.cuda.empty_cache()
    out = {k: rows["serve"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "kernel_device_ms",
                                          "device_kernels_per_call")}
    long_row = rows["mamba2_s2048_bf16"]
    for k in ("ms", "kernel_device_ms", "bound_ms", "plain_ms", "max_abs_err",
              "device_kernels_per_call"):
        out[f"long_prompt_{k}"] = long_row[k]
    # hymba-1.5b's shapes (N = 16) and its smoke config's.
    out["hymba"] = {name[len("hymba_"):]: {k: rows[name][k] for k in (
        "ms", "kernel_device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err", "heads_per_block", "n_chunks", "device_kernels_per_call")}
        for name in rows if name.startswith("hymba_")}
    return out


def ssm_check(model, params, gen, dev, prompt_len=300, steps=3):
    """One prefill of a ``prompt_len``-token prompt and ``steps`` decode
    steps, through K4 and, from a fresh state, through the plain
    ssd_chunked on the same device; the same tokens feed both.  Returns
    the comparison (f32 gate: 2e-3 prefill, 3e-3 decode)."""
    import torch

    from repro_torch.kernels import ssd_scan as k4

    cfg = model.cfg
    prompt = torch.randint(1, cfg.vocab, (1, prompt_len), generator=gen, device=dev)
    k4.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, st_k = model.prefill(params, prompt, model.init_decode_state(1, 1, dev))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = k4.LAUNCHES.count
    with plain_kernels(k1=False, k4=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, st_p = model.prefill(params, prompt, model.init_decode_state(1, 1, dev))
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    lk, lp = lk.float(), lp.float()
    out = dict(prompt_len=prompt_len, chunk=cfg.ssm_chunk, steps=steps,
               k4_launches_in_prefill=launches, prefill_ms=prefill_ms,
               plain_prefill_ms=plain_prefill_ms,
               prefill_max_abs_err=(lk - lp).abs().max().item(),
               prefill_logit_scale=lp.abs().max().item(),
               prefill_argmax_agree=bool((lk.argmax(-1) == lp.argmax(-1)).all()),
               prefill_allclose=torch.allclose(lk, lp, atol=2e-3, rtol=2e-3),
               state_h_max_abs_err=(st_k.ssm["h"] - st_p.ssm["h"]).abs().max().item(),
               decode_max_abs_err=0.0, decode_allclose=True,
               finite=bool(torch.isfinite(lk).all()), argmax_agree=0)
    tok = lk.argmax(-1).to(torch.int32)
    for _ in range(steps):
        dk, st_k = model.decode_step(params, st_k, tok)
        dp, st_p = model.decode_step(params, st_p, tok)
        dk, dp = dk.float(), dp.float()
        out["decode_max_abs_err"] = max(out["decode_max_abs_err"], (dk - dp).abs().max().item())
        out["decode_allclose"] &= torch.allclose(dk, dp, atol=3e-3, rtol=3e-3)
        out["finite"] &= bool(torch.isfinite(dk).all())
        out["argmax_agree"] += int((dk.argmax(-1) == dp.argmax(-1)).sum())
        tok = dk.argmax(-1).to(torch.int32)
    out["logits_shape"] = list(dk.shape)
    check(launches == cfg.n_layers, f"a prefill launched K4 {launches} times, not once "
          f"per layer ({cfg.n_layers})")
    return out


def prefill_long(model, params, gen, dev, prompt_len=2048):
    """One prefill of a ``prompt_len``-token prompt at B = 1 (16 chunks of
    128) through K4 and, from a fresh state, through the plain ssd_chunked:
    the synchronised wall of each, K4's device time and share of the
    device time from torch.profiler over the kernel path's prefill, and
    the logits difference (printed, not gated: the bf16 roads round at
    different places, as in ssm_check)."""
    import torch

    from repro_torch.kernels import ssd_scan as k4

    cfg = model.cfg
    prompt = torch.randint(1, cfg.vocab, (1, prompt_len), generator=gen, device=dev)

    def prefill():
        return model.prefill(params, prompt, model.init_decode_state(1, 1, dev))[0]

    prefill()  # warm: cuBLAS plans, allocator
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk = prefill()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # As in kernel_device_ms: a trace that does not show each of K4's 3
    # kernels once a layer is taken again, up to 3 times.
    for _ in range(3):
        k4.LAUNCHES.reset()
        events = profiled(prefill)
        launches = k4.LAUNCHES.count
        k4_events = [e for e in events if any(k in e.key for k in K4_KERNELS)]
        if len(k4_events) == 3 and all(e.count == launches for e in k4_events):
            break
        PROFILE_RETAKES.append((K4_KERNELS, [(e.key[:60], e.count) for e in k4_events],
                                launches))
    else:
        fail(f"profiler saw {[(e.key[:60], e.count) for e in k4_events]} for {launches} "
             "K4 calls of a long prefill, 3 times")
    dev_us = sum(e.self_device_time_total for e in events)
    k4_us = sum(e.self_device_time_total for e in k4_events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    with plain_kernels(k1=False, k4=True):
        prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = prefill()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    lk, lp = lk.float(), lp.float()
    check(launches == cfg.n_layers, f"a long prefill launched K4 {launches} times")
    check(bool(torch.isfinite(lk).all()), "non-finite logits of the long prefill")
    return dict(prompt_len=prompt_len, chunk=cfg.ssm_chunk, k4_launches=launches,
                wall_ms=walls, device_ms=dev_us / 1e3, k4_device_ms=k4_us / 1e3,
                k4_share_of_device=k4_us / dev_us, k4_share_of_wall=k4_us / 1e3 / min(walls),
                plain_scan_wall_ms=plain_ms, logits_max_abs_diff=(lk - lp).abs().max().item(),
                logit_scale=lp.abs().max().item(),
                argmax_agree=bool((lk.argmax(-1) == lp.argmax(-1)).all()),
                top_kernels=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                                  calls=e.count) for e in top])


def ssm_phases(dev):
    """Phases 10 and 11, the main path of K4: mamba2-2.7b at full width,
    the f32 gate against the plain scan, then the tiered cluster with the
    launch counts set to 0 just before its run and read just after.
    Returns K4's launches in that run."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch.serve import build_cluster
    from repro_torch.models.transformer import TransformerLM

    gen = torch.Generator(device=dev).manual_seed(17)
    full = get_arch("mamba2-2.7b").config
    dims = full.ssm_dims
    state_bytes = full.n_layers * dims["n_heads"] * dims["head_dim"] * dims["d_state"] * 4
    # f32, gated: the kernel and the plain scan differ only in summation
    # order, so the logits meet the reference's own bounds.
    cfg32 = dataclasses.replace(full, dtype=torch.float32)
    model32 = TransformerLM(cfg32)
    torch.cuda.reset_peak_memory_stats()
    params32 = model32.init(torch.Generator(device=dev).manual_seed(2), dev)
    f32 = ssm_check(model32, params32, gen, dev)
    emit("ssm_check", config=full.name, dtype="float32", tol_prefill=2e-3, tol_decode=3e-3,
         n_layers=full.n_layers, ssm_heads=dims["n_heads"], head_dim=dims["head_dim"],
         d_state=dims["d_state"], ssm_state_bytes_per_slot=state_bytes,
         device_memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **f32)
    check(f32["prefill_allclose"] and f32["decode_allclose"] and f32["finite"],
          f"full-width f32 mamba2 logits differ between K4 and the plain scan: {f32}")
    # The long prefill in f32 at the same bounds: 16 chunks of 128 through
    # K4's three stages, against the plain scan.
    f32_long = ssm_check(model32, params32, gen, dev, prompt_len=2048)
    emit("ssm_check", config=full.name, dtype="float32", tol_prefill=2e-3, tol_decode=3e-3,
         n_layers=full.n_layers, peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         **f32_long)
    check(f32_long["prefill_allclose"] and f32_long["decode_allclose"] and f32_long["finite"],
          f"full-width f32 mamba2 logits differ between K4 and the plain scan at 2048 "
          f"tokens: {f32_long}")
    del params32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cluster = build_cluster("mamba2-2.7b", full=True, n_requests=4, max_new=8,
                            mode="miku", seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    hbm, host = cluster.engines
    cfg = hbm.cfg.model
    emit("setup", config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, ssm_heads=dims["n_heads"], param_bytes=hbm.param_bytes,
         kv_bytes_per_token=hbm.kv_bytes_per_token, seconds=setup_s,
         device_memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    bf16 = ssm_check(TransformerLM(cfg), hbm.params, gen, dev)
    emit("ssm_check", config=cfg.name, dtype="bfloat16", gated=False, **bf16)
    check(bf16["finite"], "non-finite bf16 mamba2 logits")
    emit("prefill_long", config=cfg.name, dtype="bfloat16", gated=False,
         **prefill_long(TransformerLM(cfg), hbm.params, gen, dev))
    prof = profile_decode(TransformerLM(cfg), hbm.params, dev)
    # A decode step reads every weight and reads and writes 4 slots' states.
    prof["bound_ms"], prof["bound_by"] = bound(hbm.param_bytes + 2 * 4 * state_bytes, 0, 1)
    emit("decode_profile", config=cfg.name, **prof)

    # The main path: launches counted from here.
    k1.LAUNCHES.reset()
    k4.LAUNCHES.reset()
    t0 = time.perf_counter()
    res = cluster.run(max_ticks=10**9)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, k1_launches = k4.LAUNCHES.count, k1.LAUNCHES.count
    prefills = sum(len(e.done) for e in cluster.engines)
    h2d_bytes = host.offloader.bytes_to_device
    h2d_s = host.offloader.copy_seconds()
    tel = cluster.control.telemetry()
    emit("serve_mamba2", mode="miku", n_layers=cfg.n_layers,
         engines={e.cfg.name: dict(placement=e.cfg.placement, requests=res[e.cfg.name]
                                   ["requests"], tokens=res[e.cfg.name]["tokens"],
                                   decode_steps=e.decode_steps) for e in cluster.engines},
         simulated_tokens_per_s={k: v["tokens_per_s"] for k, v in res.items()},
         simulated_note="queue clock with the reference's tier constants, not measured",
         wall_s=wall_s, miku_windows=tel["windows"],
         miku_restricted_windows=tel["restricted_windows"],
         h2d_bytes=h2d_bytes, h2d_device_s=h2d_s, h2d_gb_per_s=h2d_bytes / h2d_s / 1e9,
         k4_launches=launches, layers_x_prefills=cfg.n_layers * prefills,
         k1_launches=k1_launches,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(res["hbm"]["requests"] == 4 and res["host"]["requests"] == 1,
          f"mamba2 serve did not finish its requests: {res}")
    for e in cluster.engines:
        for r in e.done:
            check(len(r.output) == 8 and all(0 <= t < cfg.vocab for t in r.output),
                  f"bad output for request {r.rid} of {e.cfg.name}: {r.output}")
    check(launches == cfg.n_layers * 5 == cfg.n_layers * prefills,
          f"K4 launches {launches} != layers x prefills {cfg.n_layers * prefills}")
    check(k1_launches == 0, f"the mamba2 path launched K1 {k1_launches} times")
    return launches


# -- the attention families: gemma2, h2o-danube, stablelm, qwen2.5; the
# -- dense-path families: hymba, internvl2, whisper ---------------------------

#: families_check: (arch, layers kept or None for all, the long slot's
#: prompt tokens, why the depth is cut).  f32 throughout; 5,120 tokens cross
#: the 4,096 window and take the blocked prefill (Q_BLOCK = 1024), as do
#: hymba's 2,048 (its window is 1,024); internvl2's 300 tokens hold its 256
#: patch embeddings; whisper prefills an 8-token prompt into each slot, each
#: against its own 1,500 frames.
FAMILY_CHECKS = (
    ("gemma2-27b", 8, 5120, "46 -> 8 layers (4 local, 4 global): f32 at 46 layers is "
                            "about 109 GB"),
    ("h2o-danube-1.8b", None, 5120, None),
    ("stablelm-12b", 8, 300, "40 -> 8 layers: f32 at 40 layers is about 48 GB, and the "
                             "check reads the same layers 8 times over"),
    ("qwen2.5-3b", None, 300, None),
    ("hymba-1.5b", None, 2048, None),
    ("internvl2-2b", None, 300, None),
    ("whisper-large-v3", None, 8, None),
)
#: serve_families: the serve CLI's --arch ids run at its defaults.
SERVE_FAMILIES = ("gemma2-27b", "h2o-danube-1.8b", "stablelm-12b", "qwen2.5-3b",
                  "hymba-1.5b", "internvl2-2b", "dbrx-132b", "llama4-maverick-400b-a17b")
#: moe_check: (arch, flat layers kept, why the depth is cut), f32 at the
#: published widths.  The long slot's MOE_PROMPT tokens take the blocked
#: prefill (2 query blocks); the MoE routes all of them in one call.
MOE_CHECKS = (
    ("dbrx-132b", 4, "40 -> 4 layers: 57.08 GB of f32 weights (526 GB whole)"),
    ("llama4-maverick-400b-a17b", 2, "48 -> 2 layers, one dense/MoE pair: 74.72 GB of f32 "
                                     "weights (1.60 TB whole)"),
)
MOE_PROMPT = 2048
#: serve_moe: (arch, flat layers kept, why the depth is cut), bf16 at the
#: published widths: one device engine of 2 slots x 4,224 positions.
SERVE_MOE = (
    ("dbrx-132b", 8, "40 -> 8 layers: 54.61 GB of bf16 weights (263 GB whole)"),
    ("llama4-maverick-400b-a17b", 2, "48 -> 2 layers, one dense/MoE pair: 37.36 GB of bf16 "
                                     "weights (801 GB whole)"),
)
#: The parts of a DecodeState that a slot owns beside its length.
STATE_PARTS = ("kv", "ssm", "cross_kv")


class plain_kernels:
    """Within it, the model's kernels run their plain versions on the card:
    K1's launcher (``ops.decode_attention_cuda``) and, with ``k4``, the
    model's scan (``models.ssm.ssd``, the plain ``ssd_chunked`` that a CPU
    tensor takes)."""

    def __init__(self, k1: bool = True, k4: bool = False):
        self.k1, self.k4 = k1, k4

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.ref import decode_attention_ref
        from repro_torch.models import ssm as ssm_lib

        self._saved = (ops.decode_attention_cuda, ssm_lib.ssd)
        if self.k1:
            ops.decode_attention_cuda = (lambda q, k, v, lengths, **kw:
                                         decode_attention_ref(q, k, v, lengths, **kw))
        if self.k4:
            ssm_lib.ssd = lambda xs, bm, cm, dt, a, *, chunk: ssm_lib.ssd_chunked(
                xs, bm, cm, dt, a, chunk=chunk)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import ssm as ssm_lib

        ops.decode_attention_cuda, ssm_lib.ssd = self._saved


class routes_recorded:
    """Within it, each call of the MoE router (``models.moe.route``)
    appends its top-k expert ids [T, k] to ``.routes``, in call order, and
    ``.first`` keeps the first ``models.moe.moe_apply`` call: (the layer's
    leaves, x, its keywords, its output)."""

    def __enter__(self):
        from repro_torch.models import moe as moe_lib

        self._saved = route, apply = moe_lib.route, moe_lib.moe_apply
        self.routes = routes = []
        self.first = None

        def record(params, x, top_k):
            out = route(params, x, top_k)
            routes.append(out[2])
            return out

        def keep_first(params, x, **kw):
            out = apply(params, x, **kw)
            if self.first is None:
                self.first = (params, x, kw, out[0])
            return out

        moe_lib.route, moe_lib.moe_apply = record, keep_first
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_lib

        moe_lib.route, moe_lib.moe_apply = self._saved


def routing_agreement(routes, n_moe, steps):
    """Split the routings that :func:`family_check` recorded into its model
    calls, ``n_moe`` each: slot 0's blocked prefill and its one-shot
    prefill, slot 1's prefill, then per decode step the K1 side and the
    plain side.  Returns the share of (token, choice) entries routed to the
    same expert on both sides of each comparison."""
    calls = [routes[i:i + n_moe] for i in range(0, len(routes), n_moe)]
    check(len(routes) == n_moe * (3 + 2 * steps),
          f"moe_check: {len(routes)} routings recorded, not {n_moe} x {3 + 2 * steps}")

    def share(a, b):
        return sum(int((x == y).sum()) for x, y in zip(a, b)) / sum(x.numel() for x in a)

    return dict(prefill_routing_agree=share(calls[0], calls[1]),
                decode_routing_agree=[share(calls[3 + 2 * i], calls[4 + 2 * i])
                                      for i in range(steps)])


def moe_peak_bytes(cfg, prompt_len):
    """Reckoned peak of :func:`family_check` on ``cfg``: its weights, the
    one-shot prefill's scores, masked scores and probabilities
    [Hq, S, S] f32, and the widest FFN's three [rows, F] products (the
    dense sublayer's S rows, or the experts' E x capacity rows)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import param_shapes

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else [v]

    weights = sum(int(np.prod(shape)) * dtype.itemsize
                  for shape, dtype in leaves(param_shapes(cfg)))
    s = prompt_len
    cap = moe_lib.capacity(s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    rows_f = max(s * (cfg.d_ff_dense or 2 * cfg.d_ff) if cfg.paired else 0,
                 cfg.n_experts * cap * cfg.d_ff)
    return weights + 3 * cfg.n_q_heads * s * s * 4 + 3 * rows_f * cfg.dtype.itemsize


def frontend_embeds(cfg, gen, dev, plen):
    """Seeded frontend embeddings [1, n, d_model] for a ``plen``-token
    prompt: whisper's 1,500 encoder frames, or internvl2's 256 patch
    embeddings where the prompt holds them (else a text prompt, None)."""
    import torch

    n = {"audio": cfg.encoder_seq, "vision": cfg.frontend_seq}.get(cfg.frontend)
    if n is None or (cfg.frontend == "vision" and plen < n):
        return None
    return torch.randn(1, n, cfg.d_model, generator=gen, device=dev)


def small_check(cfg, prompt, max_new, max_len):
    """Phase 3's check: a device engine (3 requests) and a host engine (2) of
    ``cfg`` sharing weights drawn on the CPU, served on the CPU (the plain
    path the CPU tests hold against the JAX reference) and on the card;
    request r's prompt is ``[3 + r] + prompt``.  The result dicts and the
    greedy streams must be equal."""
    import torch

    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving import engine as eng_lib

    params_cpu = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    results, streams = {}, {}
    for where in ("cpu", "cuda"):
        params = _to(params_cpu, torch.device(where))
        engines = []
        for i, placement in enumerate(("device", "host")):
            e = eng_lib.ServingEngine(
                eng_lib.EngineConfig(name=placement, model=cfg, max_slots=2, max_len=max_len,
                                     placement=placement, stream_chunks=16), params)
            for r in range(3 - i):
                e.submit(eng_lib.Request(rid=r, prompt=[3 + r] + list(prompt),
                                         max_new_tokens=max_new))
            engines.append(e)
        results[where] = eng_lib.TieredServingCluster(engines).run(100_000)
        streams[where] = [sorted((r.rid, r.output) for r in e.done) for e in engines]
    same = results["cpu"] == results["cuda"] and streams["cpu"] == streams["cuda"]
    emit("small_check", config=cfg.name, prompt_len=len(prompt) + 1, max_new=max_new,
         result_cuda=results["cuda"], same_result_dict=results["cpu"] == results["cuda"],
         same_greedy_tokens=streams["cpu"] == streams["cuda"])
    check(same, f"{cfg.name}: card and CPU disagree")


def family_check(model, params, gen, dev, prompt_len, steps=3):
    """Slot 0 prefills a ``prompt_len``-token prompt (in query blocks when
    the model's attention blocks it), slot 1 an 8-token one, each with its
    own frontend embeddings (frames, or patches where the prompt holds
    them).  Slot 0's prefill logits are held at the reference's prefill
    bound (2e-3) against the same prefill with the attention in one shot,
    and, for a model with SSM heads, against the prefill through K4's plain
    version; then ``steps`` decode steps run through K1 and through the
    plain attention (3e-3).  Each slot's K/V, SSM state and cross K/V go
    into the two-slot state."""
    import torch

    from repro_torch.models import attention as attn

    cfg = model.cfg
    max_len = prompt_len + 128
    st = model.init_decode_state(2, max_len, dev)
    out = dict(prompt_lens=[prompt_len, 8],
               blocked_prefill=prompt_len > attn.Q_BLOCK and prompt_len % attn.Q_BLOCK == 0)
    first = []
    for slot, plen in enumerate((prompt_len, 8)):
        toks = torch.randint(1, cfg.vocab, (1, plen), generator=gen, device=dev)
        fe = frontend_embeds(cfg, gen, dev, plen)

        def prefill():
            return model.prefill(params, toks, model.init_decode_state(1, max_len, dev),
                                 frontend_embeds=fe)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st1 = prefill()
        torch.cuda.synchronize()
        if slot == 0:
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            out["frontend_embeds"] = None if fe is None else list(fe.shape)
            blocked = attn.attend_full
            attn.attend_full = lambda *a, **kw: blocked(*a, q_block=1 << 30, **kw)
            try:
                one_shot = prefill()[0]
            finally:
                attn.attend_full = blocked
            lk, lp = logits.float(), one_shot.float()
            diff = (lk - lp).abs().max().item()
            out.update(prefill_max_abs_err=diff,
                       prefill_max_rel_logit_err=diff / lp.abs().max().item(),
                       prefill_allclose=torch.allclose(lk, lp, atol=2e-3, rtol=2e-3),
                       prefill_finite=bool(torch.isfinite(lk).all()))
            if cfg.uses_ssm:
                with plain_kernels(k1=False, k4=True):
                    lp = prefill()[0].float()
                diff = (lk - lp).abs().max().item()
                out.update(prefill_plain_scan_max_abs_err=diff,
                           prefill_plain_scan_max_rel_logit_err=diff / lp.abs().max().item())
                out["prefill_allclose"] &= torch.allclose(lk, lp, atol=2e-3, rtol=2e-3)
            del one_shot, lp
        for part in STATE_PARTS:
            if getattr(st, part) is not None:
                for name, buf in getattr(st, part).items():
                    buf[:, slot] = getattr(st1, part)[name][:, 0]
        st.length[slot] = plen
        first.append(int(logits.argmax(-1)[0]))
        del st1
    tok = torch.tensor(first, dtype=torch.int32, device=dev)
    out.update(decode_compare(model, params, st, tok, steps))
    return out


def whisper_greedy(model, params, gen, dev, max_new=16):
    """A 16-token greedy decode of whisper from an 8-token prompt over 1,500
    seeded frames (K1 on self and cross attention): the encoder's wall
    alone, the prefill's (which encodes again), and each step's."""
    import torch

    cfg = model.cfg
    toks = torch.randint(1, cfg.vocab, (1, 8), generator=gen, device=dev)
    frames = frontend_embeds(cfg, gen, dev, 8)
    walls = {}
    model.encode(params, frames)  # warm: cuBLAS plans, allocator

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return res

    timed("encode_ms", lambda: model.encode(params, frames))
    logits, st = timed("prefill_ms", lambda: model.prefill(
        params, toks, model.init_decode_state(1, 8 + max_new, dev), frontend_embeds=frames))
    out, finite = [int(logits.argmax(-1)[0])], bool(torch.isfinite(logits).all())
    for _ in range(max_new - 1):
        logits, st = timed("step_ms", lambda: model.decode_step(
            params, st, torch.tensor(out[-1:], dtype=torch.int32, device=dev)))
        finite &= bool(torch.isfinite(logits).all())
        out.append(int(logits.argmax(-1)[0]))
    check(finite and all(0 <= t < cfg.vocab for t in out),
          f"whisper greedy decode: tokens {out}, finite {finite}")
    return dict(greedy_tokens=out, encode_ms=walls["encode_ms"][0],
                prefill_ms=walls["prefill_ms"][0], step_ms=walls["step_ms"],
                measured_decode_tokens_per_s=len(walls["step_ms"]) / sum(walls["step_ms"]) * 1e3)


def families_check(dev):
    """Phase 21: each family at its published widths in f32 (depth cut where
    FAMILY_CHECKS says), random weights from a seeded generator: the prefill
    gate against the one-shot attention (and for hymba the plain scan) and
    3 decode steps through K1 against the plain attention; then the same
    weights in bf16, printed but not gated, with whisper's greedy decode."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM, param_shapes

    gen = torch.Generator(device=dev).manual_seed(19)
    for arch, n_layers, prompt_len, cut in FAMILY_CHECKS:
        full = get_arch(arch).config
        cfg32 = dataclasses.replace(full, dtype=torch.float32,
                                    n_layers=n_layers or full.n_layers)
        torch.cuda.reset_peak_memory_stats()
        params = TransformerLM(cfg32).init(torch.Generator(device=dev).manual_seed(3), dev)
        shape = dict(n_layers=cfg32.n_layers, published_layers=full.n_layers,
                     cut=cut or "none", d_model=full.d_model, n_q_heads=full.n_q_heads,
                     n_kv_heads=full.n_kv_heads, head_dim=full.head_dim, d_ff=full.d_ff,
                     vocab=full.vocab, windows=sorted(set(cfg32.window_sizes())))
        if full.uses_ssm:
            shape["ssm_dims"] = full.ssm_dims
        if full.n_encoder_layers:
            shape.update(n_encoder_layers=full.n_encoder_layers, encoder_seq=full.encoder_seq)
        if full.frontend == "vision":
            shape["frontend_seq"] = full.frontend_seq
        f32 = family_check(TransformerLM(cfg32), params, gen, dev, prompt_len)
        emit("families_check", arch=arch, dtype="float32", tol_prefill=2e-3, tol_decode=3e-3,
             peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **shape, **f32)
        check(f32["prefill_allclose"] and f32["allclose"] and f32["finite"]
              and f32["prefill_finite"], f"{arch}: full-width f32 logits differ: {f32}")
        cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
        params = _cast(params, param_shapes(cfg16))
        torch.cuda.empty_cache()
        model16 = TransformerLM(cfg16)
        bf16 = family_check(model16, params, gen, dev, prompt_len)
        if full.n_encoder_layers:
            bf16["greedy"] = whisper_greedy(model16, params, gen, dev)
        emit("families_check", arch=arch, dtype="bfloat16", gated=False, **shape, **bf16)
        check(bf16["finite"] and bf16["prefill_finite"], f"{arch}: non-finite bf16 logits")
        del params
        torch.cuda.empty_cache()


def moe_check(dev):
    """Phase 25: each MoE family at its published widths in f32 with its
    depth cut as MOE_CHECKS says (random weights from a seeded generator):
    a MOE_PROMPT-token slot beside an 8-token slot, the long prefill against
    the one-shot attention (2e-3) and 3 decode steps through K1 against the
    plain attention (3e-3), with the share of top-k routings the two sides
    agree on, and the first MoE layer's call in the long prefill held
    against the CPU (:func:`moe_layer_check`).  The f32 peak is reckoned
    first and must fit the card's free memory.  Then the f32 weights are
    freed and the same values drawn again in bf16 (the draw is f32,
    rounded) and run the same way, printed, not gated."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM

    gen = torch.Generator(device=dev).manual_seed(23)
    for arch, n_layers, cut in MOE_CHECKS:
        spec = get_arch(arch)
        full = dataclasses.replace(spec.config, n_layers=n_layers)
        gc.collect()
        torch.cuda.empty_cache()
        need = moe_peak_bytes(dataclasses.replace(full, dtype=torch.float32), MOE_PROMPT)
        free = torch.cuda.mem_get_info()[0]
        check(need <= free, f"moe_check {arch}: the f32 run's reckoned peak {need / 1e9:.2f} GB "
                            f"exceeds the card's free memory, {free / 1e9:.2f} GB")
        for dtype in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(full, dtype=dtype)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = TransformerLM(cfg).init(torch.Generator(device=dev).manual_seed(3), dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            with routes_recorded() as rec:
                res = family_check(TransformerLM(cfg), params, gen, dev, MOE_PROMPT)
            res.update(routing_agreement(rec.routes, cfg.n_layers // cfg.moe_every,
                                         res["steps"]))
            f32 = dtype == torch.float32
            if f32:
                res["layer_check"] = moe_layer_check(rec.first, rec.routes[0], cfg)
            emit("moe_check", arch=arch, config=cfg.name, dtype=str(dtype).split(".")[-1],
                 gated=f32, tol_prefill=2e-3, tol_decode=3e-3, n_layers=cfg.n_layers,
                 published_layers=spec.config.n_layers, cut=cut, d_model=cfg.d_model,
                 n_q_heads=cfg.n_q_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                 d_ff=cfg.d_ff, d_ff_dense=cfg.d_ff_dense, n_experts=cfg.n_experts,
                 top_k=cfg.top_k, shared_expert_ff=cfg.shared_expert_ff, vocab=cfg.vocab,
                 f32_reckoned_peak_gb=need / 1e9, free_device_memory_gb=free / 1e9,
                 init_s=init_s, peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 **res)
            if f32:
                layer = res["layer_check"]
                check(res["prefill_allclose"] and res["allclose"] and res["finite"]
                      and res["prefill_finite"], f"{arch}: f32 MoE logits differ: {res}")
                check(layer["allclose"] and layer["same_dropped"] and layer["same_routing"],
                      f"{arch}: the card's MoE layer differs from the CPU's: {layer}")
            else:
                check(res["finite"] and res["prefill_finite"], f"{arch}: non-finite bf16 logits")
            del params, rec
            gc.collect()
            torch.cuda.empty_cache()


def moe_layer_check(call, card_idx, cfg):
    """Hold one MoE FFN call made on the card, ``call`` = (the layer's
    leaves, x [B, S, D], moe_apply's keywords, its output), against the same
    function computed on the CPU without ``moe_apply``'s dispatch: the
    routing (``models.moe.route``) on copies of x and the router, then
    expert by expert, with only that expert's weights copied over, the
    first ``capacity`` requests in the order of their flat index
    ``t * k + j`` kept and the rest dropped, each kept token's FFN output
    added with its gate; the shared expert added last.  ``card_idx`` is
    the card's top-k routing [T, k] of the same call.  Outputs at
    atol = rtol = 1e-4, and the same dropped (token, expert) requests."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe as moe_lib

    layer, x, kw, out = call
    k = kw["top_k"]

    def act(h):
        return F.silu(h) if kw["activation"] == "silu" else F.gelu(h, approximate="tanh")

    t0 = time.perf_counter()
    xc = x.reshape(-1, x.shape[-1]).cpu()
    t, n_exp = xc.shape[0], layer["router"].shape[-1]
    _, vals, idx = moe_lib.route({"router": layer["router"].cpu()}, xc, k)
    cap = moe_lib.capacity(t, k, n_exp, kw["capacity_factor"])
    flat, gate = idx.reshape(-1), vals.reshape(-1)
    ref = torch.zeros_like(xc)
    dropped_cpu = set()
    for e in range(n_exp):
        reqs = (flat == e).nonzero().flatten()
        dropped_cpu |= {(int(r) // k, e) for r in reqs[cap:]}
        kept = reqs[:cap]
        if kept.numel():
            tok = kept // k
            wg, wu, wd = (layer[n][e].cpu() for n in ("w_gate", "w_up", "w_down"))
            ref.index_add_(0, tok, (act(xc[tok] @ wg) * (xc[tok] @ wu)) @ wd
                           * gate[kept, None])
    if "shared" in layer:
        sh = {n: w.cpu() for n, w in layer["shared"].items()}
        ref += (act(xc @ sh["w_gate"]) * (xc @ sh["w_up"])) @ sh["w_down"]
    cpu_s = time.perf_counter() - t0
    # The card's drops, read from its own dispatch of its own routing.
    sort_idx, sorted_e, _, keep = moe_lib.dispatch(card_idx, n_exp, cap)
    lost = ~keep
    dropped_card = set(zip((sort_idx[lost] // k).tolist(), sorted_e[lost].tolist()))
    card = out.reshape(ref.shape).float().cpu()
    diff = (card - ref).abs().max().item()
    return dict(tokens=t, capacity=cap, experts_with_requests=int(flat.unique().numel()),
                dropped_requests=len(dropped_cpu), same_dropped=dropped_card == dropped_cpu,
                same_routing=bool((card_idx.cpu() == idx).all()), tol=1e-4,
                max_abs_err=diff, max_rel_err=diff / ref.abs().max().item(),
                allclose=torch.allclose(card, ref, atol=1e-4, rtol=1e-4), cpu_s=cpu_s)


def run_timed(eng):
    """Serve the requests queued on device engine ``eng`` in a
    TieredServingCluster of its own, each prefill and decode step timed
    (device synchronised) and each sampled step's logits checked finite.
    The main path: K1's and K4's launch counts are set to 0 just before the
    run and read just after.  Returns (result dict, walls in s by "prefill"
    and "decode", finite flags, run wall in s, {"k1": n, "k4": n}).  The
    timing wrappers are removed afterwards: they would hold the engine, and
    its weights, in a reference cycle."""
    import torch

    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.serving import engine as eng_lib

    walls = {"prefill": [], "decode": []}
    finite = []

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t)
            return out
        return run

    sample = eng._sample

    def checked(logits):
        finite.append(bool(torch.isfinite(logits).all()))
        return sample(logits)

    eng.model.prefill = timed(eng.model.prefill, "prefill")
    eng.decode_once = timed(eng.decode_once, "decode")
    eng._sample = checked
    cluster = eng_lib.TieredServingCluster([eng])
    try:
        k1.LAUNCHES.reset()
        k4.LAUNCHES.reset()
        t0 = time.perf_counter()
        res = cluster.run(max_ticks=10**9)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"k1": k1.LAUNCHES.count, "k4": k4.LAUNCHES.count}
    finally:
        del eng.model.prefill, eng.decode_once, eng._sample
    return res, walls, finite, wall_s, counts


def serve_gemma2(dev):
    """Phase 22, the gemma2 serve path: gemma2-27b at its published widths
    and depth in bf16 (random weights from seed 0), one device engine in a
    TieredServingCluster (2 slots of 5,248 positions) serving a seeded
    5,120-token prompt and an 8-token prompt, 16 new tokens each, K1's
    launch count set to 0 just before the run and read just after; then one
    padded profile of a decode step on the served state."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving import engine as eng_lib

    cfg = get_arch("gemma2-27b").config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TransformerLM(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = eng_lib.ServingEngine(
        eng_lib.EngineConfig(name="hbm", model=cfg, max_slots=2, max_len=5248,
                             placement="device"), params)
    rng = np.random.default_rng(0)
    for rid, plen in enumerate((5120, 8)):
        eng.submit(eng_lib.Request(rid=rid, prompt=rng.integers(1, cfg.vocab, plen).tolist(),
                                   max_new_tokens=16))
    res, walls, finite, wall_s, counts = run_timed(eng)
    launches = counts["k1"]
    steps = eng.decode_steps
    decode_tokens = sum(len(r.output) - 1 for r in eng.done)
    lengths = eng.state.length.tolist()
    prof = profile_decode(TransformerLM(cfg), params, dev, steps=1, state=eng.state,
                          tok=eng._tokens)
    # A decode step reads every weight once and each slot's K/V rows that
    # its layers' windows keep.
    kv_rows = sum(min(n + 1, w) for w in cfg.window_sizes() for n in lengths)
    prof["bound_ms"], prof["bound_by"] = bound(
        eng.param_bytes + 2 * kv_rows * cfg.n_kv_heads * cfg.head_dim * 2, 0, 1)
    emit("serve_gemma2", config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_q_heads=cfg.n_q_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab, windows=sorted(set(cfg.window_sizes())),
         param_bytes=eng.param_bytes, init_s=init_s, max_slots=2, max_len=5248,
         prompt_lens=[5120, 8], max_new_tokens=16,
         note="one device engine: build_cluster's host engine is left out at this width, "
              "its device staging copy would double the weights (serving/engine.py "
              "_place_state)",
         prefill_wall_s=walls["prefill"], decode_steps=steps,
         decode_wall_s=sum(walls["decode"]), decode_step_ms=[w * 1e3 for w in walls["decode"]],
         measured_decode_tokens_per_s=decode_tokens / sum(walls["decode"]),
         wall_s=wall_s, result=res, k1_launches=launches,
         layers_x_decode_steps=cfg.n_layers * steps,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         decode_profile=prof)
    check(res["hbm"]["requests"] == 2 and len(eng.done) == 2,
          f"serve_gemma2 did not finish its requests: {res}")
    for r in eng.done:
        check(len(r.output) == 16 and all(0 <= t < cfg.vocab for t in r.output),
              f"serve_gemma2: bad output for request {r.rid}: {r.output}")
    check(finite and all(finite), "serve_gemma2: non-finite logits")
    check(launches == cfg.n_layers * steps and launches > 0,
          f"serve_gemma2: K1 launches {launches} != layers x decode steps "
          f"{cfg.n_layers * steps}")
    return dict(k1_launches=launches, decode_steps=steps)


def serve_hymba(dev):
    """Phase 24, the hymba serve path: hymba-1.5b at its
    published widths and depth in bf16 (random weights from seed 0).  First
    build_cluster("hymba-1.5b", full=True) under MIKU with its device and
    host engines, as phase 5 runs llama; then one device engine (2 slots of
    2,112 positions) serving a seeded 2,048-token prompt (2 query blocks, 16
    scan chunks) and an 8-token prompt, 16 new tokens each, past the window
    of 1,024 on 29 layers.  K1's and K4's launch counts are set to 0 just
    before each run and read just after: K1 = 32 x decode steps, K4 = 32 x
    prefills.  Then one padded profile of a decode step on the served
    state, and its bound."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch.serve import build_cluster
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving import engine as eng_lib

    cfg = get_arch("hymba-1.5b").config
    dims = cfg.ssm_dims
    # An earlier phase's engine whose methods were wrapped holds its
    # weights in a reference cycle until the collector runs.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = build_cluster("hymba-1.5b", full=True, n_requests=4, max_new=8, mode="miku",
                            seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    hbm, host = cluster.engines
    # The tiered cluster: launches counted from here.
    k1.LAUNCHES.reset()
    k4.LAUNCHES.reset()
    t0 = time.perf_counter()
    res = cluster.run(max_ticks=10**9)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k1_cluster, k4_cluster = k1.LAUNCHES.count, k4.LAUNCHES.count
    steps = hbm.decode_steps + host.decode_steps
    prefills = sum(len(e.done) for e in cluster.engines)
    tel = cluster.control.telemetry()
    emit("serve_hymba_cluster", mode="miku", config=cfg.name, n_layers=cfg.n_layers,
         param_bytes=hbm.param_bytes, setup_s=setup_s,
         engines={e.cfg.name: dict(placement=e.cfg.placement, requests=res[e.cfg.name]
                                   ["requests"], tokens=res[e.cfg.name]["tokens"],
                                   decode_steps=e.decode_steps) for e in cluster.engines},
         simulated_tokens_per_s={k: v["tokens_per_s"] for k, v in res.items()},
         simulated_note="queue clock with the reference's tier constants, not measured",
         wall_s=wall_s, miku_windows=tel["windows"],
         miku_restricted_windows=tel["restricted_windows"],
         h2d_bytes=host.offloader.bytes_to_device, k1_launches=k1_cluster,
         layers_x_decode_steps=cfg.n_layers * steps, k4_launches=k4_cluster,
         layers_x_prefills=cfg.n_layers * prefills,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(res["hbm"]["requests"] == 4 and res["host"]["requests"] == 1,
          f"serve_hymba: the cluster did not finish its requests: {res}")
    for e in cluster.engines:
        for r in e.done:
            check(len(r.output) == 8 and all(0 <= t < cfg.vocab for t in r.output),
                  f"serve_hymba: bad output for request {r.rid} of {e.cfg.name}: {r.output}")
    check(k1_cluster == cfg.n_layers * steps and k1_cluster > 0,
          f"serve_hymba: K1 launches {k1_cluster} != layers x decode steps "
          f"{cfg.n_layers * steps}")
    check(k4_cluster == cfg.n_layers * prefills and k4_cluster > 0,
          f"serve_hymba: K4 launches {k4_cluster} != layers x prefills "
          f"{cfg.n_layers * prefills}")
    params = hbm.params
    del cluster, hbm, host, e  # the host engine's pinned copy and staging set
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    eng = eng_lib.ServingEngine(
        eng_lib.EngineConfig(name="hbm", model=cfg, max_slots=2, max_len=2112,
                             placement="device"), params)
    rng = np.random.default_rng(0)
    for rid, plen in enumerate((2048, 8)):
        eng.submit(eng_lib.Request(rid=rid, prompt=rng.integers(1, cfg.vocab, plen).tolist(),
                                   max_new_tokens=16))
    res, walls, finite, wall_s, counts = run_timed(eng)
    launches, k4_launches = counts["k1"], counts["k4"]
    steps = eng.decode_steps
    decode_tokens = sum(len(r.output) - 1 for r in eng.done)
    lengths = eng.state.length.tolist()
    prof = profile_decode(TransformerLM(cfg), params, dev, steps=1, state=eng.state,
                          tok=eng._tokens)
    # A decode step reads every weight once, each slot's K/V rows that its
    # layers' windows keep, and reads and writes each slot's SSM and conv
    # states.
    kv_rows = sum(min(n + 1, w) for w in cfg.window_sizes() for n in lengths)
    state_bytes = cfg.n_layers * 2 * (dims["n_heads"] * dims["head_dim"] * dims["d_state"] * 4
                                      + (dims["d_conv"] - 1) * dims["conv_dim"] * 2)
    prof["bound_ms"], prof["bound_by"] = bound(
        eng.param_bytes + 2 * kv_rows * cfg.n_kv_heads * cfg.head_dim * 2 + 2 * state_bytes,
        0, 1)
    emit("serve_hymba", config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_q_heads=cfg.n_q_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab, ssm_dims=dims, windows=sorted(set(cfg.window_sizes())),
         param_bytes=eng.param_bytes, max_slots=2, max_len=2112, prompt_lens=[2048, 8],
         max_new_tokens=16, prefill_wall_s=walls["prefill"], decode_steps=steps,
         decode_wall_s=sum(walls["decode"]), decode_step_ms=[w * 1e3 for w in walls["decode"]],
         measured_decode_tokens_per_s=decode_tokens / sum(walls["decode"]),
         wall_s=wall_s, result=res, k1_launches=launches,
         layers_x_decode_steps=cfg.n_layers * steps, k4_launches=k4_launches,
         layers_x_prefills=cfg.n_layers * len(eng.done),
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         decode_profile=prof)
    check(res["hbm"]["requests"] == 2 and len(eng.done) == 2,
          f"serve_hymba did not finish its requests: {res}")
    for r in eng.done:
        check(len(r.output) == 16 and all(0 <= t < cfg.vocab for t in r.output),
              f"serve_hymba: bad output for request {r.rid}: {r.output}")
    check(finite and all(finite), "serve_hymba: non-finite logits")
    check(launches == cfg.n_layers * steps and launches > 0,
          f"serve_hymba: K1 launches {launches} != layers x decode steps "
          f"{cfg.n_layers * steps}")
    check(k4_launches == cfg.n_layers * len(eng.done),
          f"serve_hymba: K4 launches {k4_launches} != layers x prefills "
          f"{cfg.n_layers * len(eng.done)}")
    return dict(k1_launches=launches, k4_launches=k4_launches, decode_steps=steps,
                cluster_k1_launches=k1_cluster, cluster_k4_launches=k4_cluster)


def serve_moe(dev):
    """Phase 26, the MoE serve path: dbrx-132b and llama4-maverick at their
    published widths in bf16, depth cut as SERVE_MOE says (random weights
    from seed 0), each in one device engine in a TieredServingCluster (2
    slots of 4,224 positions) serving a seeded 4,096-token prompt and an
    8-token prompt, 16 new tokens each; the collector runs before each
    model.  K1's launch count is set to 0 just before each run and read
    just after: layers x decode steps.  Then one padded profile of a decode
    step on the served state, with the expert products' device time
    (``aten::bmm``), beside two bounds: every weight read once (the untied
    input embedding only in the rows the slots look up) plus the K/V rows,
    and the same with only the experts that step routed to."""
    import gc

    import torch

    launches, steps = {}, {}
    for arch, n_layers, cut in SERVE_MOE:
        # Each model's engine and weights live in serve_moe_model's frame,
        # so they are gone when it returns.
        gc.collect()
        torch.cuda.empty_cache()
        launches[arch], steps[arch] = serve_moe_model(dev, arch, n_layers, cut)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k1_launches=launches, decode_steps=steps)


def serve_moe_model(dev, arch, n_layers, cut):
    """One model of :func:`serve_moe`: returns (K1 launches, decode steps)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving import engine as eng_lib

    cfg = dataclasses.replace(get_arch(arch).config, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TransformerLM(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = eng_lib.ServingEngine(
        eng_lib.EngineConfig(name="hbm", model=cfg, max_slots=2, max_len=4224,
                             placement="device"), params)
    rng = np.random.default_rng(0)
    for rid, plen in enumerate((4096, 8)):
        eng.submit(eng_lib.Request(rid=rid, prompt=rng.integers(1, cfg.vocab, plen).tolist(),
                                   max_new_tokens=16))
    res, walls, finite, wall_s, counts = run_timed(eng)
    launches = counts["k1"]
    steps = eng.decode_steps
    decode_tokens = sum(len(r.output) - 1 for r in eng.done)
    lengths = eng.state.length.tolist()
    with routes_recorded() as rec:
        prof = profile_decode(TransformerLM(cfg), params, dev, steps=1, state=eng.state,
                              tok=eng._tokens)
    # A decode step reads every weight once, bar the rows of an untied input
    # embedding that its slots do not look up, and each slot's K/V rows;
    # reading only the experts it routes to would spare the others.
    kv_bytes = 2 * sum(n + 1 for n in lengths) * cfg.n_layers * cfg.n_kv_heads \
        * cfg.head_dim * 2
    embed = params["embed"]
    unread = 0 if cfg.tied_embeddings else embed.nbytes - len(lengths) * embed[0].nbytes
    read = eng.param_bytes - unread + kv_bytes
    expert_bytes = 3 * cfg.d_model * cfg.d_ff * 2
    routed = [int(torch.unique(r).numel()) for r in rec.routes]
    check(len(routed) == cfg.n_layers // cfg.moe_every,
          f"serve_moe {arch}: {len(routed)} routings in one profiled step")
    prof["bound_ms"], prof["bound_by"] = bound(read, 0, 1)
    prof["embed_bytes_unread"] = unread
    prof["routed_experts_per_layer"] = routed
    prof["routed_only_bound_ms"], _ = bound(
        read - sum(cfg.n_experts - n for n in routed) * expert_bytes, 0, 1)
    prof["expert_products_share"] = prof["bmm_device_ms_per_step"] / prof["device_ms_per_step"]
    emit("serve_moe", arch=arch, config=cfg.name, n_layers=cfg.n_layers,
         published_layers=get_arch(arch).config.n_layers, cut=cut, d_model=cfg.d_model,
         n_q_heads=cfg.n_q_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, d_ff_dense=cfg.d_ff_dense, n_experts=cfg.n_experts,
         top_k=cfg.top_k, shared_expert_ff=cfg.shared_expert_ff, vocab=cfg.vocab,
         param_bytes=eng.param_bytes, init_s=init_s, max_slots=2, max_len=4224,
         prompt_lens=[4096, 8], max_new_tokens=16,
         note="one device engine: build_cluster's host engine is left out at this width, "
              "its device staging copy would double the weights (serving/engine.py "
              "_place_state)",
         prefill_wall_s=walls["prefill"], decode_steps=steps,
         decode_wall_s=sum(walls["decode"]),
         decode_step_ms=[w * 1e3 for w in walls["decode"]],
         measured_decode_tokens_per_s=decode_tokens / sum(walls["decode"]),
         wall_s=wall_s, result=res, k1_launches=launches,
         layers_x_decode_steps=cfg.n_layers * steps,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         decode_profile=prof)
    check(res["hbm"]["requests"] == 2 and len(eng.done) == 2,
          f"serve_moe {arch} did not finish its requests: {res}")
    for r in eng.done:
        check(len(r.output) == 16 and all(0 <= t < cfg.vocab for t in r.output),
              f"serve_moe {arch}: bad output for request {r.rid}: {r.output}")
    check(finite and all(finite), f"serve_moe {arch}: non-finite logits")
    check(launches == cfg.n_layers * steps and launches > 0,
          f"serve_moe {arch}: K1 launches {launches} != layers x decode steps "
          f"{cfg.n_layers * steps}")
    return launches, steps


def serve_families(dev):
    """Phase 23: ``python -m repro_torch.launch.serve --arch A`` at its
    defaults (the smoke config, both engines, MIKU, 8-token prompts and 24
    new tokens: past the smoke windows of 16) for each family, in this
    process on the card with K1's and K4's counts set to 0 just before and
    read just after (K4 = layers x prefills for hymba, 0 for the others),
    then on the CPU: the result dicts must be equal.  Then gemma2's and
    hymba's smoke configs in f32 through phase 3's check (greedy streams
    equal)."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch import serve

    launches, k4_launches = {}, {}
    for arch in SERVE_FAMILIES:
        cfg = get_arch(arch).smoke
        out = io.StringIO()
        with engines_built() as built, contextlib.redirect_stdout(out):
            k1.LAUNCHES.reset()
            k4.LAUNCHES.reset()
            t0 = time.perf_counter()
            card = serve.main(["--arch", arch])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[arch], k4_launches[arch] = k1.LAUNCHES.count, k4.LAUNCHES.count
        steps = sum(e.decode_steps for e in built.engines)
        prefills = sum(len(e.done) for e in built.engines)
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            cpu = serve.main(["--arch", arch, "--device", "cpu"])
            cpu_wall = time.perf_counter() - t0
        emit("serve_families", arch=arch, command=f"python -m repro_torch.launch.serve "
             f"--arch {arch}", output=out.getvalue().splitlines(), config=cfg.name,
             n_layers=cfg.n_layers, head_dim=cfg.head_dim,
             windows=sorted(set(cfg.window_sizes())), wall_s=wall, cpu_wall_s=cpu_wall,
             engines={e.cfg.name: dict(requests=len(e.done), decode_steps=e.decode_steps)
                      for e in built.engines},
             k1_launches=launches[arch], layers_x_decode_steps=cfg.n_layers * steps,
             k4_launches=k4_launches[arch], layers_x_prefills=cfg.n_layers * prefills,
             equal_to_cpu=card == cpu,
             simulated_note="tok/s on the queue clock with the reference's tier constants")
        check(launches[arch] == cfg.n_layers * steps and launches[arch] > 0,
              f"serve_families {arch}: K1 launches {launches[arch]} != layers x decode "
              f"steps {cfg.n_layers * steps}")
        want_k4 = cfg.n_layers * prefills if cfg.uses_ssm else 0
        check(k4_launches[arch] == want_k4,
              f"serve_families {arch}: K4 launches {k4_launches[arch]} != {want_k4}")
        check(card == cpu, f"serve_families {arch}: the card's result {card} != the CPU's {cpu}")
    for arch in ("gemma2-27b", "hymba-1.5b", "dbrx-132b", "llama4-maverick-400b-a17b"):
        small_check(dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32),
                    prompt=[5, 7, 11, 13, 17, 19, 23], max_new=24, max_len=64)
    return dict(k1_launches=launches, k4_launches=k4_launches)


# -- the training path: qwen2.5-3b trained at full width and depth; mamba2
# -- through K4's autograd Function; resume; remat -----------------------------

#: train_qwen: the Trainer's defaults (global batch 8, seq 128, AdamW with
#: an f32 master copy, warmup_cosine, remat "none") for this many steps,
#: with total_steps equal to it.
TRAIN_STEPS = 6
#: train_ssm: mamba2-2.7b at its published widths cut to this many of its 64
#: layers (f32, TF32 off: the gate compares gradients), batch rows, sequence
#: (4 chunks of 128, so the scan runs its three stages), microbatches and
#: steps; every gradient leaf within this share of its scale.
TRAIN_SSM_LAYERS, TRAIN_SSM_BATCH, TRAIN_SSM_SEQ = 8, 4, 512
TRAIN_SSM_MICROBATCHES, TRAIN_SSM_STEPS = 2, 2
TRAIN_SSM_TOL = 1e-3
#: train_resume: qwen2.5-3b's widths cut to this many layers, bf16, the
#: Trainer's batch; every leaf within the reference's atol = rtol = 1e-6.
TRAIN_RESUME_LAYERS = 2
TRAIN_RESUME_TOL = 1e-6
#: train_remat: qwen2.5-3b's widths cut to 4 layers in f32 at seq 2048 (two
#: query blocks of 1024), 2 rows, 4 loss chunks of 512; the modes' gradients
#: within this share of each leaf's scale.
TRAIN_REMAT_LAYERS, TRAIN_REMAT_BATCH, TRAIN_REMAT_SEQ = 4, 2, 2048
TRAIN_REMAT_TOL = 1e-5


def train_peak_bytes(cfg, batch, seq):
    """The reckoned device peak of a train step without remat: params,
    the f32 master, m and v, one set of gradients in the params' dtype, and
    the larger of the backward's live activations and logits or the
    clipping's two f32 temporaries of the largest leaf.  Activations per
    token and layer: the norms' f32 copies and the residual stream (40 B a
    model width), the projections and RoPE (12 B a head width), the gated
    MLP (10 B a hidden width) and the f32 and bf16 scores and probabilities
    (12 B a key); logits [T, V] in bf16, f32 and the softmax's gradient."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.pytree import tree_leaves

    leaves = tree_leaves(param_shapes(cfg))
    numels = [int(np.prod(shape)) for shape, _ in leaves]
    param_bytes = sum(n * (2 if dt.itemsize == 2 else 4)
                      for n, (_, dt) in zip(numels, leaves))
    n = sum(numels)
    tokens = batch * seq
    act = tokens * cfg.n_layers * (40 * cfg.d_model
                                   + 12 * (cfg.n_q_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                                   + 10 * cfg.d_ff + 12 * cfg.n_q_heads * seq)
    logits = tokens * cfg.vocab * 14
    return 2 * param_bytes + 12 * n + max(act + logits, 8 * max(numels))


def train_step_bound(n_params, cfg, batch, seq):
    """The least time of one train step, the sum of two phases that cannot
    overlap: the products of the forward and backward at the bf16 peak (6
    operations a parameter and token, and the scores' 12 B S^2 H Dh a layer),
    then clipping and AdamW at the memory rate (the clip reads the bf16
    gradients twice and writes them once: 6 B a parameter; AdamW reads the
    gradient, reads and writes m, v and the master copy and writes the bf16
    param: 28 B).  Returns (ms, the products' ms, the update's ms)."""
    tokens = batch * seq
    flops = 6 * n_params * tokens + 12 * batch * seq * seq * cfg.n_q_heads * cfg.head_dim \
        * cfg.n_layers
    t_ops = flops / h100().peak_flops
    t_bytes = 34 * n_params / h100().hbm_bw
    return (t_ops + t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3


def profile_train_step(step_fn, state, tokens, labels):
    """torch.profiler over one train step behind the spin-kernel padding:
    wall, the kernels' device time and count, busy share, the top kernels,
    the products' (GEMM kernels') device time, and the device-timeline span
    of each range the step names (forward, clip, AdamW)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    # The ranges' own records on the device timeline are spans, not kernels.
    spans = {e.key.split("/", 1)[1]: e.device_time_total / 1e3 for e in device
             if e.key.startswith("train_step/")}
    events = [e for e in device if not e.key.startswith("train_step/")]
    PROFILE_PADS_LOST.append(PROFILE_PAD_KERNELS - sum(
        e.count for e in events if "spin_kernel" in e.key))
    events = [e for e in events if "spin_kernel" not in e.key]
    dev_us = sum(e.self_device_time_total for e in events)
    gemm = sum(e.self_device_time_total for e in events
               if any(s in e.key.lower() for s in ("gemm", "xmma", "cutlass", "nvjet")))
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return state, metrics, dict(
        wall_ms=wall * 1e3, device_ms=dev_us / 1e3, device_busy_share=dev_us / 1e6 / wall,
        kernels=sum(e.count for e in events), gemm_device_ms=gemm / 1e3,
        range_span_ms=spans,
        top_kernels=[dict(name=e.key[:70], ms=e.self_device_time_total / 1e3, calls=e.count)
                     for e in top])


def train_step_parts(trainer, state, tokens, labels):
    """One more train step taken in its three parts, each timed alone
    between synchronisations: the gradients (forward and backward), the
    clipping and AdamW's update.  Returns their walls in ms."""
    import torch

    from repro_torch.optim import clip_by_global_norm
    from repro_torch.train.step import make_grad_fn

    grad_fn = make_grad_fn(trainer.model)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _, _ = grad_fn(state.params, tokens, labels)
    torch.cuda.synchronize()
    out["grads"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    grads, _ = clip_by_global_norm(grads, 1.0)
    torch.cuda.synchronize()
    out["clip"] = (time.perf_counter() - t0) * 1e3
    lr = torch.tensor(1e-5, dtype=torch.float32, device=tokens.device)
    t0 = time.perf_counter()
    trainer.opt.update(grads, state.opt, state.params, lr)
    torch.cuda.synchronize()
    out["adamw"] = (time.perf_counter() - t0) * 1e3
    return out


def train_qwen(dev):
    """qwen2.5-3b at its published widths and depth through ``Trainer`` at
    its defaults for TRAIN_STEPS steps (total_steps the same), after the
    step's reckoned peak is held against the card's free memory: every
    loss finite and the last below the first; the step walls, tokens/s,
    the peak against the reckoned one, the bound a step, and one padded,
    profiled step."""
    import gc
    import signal

    import torch

    from repro_torch.launch.train import Trainer
    from repro_torch.pytree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    sigterm = signal.getsignal(signal.SIGTERM)  # Trainer.train installs its own
    trainer = Trainer("qwen2.5-3b", total_steps=TRAIN_STEPS, device=dev)
    cfg = trainer.cfg
    need = train_peak_bytes(cfg, trainer.global_batch, trainer.seq_len)
    free = torch.cuda.mem_get_info()[0]
    check(need <= free, f"train_qwen: the reckoned peak {need / 1e9:.2f} GB exceeds the card's "
                        f"free memory, {free / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state = trainer.train(TRAIN_STEPS, log_every=TRAIN_STEPS)
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = list(trainer.history)
    losses = [h["loss"] for h in hist]
    walls = [h["seconds"] for h in hist]
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    tokens_per_step = trainer.global_batch * trainer.seq_len
    bound_ms, ops_ms, bytes_ms = train_step_bound(n_params, cfg, trainer.global_batch,
                                                  trainer.seq_len)
    tokens, labels = (torch.from_numpy(t).to(dev) for t in next(trainer.loader))
    state, _, prof = profile_train_step(trainer.step_fn, state, tokens, labels)
    parts = train_step_parts(trainer, state, tokens, labels)
    emit("train_qwen", config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, params=n_params, dtype="bfloat16", master="float32",
         global_batch=trainer.global_batch, seq_len=trainer.seq_len, steps=TRAIN_STEPS,
         losses=losses, step_walls_s=walls, run_s=run_s,
         tokens_per_s_steady=tokens_per_step * (len(walls) - 1) / sum(walls[1:]),
         tokens_per_s_run=tokens_per_step * len(walls) / run_s,
         reckoned_peak_gb=need / 1e9, free_device_memory_gb=free / 1e9,
         max_memory_allocated_gb=peak / 1e9, bound_ms=bound_ms, bound_products_ms=ops_ms,
         bound_update_ms=bytes_ms, governor_windows=trainer.straggler_loop.windows_run,
         rate_factor=trainer.step_substrate.rate_factor(0), profiled_step=prof,
         step_parts_wall_ms=parts)
    check(len(losses) == TRAIN_STEPS and all(_finite(x) for x in losses),
          f"train_qwen: losses {losses}")
    check(losses[-1] < losses[0], f"train_qwen: the loss did not fall: {losses}")
    check(peak <= need, f"train_qwen: peak {peak / 1e9:.2f} GB above the reckoned "
                        f"{need / 1e9:.2f} GB")
    check(trainer.straggler_loop.windows_run == TRAIN_STEPS, "the governor missed a window")
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, peak_gb=peak / 1e9)


def train_ssm(dev):
    """mamba2-2.7b at its published widths, depth cut, in f32 (TF32 off):
    the gradients of the loss through K4's autograd Function against the
    same gradients with ``ssd_chunked`` called directly on the card (every
    leaf within TRAIN_SSM_TOL of its scale, the losses equal to that too),
    then TRAIN_SSM_STEPS train steps of TRAIN_SSM_MICROBATCHES microbatches
    with K4's count set to 0 just before and read just after: it must equal
    layers x microbatches x steps.  Returns that count."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.pytree import flatten_with_paths
    from repro_torch.train.step import TrainState, make_grad_fn, make_train_step

    full = get_arch("mamba2-2.7b").config
    cfg = dataclasses.replace(full, n_layers=TRAIN_SSM_LAYERS, dtype=torch.float32)
    model = TransformerLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(5), dev)
    rng = np.random.default_rng(5)
    shape = (TRAIN_SSM_BATCH, TRAIN_SSM_SEQ)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, shape).astype(np.int32)).to(dev)
    labels = torch.from_numpy(rng.integers(1, cfg.vocab, shape).astype(np.int32)).to(dev)
    grad_fn = make_grad_fn(model, microbatches=TRAIN_SSM_MICROBATCHES)
    k4.LAUNCHES.reset()
    t0 = time.perf_counter()
    g_kernel, loss_k, _ = grad_fn(params, tokens, labels)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    grad_launches = k4.LAUNCHES.count
    k4.LAUNCHES.reset()
    t0 = time.perf_counter()
    with plain_kernels(k1=False, k4=True):
        g_plain, loss_p, _ = grad_fn(params, tokens, labels)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches = k4.LAUNCHES.count
    errs = {}
    for (key, a), (_, b) in zip(flatten_with_paths(g_kernel), flatten_with_paths(g_plain)):
        scale = float(b.abs().max())
        errs[key] = dict(rel=float((a - b).abs().max()) / max(scale, 1e-30), scale=scale)
    worst = max(errs, key=lambda k: errs[k]["rel"])
    del g_kernel, g_plain

    state = TrainState(params=params, opt=AdamW().init(params), ef_residual=None)
    step_fn = make_train_step(model, AdamW(), lambda s: warmup_cosine(
        s, peak_lr=3e-4, warmup_steps=1, total_steps=TRAIN_SSM_STEPS),
        microbatches=TRAIN_SSM_MICROBATCHES)
    # The main path of this phase: launches counted from here.
    k4.LAUNCHES.reset()
    losses = []
    for _ in range(TRAIN_SSM_STEPS):
        state, m = step_fn(state, tokens, labels)
        losses.append(float(m["loss"]))
    launches = k4.LAUNCHES.count
    want = cfg.n_layers * TRAIN_SSM_MICROBATCHES * TRAIN_SSM_STEPS
    emit("train_ssm", config=full.name, n_layers=cfg.n_layers, published_layers=full.n_layers,
         cut=f"{full.n_layers} -> {cfg.n_layers} layers: one train step's comparison, not "
             "the model's depth, is what the phase holds", d_model=cfg.d_model,
         ssm_heads=cfg.ssm_dims["n_heads"], d_state=cfg.ssm_state, dtype="float32",
         batch=TRAIN_SSM_BATCH, seq_len=TRAIN_SSM_SEQ, chunk=cfg.ssm_chunk,
         microbatches=TRAIN_SSM_MICROBATCHES, tol=TRAIN_SSM_TOL, loss_kernel=float(loss_k),
         loss_plain=float(loss_p), grad_leaves=len(errs), worst_leaf=worst,
         worst_rel=errs[worst]["rel"], leaf_rel={k: v["rel"] for k, v in errs.items()},
         grads_kernel_s=kernel_s, grads_plain_s=plain_s, k4_launches_grads=grad_launches,
         k4_launches_plain=plain_launches, train_losses=losses, k4_launches=launches,
         layers_x_microbatches_x_steps=want,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(grad_launches == cfg.n_layers * TRAIN_SSM_MICROBATCHES and plain_launches == 0,
          f"train_ssm: K4 ran {grad_launches} times through the Function, {plain_launches} "
          "on the plain side")
    check(abs(float(loss_k) - float(loss_p)) <= TRAIN_SSM_TOL * abs(float(loss_p)),
          f"train_ssm: losses {float(loss_k)} and {float(loss_p)}")
    check(all(v["rel"] <= TRAIN_SSM_TOL and v["scale"] > 0 for v in errs.values()),
          f"train_ssm: gradient {worst} off by {errs[worst]['rel']} of its scale")
    check(launches == want, f"train_ssm: K4 launches {launches} != layers x microbatches x "
                            f"steps {want}")
    check(all(_finite(x) for x in losses), f"train_ssm: losses {losses}")
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_resume_worker(tmp):
    """``--train-resume-worker``: the reference's bit-exact resume test on
    the card at qwen2.5-3b's widths cut to TRAIN_RESUME_LAYERS layers, bf16,
    deterministic algorithms on (set before CUDA starts): two steps straight
    against one step, a checkpoint, a resume and one step.  Prints one JSON
    line."""
    import torch

    torch.use_deterministic_algorithms(True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.checkpoint.ckpt import CheckpointManager, restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import Trainer
    from repro_torch.pytree import flatten_with_paths

    cfg = dataclasses.replace(get_arch("qwen2.5-3b").config, n_layers=TRAIN_RESUME_LAYERS)
    kw = dict(config_override=cfg, device="cuda", ckpt_every=1000)
    straight = Trainer("qwen2.5-3b", **kw).train(2, log_every=100)
    t0 = time.perf_counter()
    Trainer("qwen2.5-3b", ckpt_dir=os.path.join(tmp, "b"), **kw).train(1, log_every=100)
    first_s = time.perf_counter() - t0
    step_dir = os.path.join(tmp, "b", "step_00000001")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    t0 = time.perf_counter()
    resumed_trainer = Trainer("qwen2.5-3b", ckpt_dir=os.path.join(tmp, "b"), **kw)
    resumed = resumed_trainer.train(2, resume=True, log_every=100)
    resume_s = time.perf_counter() - t0
    max_abs, close, leaves = 0.0, True, 0
    for (key, a), (key2, b) in zip(flatten_with_paths(straight), flatten_with_paths(resumed)):
        assert key == key2
        a, b = a.float(), b.float()
        max_abs = max(max_abs, (a - b).abs().max().item())
        close &= torch.allclose(a, b, atol=TRAIN_RESUME_TOL, rtol=TRAIN_RESUME_TOL)
        leaves += 1
    # Save and restore alone, timed.
    torch.cuda.synchronize()
    mgr = CheckpointManager(os.path.join(tmp, "c"))
    t0 = time.perf_counter()
    mgr.save(2, resumed)
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore_checkpoint(os.path.join(tmp, "c"), 2, resumed)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    print(json.dumps(dict(n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
                          leaves=leaves, max_abs_diff=max_abs, equal=close,
                          checkpoint_bytes=nbytes, save_s=save_s, restore_s=restore_s,
                          first_run_s=first_s, resumed_run_s=resume_s,
                          resumed_loader_step=resumed_trainer.loader.step,
                          deterministic=torch.are_deterministic_algorithms_enabled())),
          flush=True)


def train_resume(dev):
    """Run :func:`train_resume_worker` in a subprocess (cuBLAS's workspace
    fixed and deterministic algorithms on there only) in a temporary
    directory that is removed afterwards; gate its result."""
    import gc
    import shutil

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--train-resume-worker", tmp], env=env, capture_output=True,
                              text=True, timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(proc.returncode == 0, f"train_resume worker exited {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    emit("train_resume", config="qwen2.5-3b", dtype="bfloat16", tol=TRAIN_RESUME_TOL,
         wall_s=time.perf_counter() - t0, temp_dir_removed=not os.path.exists(tmp), **res)
    check(res["equal"] and res["deterministic"] and res["resumed_loader_step"] == 2,
          f"train_resume: resumed state differs from the straight run: {res}")


def train_remat(dev):
    """qwen2.5-3b's widths cut to TRAIN_REMAT_LAYERS layers in f32 at seq
    TRAIN_REMAT_SEQ (the attention in query blocks, each checkpointed): the
    gradients with remat "full" and "dots" against "none", each mode's peak
    memory and wall of one forward and backward."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.pytree import flatten_with_paths
    from repro_torch.train.step import make_grad_fn

    full = get_arch("qwen2.5-3b").config
    cfg = dataclasses.replace(full, n_layers=TRAIN_REMAT_LAYERS, dtype=torch.float32)
    params = TransformerLM(cfg).init(torch.Generator(device=dev).manual_seed(6), dev)
    rng = np.random.default_rng(6)
    shape = (TRAIN_REMAT_BATCH, TRAIN_REMAT_SEQ)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, shape).astype(np.int32)).to(dev)
    labels = torch.from_numpy(rng.integers(1, cfg.vocab, shape).astype(np.int32)).to(dev)
    modes, ref = {}, None
    for mode in ("none", "full", "dots"):
        grad_fn = make_grad_fn(TransformerLM(cfg, remat=mode))
        grad_fn(params, tokens[:, :256], labels[:, :256])  # warm
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, loss, _ = grad_fn(params, tokens, labels)
        torch.cuda.synchronize()
        row = dict(wall_s=time.perf_counter() - t0, loss=float(loss),
                   peak_above_resident_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        if ref is None:
            ref = grads
        else:
            worst = 0.0
            for (key, a), (_, b) in zip(flatten_with_paths(grads), flatten_with_paths(ref)):
                worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
            row["worst_rel"] = worst
        modes[mode] = row
        del grads
    emit("train_remat", config=full.name, n_layers=cfg.n_layers, published_layers=full.n_layers,
         dtype="float32", batch=TRAIN_REMAT_BATCH, seq_len=TRAIN_REMAT_SEQ,
         query_blocks=TRAIN_REMAT_SEQ // attn.Q_BLOCK, tol=TRAIN_REMAT_TOL, modes=modes)
    check(all(m["worst_rel"] <= TRAIN_REMAT_TOL
              and abs(m["loss"] - modes["none"]["loss"]) <= 1e-6 * abs(modes["none"]["loss"])
              for k, m in modes.items() if k != "none"),
          f"train_remat: the remat modes' gradients differ: {modes}")
    del ref, params
    gc.collect()
    torch.cuda.empty_cache()


def train_phases(dev):
    """The training path: train_qwen, train_ssm, train_resume, train_remat.
    Returns K4's launches on train_ssm's train steps and train_qwen's losses
    and peak."""
    qwen = train_qwen(dev)
    launches = train_ssm(dev)
    train_resume(dev)
    train_remat(dev)
    return launches, qwen


def dist_phases(dev, qwen):
    """The distribution path on one card: dist_serve and dist_train on a
    1 x 1 mesh (NCCL), then the dry run on a fake 256-rank process group
    (the mesh's group is destroyed first: a process holds one).  Returns
    K1's dist_serve launches, K4's meshed train_ssm launches and the dry
    run's cells."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device=dev)
    try:
        k1_launches = dist_serve(dev, mesh)
        k4_launches = dist_train(dev, mesh, qwen)
    finally:
        dist.destroy_process_group()
    return k1_launches, k4_launches, dryrun_phase(dev)


# -- distribution: meshed serve and train on the card, and the dry run ---------

#: dist_serve: llama31-8b's two prompts and its decode steps on a 1 x 1 mesh.
DIST_PROMPTS, DIST_DECODE_STEPS = (1024, 8), 8
#: dist_serve's gate: meshed logits against the unmeshed ones, of their scale
#: (the same kernels on the same bytes).
DIST_SERVE_TOL = 1e-6
#: dist_train: qwen2.5-3b's meshed steps and their gate against train_qwen's
#: first losses (relative).
DIST_TRAIN_STEPS, DIST_TRAIN_TOL = 3, 1e-3
#: The dry run's train cells take 1 microbatch here (the reference's and the
#: CLI's default is 8): the step's FLOPs are the same, its weight gathers 8x
#: fewer, and its trace an eighth as long.
DRYRUN_MICROBATCHES = 1
#: The dry run's cells on the 256-rank production mesh (fake process group).
DRYRUN_CELLS = (("llama31-8b", "train_4k"), ("llama31-8b", "prefill_32k"),
                ("llama31-8b", "decode_32k"), ("gemma2-27b", "long_500k"),
                ("mamba2-2.7b", "prefill_32k"), ("dbrx-132b", "train_4k"))


def dist_serve(dev, mesh):
    """llama31-8b at full width and depth in bf16, every parameter and cache
    leaf a DTensor on ``mesh`` (1 x 1 on one card) under DECODE_RULES, on
    the storage of the unmeshed tensors: each prompt of DIST_PROMPTS
    prefilled alone into its slot, then DIST_DECODE_STEPS greedy steps of
    both slots; the same without a mesh.  Greedy tokens equal, logits
    within DIST_SERVE_TOL of their scale; K1 counted over the meshed decode
    (layers x steps).  Returns that count."""
    import gc

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.distributed.autosharding import distribute_tree, logical_sharding_context
    from repro_torch.distributed.sharding import DECODE_RULES
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.pytree import tree_leaves

    cfg = get_arch("llama31-8b").config
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(7), dev)
    dparams = distribute_tree(params, mesh, model.param_axes(), DECODE_RULES)
    rng = np.random.default_rng(7)
    prompts = [torch.from_numpy(rng.integers(1, cfg.vocab, (1, n)).astype(np.int32)).to(dev)
               for n in DIST_PROMPTS]
    max_len = max(DIST_PROMPTS) + DIST_DECODE_STEPS

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def run(meshed):
        p = dparams if meshed else params
        state = model.init_decode_state(len(prompts), max_len, dev)
        last = []
        ctx = logical_sharding_context(mesh, DECODE_RULES) if meshed else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for slot, tokens in enumerate(prompts):
                st1 = model.init_decode_state(1, tokens.shape[1], dev)
                if meshed:
                    st1 = distribute_tree(st1, mesh, model.decode_state_axes(), DECODE_RULES)
                logits1, st1 = model.prefill(p, tokens, st1)
                n = tokens.shape[1]
                for name in ("k", "v"):
                    state.kv[name][:, slot, :n] = full(st1.kv[name])[:, 0]
                state.length[slot] = n
                last.append(full(logits1)[0])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            if meshed:
                state = distribute_tree(state, mesh, model.decode_state_axes(), DECODE_RULES)
                check(all(isinstance(x, DTensor) for x in tree_leaves(state)),
                      "dist_serve: a cache leaf is not a DTensor")
            tok = torch.stack(last).argmax(-1).to(torch.int32)
            logits_all, toks, walls = [], [], []
            k1.LAUNCHES.reset()
            for _ in range(DIST_DECODE_STEPS):
                toks.append(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, state = model.decode_step(p, state, tok)
                logits = full(logits)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                logits_all.append(logits.float())
                tok = logits.argmax(-1).to(torch.int32)
            launches = k1.LAUNCHES.count
        return dict(prefill_s=prefill_s, step_ms=walls, launches=launches,
                    logits=torch.stack(logits_all), tokens=torch.stack(toks))

    plain = run(False)
    meshed = run(True)
    scale = float(plain["logits"].abs().max())
    err = float((meshed["logits"] - plain["logits"]).abs().max())
    same = bool((meshed["tokens"] == plain["tokens"]).all())
    want = cfg.n_layers * DIST_DECODE_STEPS
    n_dtensor = sum(isinstance(x, DTensor) for x in tree_leaves(dparams))
    check(n_dtensor == len(tree_leaves(params)), "dist_serve: a parameter is not a DTensor")
    emit("dist_serve", config=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), rules="decode",
         dtensor_param_leaves=n_dtensor, prompts=list(DIST_PROMPTS),
         decode_steps=DIST_DECODE_STEPS, tokens_equal=same, max_abs_logit_diff=err,
         logit_scale=scale, tol_of_scale=DIST_SERVE_TOL, k1_launches=meshed["launches"],
         layers_x_decode_steps=want, unmeshed_k1_launches=plain["launches"],
         prefill_s={"unmeshed": plain["prefill_s"], "meshed": meshed["prefill_s"]},
         decode_step_ms={"unmeshed": plain["step_ms"], "meshed": meshed["step_ms"]},
         decode_step_ms_median={"unmeshed": float(np.median(plain["step_ms"][1:])),
                                "meshed": float(np.median(meshed["step_ms"][1:]))})
    check(same, "dist_serve: the meshed greedy tokens differ from the unmeshed ones")
    check(err <= DIST_SERVE_TOL * scale, f"dist_serve: logits differ by {err} (scale {scale})")
    check(meshed["launches"] == want, f"dist_serve: K1 launches {meshed['launches']} != {want}")
    del params, dparams, plain
    gc.collect()
    torch.cuda.empty_cache()
    return meshed["launches"]


def dist_train(dev, mesh, qwen):
    """qwen2.5-3b whole through ``Trainer(mesh=mesh)`` (the state distributed
    per TRAIN_RULES, each step inside the logical sharding context) for
    DIST_TRAIN_STEPS steps from train_qwen's seed and loader: losses within
    DIST_TRAIN_TOL (relative) of train_qwen's first ones, the peak beside
    its peak.  Then train_ssm's gradients and train steps on the same mesh
    (:func:`train_ssm_meshed`).  Returns K4's launches on those steps."""
    import gc
    import signal

    import torch

    from repro_torch.launch.train import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    sigterm = signal.getsignal(signal.SIGTERM)
    trainer = Trainer("qwen2.5-3b", total_steps=TRAIN_STEPS, device=dev, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state = trainer.train(DIST_TRAIN_STEPS, log_every=DIST_TRAIN_STEPS)
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = list(trainer.history)
    losses = [h["loss"] for h in hist]
    want = qwen["losses"][:DIST_TRAIN_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    emit("dist_train", config=trainer.cfg.name, n_layers=trainer.cfg.n_layers,
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), rules="train",
         steps=DIST_TRAIN_STEPS, losses=losses, train_qwen_losses=want, max_rel_diff=max(rel),
         tol=DIST_TRAIN_TOL, step_walls_s=[h["seconds"] for h in hist], run_s=run_s,
         max_memory_allocated_gb=peak / 1e9,
         train_qwen_max_memory_allocated_gb=qwen["peak_gb"])
    check(len(losses) == DIST_TRAIN_STEPS and max(rel) <= DIST_TRAIN_TOL,
          f"dist_train: meshed losses {losses} against train_qwen's {want}")
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return train_ssm_meshed(dev, mesh)


def _ssm_setup(dev):
    """train_ssm's model, parameters and batch (mamba2-2.7b's widths, depth
    cut, f32, its seed)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import TransformerLM

    full = get_arch("mamba2-2.7b").config
    cfg = dataclasses.replace(full, n_layers=TRAIN_SSM_LAYERS, dtype=torch.float32)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(5), dev)
    rng = np.random.default_rng(5)
    shape = (TRAIN_SSM_BATCH, TRAIN_SSM_SEQ)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, shape).astype(np.int32)).to(dev)
    labels = torch.from_numpy(rng.integers(1, cfg.vocab, shape).astype(np.int32)).to(dev)
    return full, cfg, model, params, tokens, labels


def train_ssm_meshed(dev, mesh):
    """train_ssm's gradients with the parameters DTensors on ``mesh`` under
    TRAIN_RULES, against the same gradients unmeshed (every leaf within
    TRAIN_SSM_TOL of its scale), then train_ssm's train steps on the mesh
    with K4's count set to 0 just before and read just after (layers x
    microbatches x steps, as unmeshed).  Returns that count."""
    import gc

    import torch

    from repro_torch.distributed.autosharding import distribute_tree, logical_sharding_context
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.pytree import flatten_with_paths
    from repro_torch.train.step import TrainState, make_grad_fn, make_train_step

    full, cfg, model, params, tokens, labels = _ssm_setup(dev)
    grad_fn = make_grad_fn(model, microbatches=TRAIN_SSM_MICROBATCHES)
    g_plain, loss_p, _ = grad_fn(params, tokens, labels)
    axes = model.param_axes()
    with logical_sharding_context(mesh, TRAIN_RULES):
        dparams = distribute_tree(params, mesh, axes, TRAIN_RULES)
        dtok, dlab = (distribute_tree({"t": x}, mesh, {"t": ("batch", "seq")}, TRAIN_RULES)["t"]
                      for x in (tokens, labels))
        k4.LAUNCHES.reset()
        g_mesh, loss_m, _ = grad_fn(dparams, dtok, dlab)
        grad_launches = k4.LAUNCHES.count
    errs = {}
    for (key, a), (_, b) in zip(flatten_with_paths(g_mesh), flatten_with_paths(g_plain)):
        scale = float(b.abs().max())
        errs[key] = float((a.full_tensor() - b).abs().max()) / max(scale, 1e-30)
    worst = max(errs, key=errs.get)
    del g_mesh, g_plain

    step_fn = make_train_step(model, AdamW(), lambda s: warmup_cosine(
        s, peak_lr=3e-4, warmup_steps=1, total_steps=TRAIN_SSM_STEPS),
        microbatches=TRAIN_SSM_MICROBATCHES)
    opt = AdamW()
    state = TrainState(params=dparams, opt=distribute_tree(opt.init(params), mesh,
                                                           opt.state_axes(axes), TRAIN_RULES),
                       ef_residual=None)
    losses = []
    with logical_sharding_context(mesh, TRAIN_RULES):
        # The meshed main path of this phase: launches counted from here.
        k4.LAUNCHES.reset()
        for _ in range(TRAIN_SSM_STEPS):
            state, m = step_fn(state, dtok, dlab)
            losses.append(float(m["loss"].full_tensor()))
        launches = k4.LAUNCHES.count
    want = cfg.n_layers * TRAIN_SSM_MICROBATCHES * TRAIN_SSM_STEPS
    emit("dist_train_ssm", config=full.name, n_layers=cfg.n_layers, dtype="float32",
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), rules="train",
         microbatches=TRAIN_SSM_MICROBATCHES, tol=TRAIN_SSM_TOL, loss_unmeshed=float(loss_p),
         loss_meshed=float(loss_m.full_tensor()), worst_leaf=worst, worst_rel=errs[worst],
         k4_launches_grads=grad_launches, train_losses=losses, k4_launches=launches,
         layers_x_microbatches_x_steps=want)
    check(all(v <= TRAIN_SSM_TOL for v in errs.values()),
          f"dist_train_ssm: gradient {worst} off by {errs[worst]} of its scale")
    check(launches == want, f"dist_train_ssm: K4 launches {launches} != {want}")
    check(all(_finite(x) for x in losses), f"dist_train_ssm: losses {losses}")
    del state, dparams, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dryrun_phase(dev):
    """The dry run on the card's device type: each cell of DRYRUN_CELLS
    traced with fake tensors on the 256-rank production mesh of a fake
    process group, with the device's allocated bytes unchanged across the
    phase.  Each cell prints its trace time, per-device state bytes (and the
    parameters' against ``bytes_per_device`` of their placements), the peak
    of storage the step made, FLOPs, bytes, minimum bytes, collective bytes
    by kind and by mesh axis, and the H100 roofline terms.  Every cell must
    be ok.  Returns the cells' results."""
    import torch

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.dryrun import fake_process_group, run_cell
    from repro_torch.launch.mesh import SINGLE_POD, make_production_mesh
    from repro_torch.roofline.analysis import roofline_from_cell
    from repro_torch.roofline.op_costs import OpCost

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    shape, _ = SINGLE_POD
    n_dev = int(np.prod(shape))
    name = "x".join(map(str, shape))
    results = []
    with fake_process_group(n_dev):
        mesh = make_production_mesh(device=dev)
        for arch, shape_name in DRYRUN_CELLS:
            r = run_cell(arch, shape_name, mesh, name, device=dev,
                         microbatches=DRYRUN_MICROBATCHES)
            row = r.to_json()
            if r.ok:
                cost = OpCost(flops=r.flops_per_device, bytes=r.bytes_per_device,
                              collective_bytes=dict(r.collective_bytes),
                              axis_bytes=dict(r.collective_axis_bytes))
                terms = roofline_from_cell(get_arch(arch), SHAPES[shape_name], name, n_dev,
                                           cost, hw=h100())
                row["h100"] = dict(compute_s=terms.compute_s, memory_s=terms.memory_s,
                                   collective_s=terms.collective_s, dominant=terms.dominant,
                                   useful_flops_ratio=terms.useful_flops_ratio,
                                   roofline_fraction=terms.roofline_fraction,
                                   model_flops=terms.model_flops)
            emit("dryrun", **row)
            results.append(r)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    wall = time.perf_counter() - t_phase
    emit("dryrun", cells=len(results), ok=sum(r.ok for r in results),
         device_allocated_before=before, device_allocated_after=after, wall_s=wall)
    check(all(r.ok for r in results),
          f"dryrun: cells failed: {[(r.arch, r.shape, r.error) for r in results if not r.ok]}")
    check(after == before, f"dryrun: the device's allocated bytes went {before} -> {after}")
    for r in results:
        check(r.memory["param_size_in_bytes"] == r.memory["param_bytes_from_placements"],
              f"dryrun {r.arch} {r.shape}: parameter bytes a device {r.memory}")
    return results


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def decode_check(model, params, gen, dev, steps):
    """Prefill 4 prompts of 8 tokens, then ``steps`` decode steps through the
    kernel and, from a copy of the same state, through the plain attention;
    the same tokens feed both.  Returns the comparison."""
    import torch

    cfg = model.cfg
    prompt = torch.randint(1, cfg.vocab, (4, 8), generator=gen, device=dev)
    st_k = model.init_decode_state(4, 96, dev)
    logits, st_k = model.prefill(params, prompt, st_k)
    out = dict(batch=4, prompt_len=8)
    out.update(decode_compare(model, params, st_k, logits.argmax(-1).to(torch.int32), steps))
    return out


def decode_compare(model, params, st_k, tok, steps):
    """``steps`` decode steps from state ``st_k`` and tokens ``tok`` through
    the kernel and, from a copy of the state (K/V, SSM state, cross K/V),
    through the plain attention; the kernel path's greedy tokens feed both.
    Logits are held at the reference's decode bound (atol = rtol = 3e-3).
    A step launches K1 once per layer, twice with cross-attention."""
    import torch

    from repro_torch.kernels import decode_attention as k1

    cfg = model.cfg
    st_p = dataclasses.replace(st_k, length=st_k.length.clone(), **{
        part: {n: t.clone() for n, t in getattr(st_k, part).items()}
        for part in STATE_PARTS if getattr(st_k, part) is not None})
    per_step = cfg.n_layers * (2 if cfg.n_encoder_layers else 1)
    out = dict(steps=steps, max_abs_err=0.0, max_rel_logit_err=0.0, allclose=True,
               finite=True, argmax_agree=0, launches_per_step=[], step_ms=[])
    for _ in range(steps):
        k1.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, st_k = model.decode_step(params, st_k, tok)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches_per_step"].append(k1.LAUNCHES.count)
        with plain_kernels():
            lp, st_p = model.decode_step(params, st_p, tok)
        lk, lp = lk.float(), lp.float()
        diff = (lk - lp).abs().max().item()
        out["max_abs_err"] = max(out["max_abs_err"], diff)
        out["max_rel_logit_err"] = max(out["max_rel_logit_err"],
                                       diff / lp.abs().max().item())
        out["allclose"] &= torch.allclose(lk, lp, atol=3e-3, rtol=3e-3)
        out["finite"] &= bool(torch.isfinite(lk).all())
        out["argmax_agree"] += int((lk.argmax(-1) == lp.argmax(-1)).sum())
        tok = lk.argmax(-1).to(torch.int32)
    out["logits_shape"] = list(lk.shape)
    check(out["launches_per_step"] == [per_step] * steps,
          f"a decode step did not launch the kernel {per_step} times: "
          f"{out['launches_per_step']}")
    return out


def profile_decode(model, params, dev, steps: int = 3, state=None, tok=None):
    """torch.profiler over ``steps`` decode steps, at batch 4 from an
    8-token prompt or from ``state`` with tokens ``tok``: wall time per
    step, device kernel time per step, and the kernels that take it; the
    device time of the kernels that ``aten::bmm`` launched (the MoE's
    expert products) and its calls, per step.  The trace opens on the
    spin-kernel padding of :func:`profiled` (its records left out, the ones
    it lost counted), finished before the steps start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    st = state
    if st is None:
        st = model.init_decode_state(4, 96, dev)
        _, st = model.prefill(params, torch.ones(4, 8, dtype=torch.int64, device=dev), st)
        tok = torch.ones(4, dtype=torch.int32, device=dev)
        model.decode_step(params, st, tok)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, st = model.decode_step(params, st, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type.name == "CUDA"]
    PROFILE_PADS_LOST.append(PROFILE_PAD_KERNELS - sum(
        e.count for e in events if "spin_kernel" in e.key))
    events = [e for e in events if "spin_kernel" not in e.key]
    dev_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    bmm = [e for e in averages if e.key == "aten::bmm" and e.device_type.name == "CPU"]
    return dict(
        bmm_device_ms_per_step=sum(e.device_time_total for e in bmm) / steps / 1e3,
        bmm_calls_per_step=sum(e.count for e in bmm) / steps,
        steps=steps, layers=cfg.n_layers, batch=int(st.length.shape[0]),
        wall_ms_per_step=wall / steps * 1e3, device_ms_per_step=dev_us / steps / 1e3,
        device_busy_share=dev_us / 1e6 / wall,
        kernel_launches_per_step=sum(e.count for e in events) / steps,
        top_kernels=[dict(name=e.key[:60], ms_per_step=e.self_device_time_total / steps / 1e3,
                          calls_per_step=e.count / steps) for e in top],
    )


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _cast(tree, leaves):
    """``tree`` with each leaf cast to its dtype in ``leaves`` (a
    ``param_shapes`` tree): the SSM's f32 leaves stay f32."""
    return {k: _cast(v, leaves[k]) if isinstance(v, dict) else v.to(leaves[k][1])
            for k, v in tree.items()}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plain-lane-worker"]:
        plain_lane_worker(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--train-resume-worker"]:
        train_resume_worker(sys.argv[2])
    else:
        main()
