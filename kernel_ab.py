"""Same-call A/B of the port's K1, K2, K3 and K4 between another tree of
this repo and this one, on one GPU.

    mkdir -p .scratch/parent && git archive <rev> | tar -x -C .scratch/parent
    python3 kernel_ab.py .scratch/parent

Each tree's kernels are built by that tree's own ``repro_torch`` (both
builds at once).  Then each tree runs in a process of its own, in turns:
the other tree, this one, this one, the other.  A turn measures, on the
same seeded inputs:

* K1 (``decode_attention_cuda``) at the llama31-8b serve shape and at the
  long cache: the wrapper call (CUDA events around back-to-back calls) and
  its device kernels alone (torch.profiler), with the max abs error against
  that tree's plain version;
* K3 on corun_sweep_1k's first window (both groups, C = 1024) and K2 at
  C = 1024, W = 2: the call and the kernel alone;
* K4 (``ops.ssd_scan``, bf16) at the mamba2 serve prompt (B = 1, S = 8)
  and at a 2k prompt (S = 2048): the call and its device kernels alone,
  with the max abs error of y and the final state against that tree's
  plain version (``ssd_scan_chunked_ref``);
* corun_sweep_1k's wall, three runs after a warm one;

and keeps K3's outputs on every window of a corun_sweep_1k run and on
chip_smoke.py's random windows, and K2's on its inputs.  Those must equal
the other tree's bit for bit, NaN patterns included (exit 1 otherwise).
K4's y and state are kept too and compared by max abs difference only: a
redesign of the scan sums in another order and rounds other operands, so
two trees need not agree bit for bit.  Prints the card, one JSON line per
turn and a summary of each tree's mean times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
K1_SHAPES = {  # (b, hq, hkv, dh, s), lengths: chip_smoke.py's serve and long cache
    "serve": ((4, 32, 8, 128, 96), [9, 12, 14, 16]),
    "long_cache": ((8, 32, 8, 128, 32768), [32768] * 8),
}
K2_SHAPES = ((1024, 2, 0), (128, 5, 1), (7, 8, 3), (300, 3, 0))  # C, W, padded
K4_SHAPES = {"serve": (1, 8, 80, 64, 128), "s2048": (1, 2048, 80, 64, 128)}  # b, s, h, p, n
#: K4's device kernels in either tree (one scan kernel before the redesign).
K4_NAMES = ("ssd_scan_kernel", "ssd_state_kernel", "ssd_pass_kernel", "ssd_chunk_kernel")


def _import_tree(tree):
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import fluid_solver as fs
    from repro_torch.kernels import ssd_scan as k4

    cs.check(k1.__file__.startswith(os.path.abspath(tree) + os.sep),
             f"imported {k1.__file__}, not the tree {tree}")
    return _nvcc, k1, fs, k4


def build(tree) -> None:
    _nvcc, k1, fs, k4 = _import_tree(tree)
    _nvcc.build(k1.SOURCE, fs.SOURCE, k4.SOURCE)


def turn(tree, out_path) -> None:
    """One tree's measurements; its outputs go to ``out_path``."""
    import torch

    _, k1, fs, _ = _import_tree(tree)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import decode_attention_ref, ssd_scan_chunked_ref
    from repro_torch.memsim.batched import fluid
    from repro_torch.scenarios import run_scenario

    dev = torch.device("cuda")
    res, keep = {"tree": tree}, {}
    for name, ((b, hq, hkv, dh, s), lengths) in K1_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b, hkv, n, dh, generator=gen, device=dev).to(torch.bfloat16)
                   for n in (hq // hkv, s, s))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)

        def call():
            return k1.decode_attention_cuda(q, k, v, lens)

        err = (call().float() - decode_attention_ref(q, k, v, lens).float()).abs().max()
        iters = 10 if s >= 32768 else 100
        kernels = len(cs.graph_kernels(call))
        res[f"k1_{name}"] = dict(
            ms=cs.time_ms(call, iters), device_kernels_per_call=kernels,
            kernel_device_ms=cs.kernel_device_ms(call, cs.K1_KERNELS, 10, kernels),
            max_abs_err=err.item())
        del q, k, v
    torch.cuda.empty_cache()

    for name, (b, s, h, p, n) in K4_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(13)
        x, dt, bm, cm, a = cs.k4_inputs(gen, b, s, h, p, n, torch.bfloat16, dev)

        def call():
            return ops.ssd_scan(x, dt, bm, cm, a, chunk=128)

        y, st = call()
        yc, stc = ssd_scan_chunked_ref(x.transpose(1, 2), dt.transpose(1, 2),
                                       torch.stack([bm, cm], dim=2), a, chunk=min(128, s))
        kernels = len(cs.graph_kernels(call))
        res[f"k4_{name}"] = dict(
            ms=cs.time_ms(call, 20 if s >= 1024 else 100), device_kernels_per_call=kernels,
            kernel_device_ms=cs.kernel_device_ms(call, K4_NAMES, 10, kernels),
            y_err=(y.float() - yc.transpose(1, 2).float()).abs().max().item(),
            state_err=(st - stc).abs().max().item())
        keep[f"k4_{name}"] = [y, st]
        del x, dt, bm, cm, a, yc, stc
    torch.cuda.empty_cache()

    n_outer, damp = fluid._N_OUTER, fluid._DAMP
    windows = []
    solve = fluid.kernel.fused_window_solve

    def capture(*args):
        out = solve(*args)
        windows.append((args[:10], out))
        return out

    fluid.kernel.fused_window_solve = capture
    try:
        run_scenario("corun_sweep_1k", device=dev)
    finally:
        fluid.kernel.fused_window_solve = solve
    keep["k3_corun_sweep_1k"] = [out for _, out in windows]
    (a, _), (b, _) = windows[:2]
    first = [torch.cat([a[i], b[i]]) for i in range(10)]
    call = lambda: fs.fused_window_solve_cuda(*first, n_outer, damp)  # noqa: E731
    res["k3"] = dict(cells=first[0].shape[0], ms=cs.time_ms(call, 20),
                     kernel_device_ms=cs.kernel_device_ms(
                         call, "fused_window_solve_kernel", 10))
    rng = np.random.default_rng(5)
    keep["k3_random"] = [
        fs.fused_window_solve_cuda(*(torch.as_tensor(x, device=dev) for x in
                                     cs.random_window_inputs(rng, *case)), n_outer, damp)
        for case in cs.K3_RANDOM_CASES]

    keep["k2"] = []
    for C, W, pad in K2_SHAPES:
        args = [torch.as_tensor(x, device=dev)
                for x in cs.glam_inputs(np.random.default_rng(C + W), C, W, pad, 4096.0)]
        keep["k2"].append(fs.global_lambda_cuda(*args))
        if C == 1024:
            call = lambda: fs.global_lambda_cuda(*args)  # noqa: E731
            res["k2"] = dict(cells=C, ms=cs.time_ms(call, 100), kernel_device_ms=(
                cs.kernel_device_ms(call, "global_lambda_kernel")))

    walls = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_scenario("corun_sweep_1k", device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    res["corun_sweep_1k_wall_s"] = walls[1:]
    torch.save(keep, out_path)
    print(json.dumps(res), flush=True)


def _bit_equal(a, b) -> bool:
    """Equal bit for bit (NaN patterns included), through lists and tuples."""
    import torch

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bit_equal(x, y) for x, y in zip(a, b))
    ints = {8: torch.int64, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints),
                                                                      b.view(ints))


def main(other) -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("kernel_ab.py needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    trees = {"other": os.path.abspath(other), "this": HERE}
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", t]) for t in trees.values()]
    cs.check(all(p.wait() == 0 for p in builds), "a build failed")
    out_dir = os.path.join(HERE, ".scratch", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    rows = {name: [] for name in trees}
    for i, name in enumerate(("other", "this", "this", "other")):
        path = os.path.join(out_dir, f"{name}-{i}.pt")
        proc = subprocess.run([sys.executable, me, "--turn", trees[name], path],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        cs.check(proc.returncode == 0, f"turn {i} ({name}) failed:\n{proc.stderr[-4000:]}")
        rows[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    keep = {name: torch.load(os.path.join(out_dir, f"{name}-{i}.pt"))
            for i, name in ((0, "other"), (1, "this"))}
    differ = [key for key in keep["this"] if not key.startswith("k4_")
              and not _bit_equal(keep["this"][key], keep["other"][key])]
    k4_diff = {key: [(a.float() - b.float()).abs().max().item()
                     for a, b in zip(keep["this"][key], keep["other"][key])]
               for key in keep["this"] if key.startswith("k4_")}

    summary = {}
    for name, turns in rows.items():
        summary[name] = {f"{kern}_{field}": sum(t[kern][field] for t in turns) / len(turns)
                         for kern in ("k1_serve", "k1_long_cache", "k3", "k2", "k4_serve",
                                      "k4_s2048")
                         for field in ("ms", "kernel_device_ms")}
        walls = [w for t in turns for w in t["corun_sweep_1k_wall_s"]]
        summary[name]["corun_sweep_1k_wall_s"] = sum(walls) / len(walls)
    print(json.dumps({"summary": summary, "bit_equal_k2_k3": not differ, "differ": differ,
                      "k4_max_abs_diff_y_state": k4_diff}), flush=True)
    cs.check(not differ, f"K2/K3 outputs differ between the trees: {differ}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--build":
        build(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "--turn":
        turn(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 2:
        main(sys.argv[1])
    else:
        cs.fail("usage: python3 kernel_ab.py OTHER_TREE (on a machine with a GPU)")
