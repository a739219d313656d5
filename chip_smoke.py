"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. environment: card, power limit, torch/CUDA versions, kernel build time;
  2. kernel sweep: the flash-decode kernel against its plain PyTorch version
     (tests/test_kernels.py's cases and tolerances, the serve shape and a
     long cache), each with kernel, plain and library times and the bound
     (CUDA events; the serve shape's K/V stay in L2 between launches, the
     long cache's 1.07 GB cannot);
  3. small-input check: a two-layer model (head_dim 64, f32) served on the
     card and on the CPU (the plain path the CPU tests hold against the JAX
     reference) must give the same greedy tokens and the same result dict;
  4. decode-step check: llama31-8b at full width, random weights from a
     seeded generator, one prefill and decode steps through the kernel and
     through the plain attention, logits compared;
  5. serve: build_cluster(full=True, mode="miku") — a device engine and a
     host engine streaming its weights from pinned host memory — with the
     kernel's launch count read around the run.
The line before the last lists every kernel's numbers; the last line is the
device summary.  Any failed check exits non-zero; without CUDA (or without
the rest of the repository beside this file) it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def attention_bound_ms(q, k, lengths, window=1 << 30):
    """Least time for one decode-attention call on these inputs: each input
    byte read once (only the K/V rows the mask keeps), the output written
    once, against the bf16/f32 operations they need; the larger of the two,
    and which one it is."""
    b, hkv, g, dh = q.shape
    s = k.shape[2]
    valid = sum(max(0, min(int(n), s) - max(0, int(n) - window)) for n in lengths.tolist())
    esize = k.element_size()
    nbytes = 2 * valid * hkv * dh * esize + 2 * q.numel() * q.element_size() + 4 * b
    flops = 4 * valid * hkv * g * dh
    peak = H100_BF16_FLOPS if q.dtype.itemsize == 2 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_PER_S, flops / peak
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
        from repro_torch.kernels import decode_attention as k1
        from repro_torch.kernels.ref import decode_attention_ref
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_cluster
    from repro_torch.models.transformer import ModelConfig, TransformerLM
    from repro_torch.serving import engine as eng_lib

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
    lib_path = k1.build()
    build_s = time.perf_counter() - t0
    ptxas = [line.split("ptxas info    : ")[-1] for line in
             lib_path.with_suffix(".ptxas.txt").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit("environment", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kernel_build_s=build_s, kernel_library=lib_path.name, ptxas=ptxas)

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

    sweep = {}
    for name, shape, dtype, tol, kw, lengths in cases:
        b, hq, hkv, dh, s = shape
        q, k, v, lens = inputs(b, hq, hkv, dh, s, dtype, lengths)
        out = k1.decode_attention_cuda(q, k, v, lens, **kw)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, lens, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        row = dict(case=name, shape=dict(b=b, hq=hq, hkv=hkv, dh=dh, s=s),
                   dtype=str(dtype).split(".")[-1], tol=tol, max_abs_err=err, ok=ok)
        iters = 10 if name == "long_cache" else 100
        row["ms"] = time_ms(lambda: k1.decode_attention_cuda(q, k, v, lens, **kw), iters)
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
                                                      enable_gqa=True)

            row["library_ms"] = time_ms(library, iters)
            row["library_max_abs_err"] = (library().reshape(out.shape).float()
                                          - ref.float()).abs().max().item()
        row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, lens,
                                                              kw.get("window", 1 << 30))
        sweep[name] = row
        emit("kernel_sweep", **row)
        check(ok, f"decode attention {name}: max abs err {err} > {tol}")
        del q, k, v, out, ref
    torch.cuda.empty_cache()

    # -- 3. small-input check: card vs the CPU plain path -----------------------
    small = ModelConfig(name="small-dh64", n_layers=2, d_model=256, n_q_heads=8,
                        n_kv_heads=2, head_dim=64, d_ff=512, vocab=512,
                        rope_theta=500_000.0, dtype=torch.float32)
    params_cpu = TransformerLM(small).init(torch.Generator().manual_seed(0), "cpu")
    results, streams = {}, {}
    for where in ("cpu", "cuda"):
        params = _to(params_cpu, torch.device(where))
        engines = []
        for i, placement in enumerate(("device", "host")):
            e = eng_lib.ServingEngine(
                eng_lib.EngineConfig(name=placement, model=small, max_slots=2, max_len=32,
                                     placement=placement, stream_chunks=16), params)
            for r in range(3 - i):
                e.submit(eng_lib.Request(rid=r, prompt=[3 + r, 5, 7, 11], max_new_tokens=6))
            engines.append(e)
        results[where] = eng_lib.TieredServingCluster(engines).run(100_000)
        streams[where] = [sorted((r.rid, r.output) for r in e.done) for e in engines]
    same = results["cpu"] == results["cuda"] and streams["cpu"] == streams["cuda"]
    emit("small_check", config=small.name, result_cuda=results["cuda"],
         same_result_dict=results["cpu"] == results["cuda"],
         same_greedy_tokens=streams["cpu"] == streams["cuda"])
    check(same, "small model: card and CPU disagree")

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

    row = sweep["serve"]
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)



def decode_check(model, params, gen, dev, steps):
    """Prefill 4 prompts of 8 tokens, then ``steps`` decode steps through the
    kernel and, from a copy of the same state, through the plain attention;
    the same tokens feed both.  Returns the comparison."""
    import torch

    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import decode_attention_ref

    cfg = model.cfg
    prompt = torch.randint(1, cfg.vocab, (4, 8), generator=gen, device=dev)
    st_k = model.init_decode_state(4, 96, dev)
    logits, st_k = model.prefill(params, prompt, st_k)
    st_p = type(st_k)(kv={n: t.clone() for n, t in st_k.kv.items()},
                      length=st_k.length.clone())
    tok = logits.argmax(-1).to(torch.int32)
    launcher = ops.decode_attention_cuda
    out = dict(steps=steps, batch=4, prompt_len=8, max_abs_err=0.0, max_rel_logit_err=0.0,
               allclose=True, finite=True, argmax_agree=0, launches_per_step=[],
               step_ms=[])
    for _ in range(steps):
        k1.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, st_k = model.decode_step(params, st_k, tok)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches_per_step"].append(k1.LAUNCHES.count)
        ops.decode_attention_cuda = lambda q, k, v, lengths, **kw: decode_attention_ref(
            q, k, v, lengths, **kw)
        try:
            lp, st_p = model.decode_step(params, st_p, tok)
        finally:
            ops.decode_attention_cuda = launcher
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
    check(out["launches_per_step"] == [cfg.n_layers] * steps,
          "a decode step did not launch the kernel once per layer")
    return out


def profile_decode(model, params, dev, steps: int = 3):
    """torch.profiler over ``steps`` decode steps at batch 4: wall time per
    step, device kernel time per step, and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    st = model.init_decode_state(4, 96, dev)
    _, st = model.prefill(params, torch.ones(4, 8, dtype=torch.int64, device=dev), st)
    tok = torch.ones(4, dtype=torch.int32, device=dev)
    model.decode_step(params, st, tok)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, st = model.decode_step(params, st, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return dict(
        steps=steps, layers=cfg.n_layers, wall_ms_per_step=wall / steps * 1e3,
        device_ms_per_step=dev_us / steps / 1e3,
        device_busy_share=dev_us / 1e6 / wall,
        kernel_launches_per_step=sum(e.count for e in events) / steps,
        top_kernels=[dict(name=e.key[:60], ms_per_step=e.self_device_time_total / steps / 1e3,
                          calls_per_step=e.count / steps) for e in top],
    )


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


if __name__ == "__main__":
    main()
