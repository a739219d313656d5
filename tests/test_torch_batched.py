"""Port parity: the batched sweep lane (repro_torch.memsim.batched) against
the reference's (repro.memsim.batched) on the CPU.

The port's plain float64 solvers are held to the reference's numpy solvers
to rel 1e-12, and to its f32 Pallas solvers (interpreted on the CPU) by the
reference's own bounds: the same +inf / isfinite(lam) masks and rel 2e-3.
Planning (exported state, stacked arrays) must be equal, the vector ladder
decision-identical, and the whole lane within rel 1e-6 of the reference's
numpy lane with identical decision phases.  The Hopper kernels run only on
the card; chip_smoke.py holds them against these plain versions there."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.controller import VectorMikuLadder as RefLadder
from repro.core.des import TieredMemorySim
from repro.core.des import WorkloadSpec as RefSpec
from repro.core.device_model import PLATFORMS as REF_PLATFORMS
from repro.core.device_model import platform_a as ref_platform_a
from repro.core.littles_law import OpClass as RefOp
from repro.core.littles_law import TierCounters
from repro.memsim.batched import kernel as ref_kernel
from repro.memsim.batched.lane import run_sweep_batched as ref_run_sweep_batched
from repro.memsim.batched.stacking import BatchGroup as RefGroup
from repro.memsim.batched.stacking import plan_cell as ref_plan_cell
from repro.memsim.calibration import default_miku as ref_default_miku
from repro.memsim.sweep import SimJob as RefJob
from repro.memsim.sweep import run_sweep as ref_run_sweep
from repro.memsim.workloads import bw_test as ref_bw_test
from repro.scenarios import plan as ref_plan
from repro.scenarios import run_scenario as ref_run_scenario
from repro_torch.core.controller import VectorMikuLadder
from repro_torch.core.des import WorkloadSpec, export_state
from repro_torch.core.device_model import PLATFORMS, platform_a
from repro_torch.core.invariants import InvariantViolation
from repro_torch.core.littles_law import OpClass
from repro_torch.kernels import fluid_solver
from repro_torch.kernels.ref import (
    fused_window_solve_ref,
    global_lambda_ref,
    speculative_bisect_ref,
    station_lambdas_ref,
)
from repro_torch.memsim.batched import fluid, kernel
from repro_torch.memsim.batched.lane import partition_jobs, run_sweep_batched
from repro_torch.memsim.batched.stacking import BatchGroup, plan_cell
from repro_torch.memsim.calibration import default_miku
from repro_torch.memsim.sweep import SimJob, run_sweep
from repro_torch.memsim.workloads import bw_test
from repro_torch.scenarios import plan, run_scenario

# Tiny tensors: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

# mlp 160: at mlp 96 no cell of this reduced grid restricts a window.
REDUCED_SWEEP = {"threads": (2, 16), "mlp": (160,), "sim_ns": 100_000.0}


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _glam_inputs(seed, C=6, W=3, pad=0):
    """tests/test_batched.py::test_pallas_backend_matches_numpy's inputs
    (seed 3), or a seeded variant whose last ``pad`` workload slots are
    padding (A = 0, cap = 0)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(1, 16, (C, W))
    cap = rng.uniform(0.05, 3.0, (C, W))
    y_sta = rng.uniform(0.05, 2.0, (C, W))
    o_eff = rng.uniform(20, 640, (C, W))
    R_tor = rng.uniform(150, 2500, (C, W))
    tor = rng.uniform(64, 512, C)
    irq = np.full(C, 64.0)
    if pad:
        A[:, -pad:] = cap[:, -pad:] = y_sta[:, -pad:] = o_eff[:, -pad:] = 0.0
    return A, cap, y_sta, o_eff, R_tor, tor, irq


GLAM_CASES = [(3, 6, 3, 0), (11, 17, 2, 0), (12, 9, 4, 1), (13, 32, 8, 3), (14, 5, 1, 0)]


def _assert_same_inf(port, ref, rel):
    finite = np.isfinite(ref)
    assert (np.isfinite(port) == finite).all()
    assert port[finite] == pytest.approx(ref[finite], rel=rel)


# -- (a) plain versions == the reference's numpy solvers -----------------------


@pytest.mark.parametrize("seed,C,W,pad", GLAM_CASES)
def test_global_lambda_ref_matches_reference_numpy(seed, C, W, pad):
    args = _glam_inputs(seed, C, W, pad)
    ref = ref_kernel._global_lambda_numpy(*args)
    port = global_lambda_ref(*map(_t, args)).numpy()
    _assert_same_inf(port, ref, rel=1e-12)
    # The dispatcher's CPU route is the plain version.
    assert np.array_equal(kernel.global_lambda(*map(_t, args)).numpy(), port)


@pytest.mark.parametrize("seed,C,W,S,pad_w,pad_s",
                         [(5, 6, 3, 4, 0, 0), (6, 16, 2, 3, 0, 0),
                          (7, 9, 4, 5, 1, 2), (8, 32, 8, 8, 2, 1)])
def test_station_lambdas_ref_matches_reference_numpy(seed, C, W, S, pad_w, pad_s):
    rng = np.random.default_rng(seed)
    A = rng.uniform(1, 16, (C, W))
    cap = rng.uniform(0.05, 3.0, (C, W))
    route_svc = rng.uniform(0.0, 200.0, (C, W, S)) * (rng.random((C, W, S)) < 0.7)
    slots = rng.uniform(8, 256, (C, S))
    if pad_w:
        A[:, -pad_w:] = cap[:, -pad_w:] = route_svc[:, -pad_w:] = 0.0
    if pad_s:
        slots[:, -pad_s:] = route_svc[:, :, -pad_s:] = 0.0
    ref = ref_kernel.station_lambdas(A, cap, route_svc, slots)
    port = station_lambdas_ref(*map(_t, (A, cap, route_svc, slots))).numpy()
    assert np.isinf(port).any() and np.isfinite(port).any()
    _assert_same_inf(port, ref, rel=1e-12)
    assert np.array_equal(kernel.station_lambdas(*map(_t, (A, cap, route_svc, slots)))
                          .numpy(), port)


# -- (b) the plain version against the reference's f32 Pallas kernel ------------


@pytest.mark.parametrize("seed,C,W,pad", GLAM_CASES)
def test_global_lambda_ref_matches_reference_pallas(seed, C, W, pad):
    args = _glam_inputs(seed, C, W, pad)
    pallas = ref_kernel.global_lambda(*args, force_backend="pallas")
    port = global_lambda_ref(*map(_t, args)).numpy()
    _assert_same_inf(port, pallas, rel=2e-3)


# -- (c) the plain fused solver against the reference's fused solver -----------


def _captured_windows(overrides, monkeypatch):
    """The fused_window_solve inputs of every window of a port lane run on
    the CPU (float64 tensors), in call order."""
    calls = []
    solve = kernel.fused_window_solve

    def record(*args):
        calls.append(args)
        return solve(*args)

    monkeypatch.setattr(fluid.kernel, "fused_window_solve", record)
    jobs = [j for _, _, js in plan("corun_sweep", overrides) for j in js]
    run_sweep_batched(jobs, device="cpu")
    return calls


def test_fused_window_solve_ref_matches_reference_fused(monkeypatch):
    overrides = {"threads": (2, 16), "mlp": (96, 160), "op": "load,store",
                 "sim_ns": 10_000.0}
    calls = _captured_windows(overrides, monkeypatch)
    assert len(calls) == 2  # one window each of the no-MIKU and MIKU groups
    for args in calls:
        numpy_args = [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]
        y_f, wq_f, lam_f = ref_kernel.fused_window_solve(*numpy_args)
        y_p, wq_p, lam_p = (t.numpy() for t in fused_window_solve_ref(*args))
        assert (np.isfinite(lam_p) == np.isfinite(lam_f)).all()
        assert y_p == pytest.approx(y_f, rel=2e-3)
        assert np.isfinite(lam_p).any()  # the grid has coupled cells


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_random_window_gate_is_one_the_reference_f32_solver_meets():
    """chip_smoke.py holds the f32 kernel to the float64 plain version on
    seeded random windows by the same isfinite(lam) mask on every cell and
    at most K3_RANDOM_MAX_SHARE_BEYOND of the cells beyond rel 2e-3.  On the
    same windows the reference's own f32 fused solver meets that gate, and
    does not meet rel 2e-3 on every cell: the relaxation's thresholds make a
    few cells land elsewhere in any f32 arithmetic."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)  # chip_smoke.k3_check's seed
    beyond = cells = 0
    for C, W, S, pad_w, pad_s in cs.K3_RANDOM_CASES:
        args = cs.f32_rounded(cs.random_window_inputs(rng, C, W, S, pad_w, pad_s))
        y_f, wq_f, lam_f = ref_kernel.fused_window_solve(*args, 30, 0.5)
        y_p, wq_p, lam_p = (t.numpy() for t in fused_window_solve_ref(*map(_t, args),
                                                                       30, 0.5))
        assert (np.isfinite(lam_f) == np.isfinite(lam_p)).all()
        err = np.maximum(
            (np.abs(y_f - y_p) / np.maximum(np.abs(y_p), 1e-12)).max(axis=1),
            (np.abs(wq_f - wq_p) / np.maximum(np.abs(wq_p), 1e-12)).max(axis=1))
        beyond += int((err > 2e-3).sum())
        cells += C
    assert 0 < beyond <= cs.K3_RANDOM_MAX_SHARE_BEYOND * cells


# -- (c') the kernels' speculative bisection equals the sequential one ---------


def _sequential_bisect(pred, lo, hi, iters):
    """The f32 bisection the kernels' rounds replace, one step at a time."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = pred(mid)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo


def _f32(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _threshold_problem():
    """Seeded thresholds inside, at and beyond the bracket."""
    rng = np.random.default_rng(21)
    hi = _f32(rng.uniform(1.0, 1e4, 64))
    thr = _f32(rng.uniform(-10.0, 1.1e4, 64))
    thr[:4] = torch.stack([hi[0], hi[1] * 0.5, torch.tensor(0.0), hi[3] * 0.25])
    return (lambda lam: lam <= thr), torch.zeros_like(hi), hi


def _station_problem():
    """The station-demand predicate of all S = 3 stations at once, on
    test_station_lambdas_ref_matches_reference_numpy's inputs (seed 6) in
    f32, summed over workloads in the kernel's order."""
    rng = np.random.default_rng(6)
    C, W, S = 16, 2, 3
    A = _f32(rng.uniform(1, 16, (C, W)))
    cap = _f32(rng.uniform(0.05, 3.0, (C, W)))
    route_svc = _f32(rng.uniform(0.0, 200.0, (C, W, S)) * (rng.random((C, W, S)) < 0.7))
    limit = _f32(rng.uniform(8, 256, (C, S))) + 1e-9

    def pred(lam):  # lam (C, S)
        d = torch.zeros_like(lam)
        for w in range(W):
            d = d + torch.minimum(lam * A[:, w, None], cap[:, w, None]) * route_svc[:, w]
        return d <= limit

    hi0 = (cap / A.clamp(min=1e-12)).amax(dim=1) + 1e-6
    return pred, torch.zeros(C, S), hi0[:, None].expand(C, S).clone()


def _glam_problem(seed, C, W, pad):
    """The global-lambda feasibility test in f32 on a GLAM_CASES input, as
    csrc/fluid_solver.cu::glam_feasible computes it."""
    A, cap, y_sta, o_eff, R_tor, tor, irq = map(_f32, _glam_inputs(seed, C, W, pad))

    def pred(lam):
        ys, clamped, unc = [], [], []
        ysum = torch.zeros_like(lam)
        for w in range(W):
            y_free = torch.minimum(lam * A[:, w], cap[:, w])
            ys.append(torch.minimum(y_free, y_sta[:, w]))
            clamped.append(y_sta[:, w] < y_free * (1.0 - 1e-9))
            unc.append(torch.minimum(o_eff[:, w], ys[w] * R_tor[:, w]))
            ysum = ysum + ys[w]
        denom = ysum.clamp(min=1e-12)
        pop = torch.zeros_like(lam)
        for w in range(W):
            share = ys[w] / denom
            pop = pop + torch.where(
                clamped[w], torch.maximum(o_eff[:, w] - irq * share, unc[w]), unc[w])
        return pop <= tor + 1e-9

    hi0 = (cap / A.clamp(min=1e-12)).amax(dim=1) + 1e-6
    return pred, torch.zeros(C), hi0


BISECT_PROBLEMS = {"thresholds": _threshold_problem, "station_demand": _station_problem}
BISECT_PROBLEMS.update({f"glam_seed{c[0]}": (lambda c=c: _glam_problem(*c))
                        for c in GLAM_CASES})


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("problem", sorted(BISECT_PROBLEMS))
def test_speculative_bisection_is_the_sequential_one_bit_for_bit(problem, levels):
    pred, lo, hi = BISECT_PROBLEMS[problem]()
    assert lo.dtype == hi.dtype == torch.float32
    want = _sequential_bisect(pred, lo, hi, 48)
    got = speculative_bisect_ref(pred, lo, hi, 48, levels)
    assert torch.equal(got, want)
    # The brackets really move: some predicate values are true, some false.
    assert (want > lo).any() and (want < hi).any()


def test_kernel_round_counts():
    """The rounds of the kernels' scheme at corun_sweep's S = 3, counted as
    predicate calls of its plain version: 16 station rounds of 3 levels
    (3 x 48 sequential steps before), each 7 nodes; 10 global-lambda rounds
    (48 steps before), 9 of 5 levels (31 nodes) and one of the last 3."""
    for levels, calls in ((3, 16 * 7), (5, 9 * 31 + 7)):
        seen = []

        def pred(mid):
            seen.append(mid)
            return mid < 0.3

        speculative_bisect_ref(pred, torch.zeros(4), torch.ones(4), 48, levels)
        assert len(seen) == calls


# -- (d) planning: exported state and stacked arrays ---------------------------


def test_export_state_and_batch_group_match_reference():
    ref_jobs = [j for _, _, js in ref_plan("corun_sweep") for j in js]
    port_jobs = [j for _, _, js in plan("corun_sweep") for j in js]
    assert len(ref_jobs) == len(port_jobs) == 96
    ref_plans = [ref_plan_cell(j) for j in ref_jobs]
    port_plans = [plan_cell(j) for j in port_jobs]
    for rj, rp, pp in zip(ref_jobs, ref_plans, port_plans):
        sim = TieredMemorySim(rj.platform, rj.workloads, seed=rj.seed,
                              granularity=rj.granularity, window_ns=rj.window_ns)
        assert pp.export == sim.export_state() == rp.export
        assert len(pp.units) == len(rp.units)
        for pu, ru in zip(pp.units, rp.units):
            assert tuple(pu.config.levels) == tuple(ru.config.levels)
            assert {c.value: v for c, v in pu.config.class_caps.items()} == \
                {c.value: v for c, v in ru.config.class_caps.items()}
            pe, re_ = pu.estimator.config, ru.estimator.config
            assert (pe.t_fast, pe.slow_read_threshold, pe.ewma) == \
                (re_.t_fast, re_.slow_read_threshold, re_.ewma)
    for miku in (False, True):
        idx = [i for i, j in enumerate(port_jobs) if j.miku == miku]
        rg = RefGroup([(i, ref_plans[i]) for i in idx])
        pg = BatchGroup([(i, port_plans[i]) for i in idx])
        for name in ("n_tiers_cell", "sim_ns", "tor_cap", "irq_cap", "slots", "pipe",
                     "active_w", "svc", "bytes_t", "p_llc", "tier_frac", "effmlp",
                     "cores", "managed", "op"):
            assert np.array_equal(getattr(pg, name), getattr(rg, name)), name
        assert (pg.window_ns, pg.n_tiers, pg.n_wl, pg.n_st, pg.llc, pg.phases) == \
            (rg.window_ns, rg.n_tiers, rg.n_wl, rg.n_st, rg.llc, rg.phases)


WORKLOAD_VARIANTS = {
    "ddr_fraction": dict(tier="ddr", ddr_fraction=0.3),
    "placement": dict(tier="ddr", placement={"ddr": 0.25, "cxl": 0.75}),
    "phases": dict(tier="ddr", phases=[(15_000.0, "cxl"), (25_000.0, "ddr")]),
    "llc_cat": dict(tier="cxl", llc_alloc_mb=8.0, wss_mb=64.0),
    "sync": dict(tier="ddr", sync=True, wss_mb=0.001, miku_managed=False),
    "dependent": dict(tier="cxl", dependent=True, wss_mb=512.0),
}


@pytest.mark.parametrize("variant", sorted(WORKLOAD_VARIANTS))
def test_export_state_matches_reference_for_workload_variants(variant):
    kw = WORKLOAD_VARIANTS[variant]
    op = "store" if variant == "sync" else "load"
    specs = [("x", kw), ("y", dict(tier="cxl", mlp=96))]
    port = export_state(platform_a(), [WorkloadSpec(name=n, op=OpClass(op), n_cores=4, **k)
                                       for n, k in specs], granularity=4, window_ns=10_000.0)
    ref = TieredMemorySim(ref_platform_a(), [RefSpec(name=n, op=RefOp(op), n_cores=4, **k)
                                             for n, k in specs],
                          granularity=4, window_ns=10_000.0).export_state()
    assert port == ref


def test_phased_and_interleaved_cells_match_reference_lane(monkeypatch):
    """Workloads whose routing changes within a run (phase schedules) or
    splits across tiers go through BatchGroup.window_fracs and the route
    construction like the reference's."""
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    phases = [(15_000.0, "cxl"), (25_000.0, "ddr")]
    cells = [
        [("a", dict(tier="ddr", phases=phases)), ("b", dict(tier="cxl"))],
        [("a", dict(tier="ddr", ddr_fraction=0.4)), ("b", dict(tier="cxl", llc_alloc_mb=8.0,
                                                               wss_mb=64.0))],
    ]
    ref_jobs, port_jobs = [], []
    for miku in (False, True):
        for spec in cells:
            ref_jobs.append(RefJob(platform=ref_platform_a(), sim_ns=80_000.0, miku=miku,
                                   workloads=[RefSpec(name=n, op=RefOp.LOAD, n_cores=8, **k)
                                              for n, k in spec]))
            port_jobs.append(SimJob(platform=platform_a(), sim_ns=80_000.0, miku=miku,
                                    workloads=[WorkloadSpec(name=n, op=OpClass.LOAD,
                                                            n_cores=8, **k)
                                               for n, k in spec]))
    ref = ref_run_sweep_batched(ref_jobs)
    port = run_sweep_batched(port_jobs, device="cpu")
    for r, p in zip(ref, port):
        for w in ("a", "b"):
            assert p.bandwidth(w) == pytest.approx(r.bandwidth(w), rel=1e-6)
        assert _phases(p) == _phases(r)


# -- (e) the vector ladder is decision-identical --------------------------------

_REF_OPS = tuple(RefOp)


def _counters(rng, scale=1.0) -> TierCounters:
    tc = TierCounters()
    tc.inserts = int(rng.integers(0, 400) * scale)
    tc.occupancy_time = tc.inserts * float(rng.uniform(100.0, 3000.0))
    if tc.inserts:
        split = rng.multinomial(tc.inserts, [0.5, 0.3, 0.15, 0.05])
        tc.class_counts = {op: int(n) for op, n in zip(_REF_OPS, split)}
    return tc


def _cls(tc: TierCounters) -> np.ndarray:
    return np.asarray([tc.class_counts.get(op, 0) for op in _REF_OPS], float)


@pytest.mark.parametrize("seed", [7, 8])
def test_vector_ladder_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n_cells, n_windows = 6, 60
    names = ["A", "B"] * (n_cells // 2)
    ref_units = []
    port_units = []
    for nm in names:
        r = ref_default_miku(REF_PLATFORMS[nm], 4)
        r._ensure_units(1, ["cxl"])
        ref_units.append(r.units[:1])
        p = default_miku(PLATFORMS[nm], 4)
        p._ensure_units(1, ["cxl"])
        port_units.append(p.units[:1])
    ref = RefLadder.from_units(ref_units)
    port = VectorMikuLadder.from_units(port_units, "cpu")
    for w in range(n_windows):
        fast = [_counters(rng, scale=rng.choice([0.0, 0.2, 1.0])) for _ in range(n_cells)]
        slow = [_counters(rng, scale=rng.choice([0.0, 1.0, 3.0])) for _ in range(n_cells)]
        arrays = (
            np.asarray([f.inserts for f in fast], float),
            np.asarray([f.occupancy_time for f in fast]),
            np.stack([_cls(f) for f in fast]),
            np.asarray([[s.inserts] for s in slow], float),
            np.asarray([[s.occupancy_time] for s in slow]),
            np.stack([_cls(s)[None] for s in slow]),
        )
        r = ref.window(*arrays)
        p = port.window(*map(_t, arrays))
        for key in ("restricted", "cap", "rate", "valid", "backlogged"):
            assert np.array_equal(p[key].numpy(), r[key]), (w, key)
        for key in ("t_avg", "alpha", "t_slow", "t_slow_raw", "threshold"):
            assert p[key].numpy() == pytest.approx(r[key], rel=1e-12, abs=1e-9), (w, key)


# -- (f) the whole lane against the reference's numpy lane ----------------------


def _phases(res):
    return [[d.phase.value for d in td.decisions] for td in res.decisions]


def test_run_sweep_batched_matches_reference_numpy_lane(monkeypatch):
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    ref_p, port_p = ref_platform_a(), platform_a()
    ref_jobs, port_jobs = [], []
    for op in ("load", "store"):
        for miku in (False, True):
            ref_jobs.append(RefJob(platform=ref_p, workloads=[
                ref_bw_test("ddr", RefOp(op), 16, name="ddr", miku_managed=False),
                ref_bw_test("cxl", RefOp(op), 16, name="cxl")],
                sim_ns=150_000.0, miku=miku))
            port_jobs.append(SimJob(platform=port_p, workloads=[
                bw_test("ddr", OpClass(op), 16, name="ddr", miku_managed=False),
                bw_test("cxl", OpClass(op), 16, name="cxl")],
                sim_ns=150_000.0, miku=miku))
    ref = ref_run_sweep_batched(ref_jobs)
    port = run_sweep(port_jobs, device="cpu")
    assert sum(len(r.decisions) for r in ref) > 0
    for r, p in zip(ref, port):
        for w in ("ddr", "cxl"):
            assert p.bandwidth(w) == pytest.approx(r.bandwidth(w), rel=1e-6)
        assert sum(d.restricted for d in p.decisions) == \
            sum(d.restricted for d in r.decisions)
        assert _phases(p) == _phases(r)
        assert p.tor_inserts == r.tor_inserts and p.tor_peak == r.tor_peak
        assert p.tor_occupancy_integral == pytest.approx(r.tor_occupancy_integral, rel=1e-6)
        for t in ("ddr", "cxl"):
            assert p.tier_counters[t].inserts == r.tier_counters[t].inserts
            assert p.per_tier_occupancy_integral[t] == pytest.approx(
                r.per_tier_occupancy_integral[t], rel=1e-6)
        assert [t for t, _ in p.stats["cxl"].timeline] == \
            [t for t, _ in r.stats["cxl"].timeline]


def test_run_scenario_rows_match_reference(monkeypatch):
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    ref_rows = ref_run_scenario("corun_sweep", REDUCED_SWEEP, lane="batched").rows
    rows = run_scenario("corun_sweep", REDUCED_SWEEP, device="cpu")
    assert len(rows) == len(ref_rows) == 24
    assert any(r["restricted_windows"] for r in ref_rows)
    for r, p in zip(ref_rows, rows):
        for key in ("platform", "op", "threads", "mlp", "miku", "restricted_windows"):
            assert p[key] == r[key], key
        for key in ("ddr_gbps", "cxl_gbps"):
            assert p[key] == pytest.approx(r[key], rel=1e-6)


# -- what the port refuses, and the CUDA wrappers' checks -----------------------


def test_lane_refuses_what_is_still_not_ported():
    """The per-edge law (it needs the fabric) is still refused, and named;
    the scalar lane now runs and equals the reference's.  The merged law
    and per-window telemetry run batched (tests/test_torch_corun3.py and
    tests/test_torch_fig13_14.py hold them to the reference)."""
    p = platform_a()
    two = [bw_test("ddr", OpClass.LOAD, 4, name="ddr", miku_managed=False),
           bw_test("cxl", OpClass.LOAD, 4, name="cxl")]
    single = SimJob(platform=p, workloads=[bw_test("ddr", OpClass.LOAD, 16)],
                    sim_ns=20_000.0)
    merged = SimJob(platform=p, workloads=two, sim_ns=20_000.0, miku=True,
                    miku_law="merged")
    windows = SimJob(platform=p, workloads=two, sim_ns=20_000.0, record_windows=True)
    peredge = SimJob(platform=p, workloads=two, sim_ns=20_000.0, miku=True,
                     miku_law="peredge")
    plans, refused = partition_jobs([single, merged, windows, peredge])
    assert [i for i, _ in refused] == [3]
    assert "miku_law" in refused[0][1] and "fabric" in refused[0][1]
    assert plans[1].merged and len(plans[1].units) == 1 and plans[3] is None
    with pytest.raises(NotImplementedError, match="peredge"):
        run_sweep_batched([peredge], device="cpu")
    (got,) = run_sweep([single], lane="scalar", device="cpu")
    ref_single = RefJob(platform=ref_platform_a(),
                        workloads=[ref_bw_test("ddr", RefOp.LOAD, 16)], sim_ns=20_000.0)
    (want,) = ref_run_sweep([ref_single], lane="scalar")
    name = single.workloads[0].name
    assert (got.stats[name].completed, got.stats[name].latency_samples, got.tor_inserts) \
        == (want.stats[name].completed, want.stats[name].latency_samples, want.tor_inserts)
    assert got.bandwidth(name) == want.bandwidth(name) > 0
    with pytest.raises(ValueError, match="miku_law"):
        SimJob(platform=p, workloads=two, sim_ns=1.0, miku_law="bogus")


def test_lane_runs_the_exact_cell_and_latency_hist_job_it_used_to_refuse(monkeypatch):
    """The single-workload cell (the exact lane) and the two-workload
    latency_hist job (the fluid lane's analytic histograms) run and match
    the reference's lane: the exact cell bit for bit, the fluid job to
    rel 1e-6, the histograms' p95 within their 1/16 bucket width."""
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    ref_p, p = ref_platform_a(), platform_a()
    ref_jobs = [
        RefJob(platform=ref_p, workloads=[ref_bw_test("ddr", RefOp.LOAD, 16)],
               sim_ns=20_000.0),
        RefJob(platform=ref_p, workloads=[
            ref_bw_test("ddr", RefOp.LOAD, 4, name="ddr", miku_managed=False),
            ref_bw_test("cxl", RefOp.LOAD, 4, name="cxl")], sim_ns=20_000.0,
            latency_hist=True)]
    jobs = [
        SimJob(platform=p, workloads=[bw_test("ddr", OpClass.LOAD, 16)], sim_ns=20_000.0),
        SimJob(platform=p, workloads=[
            bw_test("ddr", OpClass.LOAD, 4, name="ddr", miku_managed=False),
            bw_test("cxl", OpClass.LOAD, 4, name="cxl")], sim_ns=20_000.0,
            latency_hist=True)]
    assert partition_jobs(jobs)[1] == []
    (r_exact, r_fluid), (exact, fluid_res) = ref_run_sweep_batched(ref_jobs), \
        run_sweep_batched(jobs, device="cpu")
    name = "bw-ddr-load-16t"
    assert exact.stats[name].completed == r_exact.stats[name].completed > 0
    assert exact.bandwidth(name) == r_exact.bandwidth(name)
    assert exact.stats[name].timeline == r_exact.stats[name].timeline
    assert exact.tor_inserts == r_exact.tor_inserts
    for w in ("ddr", "cxl"):
        assert fluid_res.bandwidth(w) == pytest.approx(r_fluid.bandwidth(w), rel=1e-6)
        h, rh = fluid_res.stats[w].latency_hist, r_fluid.stats[w].latency_hist
        assert h.n == pytest.approx(rh.n, rel=1e-6)
        assert h.percentile(0.95) == pytest.approx(rh.percentile(0.95), rel=1 / 16)
    for t in ("ddr", "cxl"):
        assert fluid_res.tier_latency_hist[t].percentile(0.95) == pytest.approx(
            r_fluid.tier_latency_hist[t].percentile(0.95), rel=1 / 16)


def test_cuda_wrappers_reject_cpu_tensors_without_launching():
    args = list(map(_t, _glam_inputs(3)))
    before = (fluid_solver.GLOBAL_LAMBDA_LAUNCHES.count,
              fluid_solver.WINDOW_SOLVE_LAUNCHES.count)
    with pytest.raises(InvariantViolation, match="CUDA"):
        fluid_solver.global_lambda_cuda(*args)
    C, W, S = 4, 2, 3
    z = torch.zeros
    with pytest.raises(InvariantViolation, match="CUDA"):
        fluid_solver.fused_window_solve_cuda(
            z(C, W), z(C, W), z(C, W), z(C, W, S), z(C, W, S), z(C, W, S), z(C, S),
            z(C), z(C), z(C, S), 30, 0.5)
    assert (fluid_solver.GLOBAL_LAMBDA_LAUNCHES.count,
            fluid_solver.WINDOW_SOLVE_LAUNCHES.count) == before


def test_sweep_cli_prints_rows_on_cpu(capsys):
    from repro_torch.launch.sweep import main

    main(["corun_sweep", "--set", "threads=2", "--set", "mlp=96", "--set", "op=load",
          "--set", "platform=A", "--set", "sim_ns=20000", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "platform,op,threads,mlp,miku,ddr_gbps,cxl_gbps,restricted_windows"
    assert len(lines) == 3 and lines[1].startswith("A,load,2,96,False,")
