"""The port's scenario registry: the paper's figures it can run.

Copies of the reference's scenarios (``repro/scenarios/library.py``), in
its declaration order: ``fig2_tiering`` (a ``run_cell`` scenario on the
scalar DES), the grid figures fig3-fig10 and ``loaded_latency``
(their single-workload cells take the exact lane, the rest the fluid
engine), the §6 case study ``fig11_llm`` (a ``run_cell`` scenario on the
port's serving engines), the big-data and hashmap figures fig13 and fig14,
the three-tier co-runs on ``A-switch`` (``corun3_switch``, and
``corun3_pertier`` with the per-tier and merged laws), the co-run sweeps,
the tiering subsystem's ``migrate_interference`` (page migration as a
MIKU-governed request class) and ``tiering_policies`` (hot-set drift
against the tiering policy), the NUMA-remote striping study on
``A-numa``, the routed fabric's ``fabric_spine_congestion``,
``fabric_port_overflow`` and ``fabric_miku`` (each cell builds its platform
from its topology axes), and the open-loop SLO studies ``slo_knee`` and
``flash_crowd``.  The fabric and open-loop jobs run on the scalar DES: the
batched lane sends them there by name.  The port keeps its own registry
(:data:`SCENARIOS`), all 25 of the reference's, and registers nothing into
the reference's.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core.des import WorkloadSpec
from repro_torch.core.device_model import PlatformModel
from repro_torch.core.littles_law import OpClass
from repro_torch.fabric import single_switch_platform, spine_leaf_platform
from repro_torch.memsim.sweep import SimJob, run_sweep
from repro_torch.memsim.workloads import (alternating_bw_pair, bw_test, lat_share, lat_test,
                                          serve_test)
from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.scenarios.spec import Axis, Metric, Scenario
from repro_torch.tiering import HotSetPattern, RegionSpec, TieringSpec
from repro_torch.workload import ArrivalSpec

_BW_SIM_NS = 120_000.0
_CORUN_SIM_NS = 300_000.0

_OPS = (OpClass.LOAD, OpClass.STORE, OpClass.NT_STORE)  # never MIGRATE
_TWO_TIERS = ("ddr", "cxl")


def _job(
    platform: PlatformModel,
    workloads: List[WorkloadSpec],
    sim_ns: float,
    *,
    miku: bool = False,
    seed: int = 0,
    granularity: int = 4,
    window_ns: float = 10_000.0,
    miku_law: str = "pertier",
    tiering=None,
    latency_hist: bool = False,
    record_windows: bool = False,
) -> SimJob:
    return SimJob(
        platform=platform,
        workloads=workloads,
        sim_ns=sim_ns,
        seed=seed,
        granularity=granularity,
        window_ns=window_ns,
        miku=miku,
        miku_law=miku_law,
        latency_hist=latency_hist,
        record_windows=record_windows,
        tiering=tiering,
    )


def _platform_axis(default="A") -> Axis:
    return Axis("platform", default,
                help="platform name (repro_torch.core.device_model.PLATFORMS)")


def _op_axis(default=_OPS) -> Axis:
    return Axis("op", default, help="memory instruction class", parse=OpClass)


# -- Fig. 2: tiered memory management schemes ----------------------------------


def _fig2_run_cell(platform, cell, device) -> List[dict]:
    """Two stages: measure the upper/lower split first, then run the
    placement schemes at the measured interleave fraction (why this is a
    ``run_cell`` scenario, not a static grid).  Both stages run on the
    scalar DES, as the reference pins them; ``device`` is unused."""
    del device
    op = cell["op"]
    out: Dict[str, float] = {}
    up, low = run_sweep(
        [
            _job(platform, [bw_test("ddr", op, 16, name="a")], _BW_SIM_NS),
            _job(platform, [bw_test("cxl", op, 16, name="a")], _BW_SIM_NS),
        ],
        lane="scalar",
    )
    out["upper_ddr_only"] = up.bandwidth("a")
    out["lower_cxl_only"] = low.bandwidth("a")
    frac = out["upper_ddr_only"] / max(out["upper_ddr_only"] + out["lower_cxl_only"], 1e-9)
    migration = WorkloadSpec(name="kmigrated", op=OpClass.STORE, tier="cxl", n_cores=2,
                             mlp=64, ddr_fraction=0.5, miku_managed=False)
    interleaved = [
        bw_test("ddr", op, 16, name="a", ddr_fraction=frac, miku_managed=False),
        bw_test("cxl", op, 16, name="b", ddr_fraction=frac, miku_managed=False),
    ]
    nat, inter, osm = run_sweep(
        [
            _job(platform, [bw_test("ddr", op, 16, name="a", miku_managed=False),
                            bw_test("cxl", op, 16, name="b")], _CORUN_SIM_NS),
            _job(platform, interleaved, _CORUN_SIM_NS),
            _job(platform, interleaved + [migration], _CORUN_SIM_NS),
        ],
        lane="scalar",
    )
    out["native"] = nat.bandwidth("a") + nat.bandwidth("b")
    out["interleave"] = inter.bandwidth("a") + inter.bandwidth("b")
    out["os_managed"] = osm.bandwidth("a") + osm.bandwidth("b")
    out["ideal_combined"] = out["upper_ddr_only"] + out["lower_cxl_only"]
    return [{"platform": cell["platform"], "op": op.value, **out}]


# -- Fig. 3: single-threaded and peak bandwidth per tier ----------------------


def _fig3_build(platform, cell) -> List[SimJob]:
    wl = bw_test(cell["tier"], cell["op"], cell["threads"])
    return [_job(platform, [wl], _BW_SIM_NS)]


def _fig3_reduce(platform, cell, jobs, results) -> List[dict]:
    (job,), (res,) = jobs, results
    return [{
        "platform": cell["platform"],
        "op": cell["op"].value,
        "tier": cell["tier"],
        "threads": cell["threads"],
        "bandwidth_gbps": res.bandwidth(job.workloads[0].name),
        "peak_model_gbps":
            platform.device_for(cell["tier"]).peak_bandwidth_gbps(cell["op"]),
    }]


# -- Fig. 4 and loaded latency: average and tail latency ----------------------


def _latency_row(st) -> dict:
    """avg, p50 and p99 from the sample; p95 from the histogram (within
    its 1/16 bucket width)."""
    hist = st.latency_hist
    return {
        "avg_ns": st.mean_latency_ns(),
        "p50_ns": st.percentile_ns(0.50),
        "p95_ns": hist.percentile(0.95) if hist is not None else 0.0,
        "p99_ns": st.percentile_ns(0.99),
    }


def _fig4_build(platform, cell) -> List[SimJob]:
    wl = lat_test(cell["tier"], OpClass.LOAD, cell["threads"])
    return [_job(platform, [wl], 400_000.0, granularity=1, latency_hist=True)]


def _fig4_reduce(platform, cell, jobs, results) -> List[dict]:
    (job,), (res,) = jobs, results
    return [{
        "platform": cell["platform"],
        "tier": cell["tier"],
        "threads": cell["threads"],
        **_latency_row(res.stats[job.workloads[0].name]),
    }]


def _loaded_lat_build(platform, cell) -> List[SimJob]:
    wls = [lat_test(cell["tier"], OpClass.LOAD, 1, name="probe")]
    n = cell["load_threads"]
    if n > 0:
        wls.append(bw_test(cell["tier"], cell["op"], n, name="load", miku_managed=False))
    return [_job(platform, wls, 400_000.0, granularity=1, latency_hist=True)]


def _loaded_lat_reduce(platform, cell, jobs, results) -> List[dict]:
    (res,) = results
    return [{
        "platform": cell["platform"],
        "tier": cell["tier"],
        "load_threads": cell["load_threads"],
        "load_gbps": res.bandwidth("load") if cell["load_threads"] > 0 else 0.0,
        **_latency_row(res.stats["probe"]),
    }]


# -- Fig. 5 + 6: co-run collapse and ToR accounting ---------------------------


def _fig5_build(platform, cell) -> List[SimJob]:
    op, n = cell["op"], cell["n_threads"]
    a = bw_test("ddr", op, n, name="ddr", miku_managed=False)
    c = bw_test("cxl", op, n, name="cxl")
    return [
        _job(platform, [a], _BW_SIM_NS),
        _job(platform, [c], _BW_SIM_NS),
        _job(platform, [a, c], _CORUN_SIM_NS),
    ]


def _fig5_reduce(platform, cell, jobs, results) -> List[dict]:
    alone, cxl_alone, both = results
    ddr_alone_bw = alone.bandwidth("ddr")
    return [{
        "platform": cell["platform"],
        "op": cell["op"].value,
        "ddr_alone_gbps": ddr_alone_bw,
        "cxl_alone_gbps": cxl_alone.bandwidth("cxl"),
        "ddr_corun_gbps": both.bandwidth("ddr"),
        "cxl_corun_gbps": both.bandwidth("cxl"),
        "ddr_loss_pct": 100.0 * (1 - both.bandwidth("ddr") / ddr_alone_bw),
        # Fig. 6 quantities:
        "tor_insert_rate_alone_per_ns": alone.tor_inserts / alone.sim_ns,
        "tor_insert_rate_corun_per_ns": both.tor_inserts / both.sim_ns,
        "tor_avg_latency_alone_ns": alone.tor_avg_latency_ns,
        "tor_avg_latency_corun_ns": both.tor_avg_latency_ns,
        "t_ddr_corun_ns": both.tier_counters["ddr"].mean_service_time,
        "t_cxl_corun_ns": both.tier_counters["cxl"].mean_service_time,
    }]


def _fig6_build(platform, cell) -> List[SimJob]:
    jobs = []
    for op in _OPS:
        for scenario in ("ddr", "cxl", "both"):
            wls: List[WorkloadSpec] = []
            if scenario in ("ddr", "both"):
                wls.append(bw_test("ddr", op, 16, name="ddr", miku_managed=False))
            if scenario in ("cxl", "both"):
                wls.append(bw_test("cxl", op, 16, name="cxl"))
            jobs.append(_job(platform, wls, _BW_SIM_NS))
    return jobs


def _fig6_reduce(platform, cell, jobs, results) -> List[dict]:
    xs, ys = [], []
    for job, res in zip(jobs, results):
        xs.append(res.tor_inserts / res.sim_ns)
        ys.append(sum(res.bandwidth(w.name) for w in job.workloads))
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    vx = sum((x - mx) ** 2 for x in xs) ** 0.5
    vy = sum((y - my) ** 2 for y in ys) ** 0.5
    return [{"platform": cell["platform"], "pearson_r": cov / max(vx * vy, 1e-12)}]


# -- Fig. 7: LLC partitioning (Intel CAT analogue) ----------------------------


def _fig7_build(platform, cell) -> List[SimJob]:
    cap = platform.llc_capacity_mb
    alloc, wss_mb = cell["ddr_share"], cell["wss_mb"]
    a = bw_test("ddr", OpClass.STORE, 16, name="ddr", wss_mb=wss_mb,
                llc_alloc_mb=alloc * cap, miku_managed=False)
    b = bw_test("cxl", OpClass.STORE, 16, name="cxl", wss_mb=wss_mb,
                llc_alloc_mb=(1.0 - alloc) * cap, miku_managed=False)
    return [_job(platform, [a, b], _CORUN_SIM_NS)]


def _fig7_reduce(platform, cell, jobs, results) -> List[dict]:
    (res,) = results
    return [{
        "platform": cell["platform"],
        "wss_mb": cell["wss_mb"],
        "ddr_llc_share": cell["ddr_share"],
        "ddr_gbps": res.bandwidth("ddr"),
        "cxl_gbps": res.bandwidth("cxl"),
        "total_gbps": res.bandwidth("ddr") + res.bandwidth("cxl"),
    }]


# -- Fig. 8: inter-core synchronization ---------------------------------------


def _fig8_build(platform, cell) -> List[SimJob]:
    wls = [lat_share()]
    if cell["bg_threads"] > 0:
        wls.append(bw_test(cell["bg_tier"], OpClass.LOAD, cell["bg_threads"],
                           name="bg", miku_managed=False))
    return [_job(platform, wls, 200_000.0, granularity=1)]


def _fig8_reduce(platform, cell, jobs, results) -> List[dict]:
    (res,) = results
    return [{
        "platform": cell["platform"],
        "bg_tier": cell["bg_tier"],
        "bg_threads": cell["bg_threads"],
        "cas_latency_ns": res.stats["lat-share"].mean_latency_ns(),
    }]


# -- Fig. 9: service time vs concurrency --------------------------------------

_fig9_build = _fig3_build  # the same single bw-test job


def _fig9_reduce(platform, cell, jobs, results) -> List[dict]:
    (job,), (res,) = jobs, results
    return [{
        "platform": cell["platform"],
        "tier": cell["tier"],
        "threads": cell["threads"],
        "service_time_ns": res.tier_counters[cell["tier"]].mean_service_time,
        "bandwidth_gbps": res.bandwidth(job.workloads[0].name),
    }]


# -- Fig. 10: MIKU vs DataRacing vs Opt ---------------------------------------


def _fig10_build(platform, cell) -> List[SimJob]:
    op, n = cell["op"], cell["n_threads"]
    period_ns, cycles = cell["period_ns"], cell["cycles"]
    sim_ns = 2 * cycles * period_ns
    alt = alternating_bw_pair(op, n, period_ns)
    return [
        _job(platform, [bw_test("ddr", op, n, name="a")], _BW_SIM_NS),
        _job(platform, [bw_test("cxl", op, n, name="a")], _BW_SIM_NS),
        _job(platform, alt, sim_ns, window_ns=5_000.0),
        _job(platform, alt, sim_ns, window_ns=5_000.0, miku=True),
        _job(platform, alt, sim_ns, window_ns=5_000.0, miku=True),
    ]


def _fig10_reduce(platform, cell, jobs, results) -> List[dict]:
    opt_a, opt_c, racing, miku, mba = results

    def tier_split(res):
        # Bandwidth by the tier actually served, from the per-tier counters.
        g = 4  # granularity
        ddr_bytes = res.tier_counters["ddr"].inserts * platform.ddr.access_bytes * g
        cxl_bytes = res.tier_counters["cxl"].inserts * platform.cxl.access_bytes * g
        return ddr_bytes / res.sim_ns, cxl_bytes / res.sim_ns

    racing_ddr, racing_cxl = tier_split(racing)
    miku_ddr, miku_cxl = tier_split(miku)
    mba_ddr, mba_cxl = tier_split(mba)
    return [{
        "platform": cell["platform"],
        "op": cell["op"].value,
        "opt_ddr": opt_a.bandwidth("a"),
        "opt_cxl": opt_c.bandwidth("a"),
        "racing_ddr": racing_ddr,
        "racing_cxl": racing_cxl,
        "miku_ddr": miku_ddr,
        "miku_cxl": miku_cxl,
        "miku_mba_ddr": mba_ddr,
        "miku_mba_cxl": mba_cxl,
    }]


# -- Fig. 11/12: co-located LLM serving (real decode steps) -------------------


def _fig11_run_cell(platform, cell, device) -> List[dict]:
    """An HBM-resident and a host-resident instance of the smoke config,
    each alone (opt), racing, and under MIKU.  The rows are the simulated
    queue clock's (the reference's tier constants), so they depend on byte
    counts, not on the tokens."""
    del platform
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.controller import MikuConfig, MikuController
    from repro_torch.core.littles_law import EstimatorConfig
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import (
        EngineConfig,
        Request,
        ServingEngine,
        TieredServingCluster,
    )

    n_fast, n_slow = cell["n_req_fast"], cell["n_req_slow"]
    new_tokens, chunks = cell["new_tokens"], cell["chunks"]

    cfg = get_arch(cell["arch"]).smoke
    params = TransformerLM(cfg).init(torch.Generator(device=device).manual_seed(0), device)

    def mk(name, placement, n_req):
        e = ServingEngine(
            EngineConfig(name=name, model=cfg, max_slots=4, max_len=96,
                         placement=placement, stream_chunks=chunks),
            params,
        )
        for i in range(n_req):
            e.submit(Request(rid=i, prompt=list(range(1, 9)), max_new_tokens=new_tokens))
        return e

    probe = mk("probe", "host", 0)
    chunk_service = probe.param_bytes / chunks / 16.0  # host link B/ns
    est = EstimatorConfig(
        t_fast=1.2e3,
        slow_read_threshold=8 * chunk_service,
        ewma=0.5,
        min_window_inserts=4,
        min_slow_inserts=1,
    )

    a = TieredServingCluster([mk("hbm", "device", n_fast)]).run(20000)
    b = TieredServingCluster([mk("host", "host", n_slow)]).run(20000)
    opt = (a["hbm"]["tokens_per_s"], b["host"]["tokens_per_s"])

    racing = TieredServingCluster(
        [mk("hbm", "device", n_fast), mk("host", "host", n_slow)]).run(40000)

    ctl = MikuController(MikuConfig(levels=(1, 2, 4, 8)), est)
    miku = TieredServingCluster(
        [mk("hbm", "device", n_fast), mk("host", "host", n_slow)],
        controller=ctl, window_ns=3e4,
    ).run(40000)
    restricted = sum(1 for d in ctl.decisions if d.restricted)

    def row(variant, fast_tps, slow_tps, **extra):
        return {
            "variant": variant,
            "hbm_tokens_per_s": fast_tps,
            "host_tokens_per_s": slow_tps,
            "hbm_pct_of_opt": 100.0 * fast_tps / max(opt[0], 1e-9),
            "host_pct_of_opt": 100.0 * slow_tps / max(opt[1], 1e-9),
            **extra,
        }

    return [
        row("opt", *opt),
        row("racing", racing["hbm"]["tokens_per_s"], racing["host"]["tokens_per_s"]),
        row("miku", miku["hbm"]["tokens_per_s"], miku["host"]["tokens_per_s"],
            restricted_windows=restricted, windows=len(ctl.decisions)),
    ]


# -- Fig. 13: big-data (Spark/TPC-H) analog -----------------------------------


def _spark_workload(name, tier, miku_managed=True):
    # 16 executor threads with deep prefetched scan/shuffle streams.
    return WorkloadSpec(name=name, op=OpClass.STORE, tier=tier, n_cores=16, mlp=160,
                        phases=[(60_000.0, tier)] * 1, miku_managed=miku_managed)


def _fig13_build(platform, cell) -> List[SimJob]:
    sim_ns = cell["sim_ns"]
    ddr = _spark_workload("ddr", "ddr", False)
    cxl = _spark_workload("cxl", "cxl")
    return [
        _job(platform, [ddr], sim_ns, window_ns=20_000.0),
        _job(platform, [cxl], sim_ns, window_ns=20_000.0),
        _job(platform, [ddr, cxl], sim_ns, window_ns=20_000.0),
        _job(platform, [ddr, cxl], sim_ns, window_ns=10_000.0, miku=True),
    ]


def _fig13_reduce(platform, cell, jobs, results) -> List[dict]:
    opt_a, opt_b, racing, miku = results
    opt = (opt_a.bandwidth("ddr"), opt_b.bandwidth("cxl"))

    def row(variant, res):
        return {
            "platform": cell["platform"],
            "variant": variant,
            "ddr_gbps": res.bandwidth("ddr"),
            "cxl_gbps": res.bandwidth("cxl"),
            "ddr_pct_of_opt": 100.0 * res.bandwidth("ddr") / max(opt[0], 1e-9),
            "cxl_pct_of_opt": 100.0 * res.bandwidth("cxl") / max(opt[1], 1e-9),
        }

    return [
        {"platform": cell["platform"], "variant": "opt",
         "ddr_gbps": opt[0], "cxl_gbps": opt[1],
         "ddr_pct_of_opt": 100.0, "cxl_pct_of_opt": 100.0},
        row("racing", racing),
        row("miku", miku),
    ]


# -- Fig. 14: concurrent-hashmap (YCSB) analog --------------------------------


def _kv_workloads(name, tier, ratio, managed) -> List[WorkloadSpec]:
    # ``ratio`` reads per write: 16 cores split between get (load) and
    # insert (store) streams; hash probing limits MLP.
    total = 16
    readers = round(total * ratio / (ratio + 1))
    wls = []
    if readers:
        wls.append(WorkloadSpec(name=f"{name}-get", op=OpClass.LOAD, tier=tier,
                                n_cores=readers, mlp=32, miku_managed=managed))
    if total - readers:
        wls.append(WorkloadSpec(name=f"{name}-ins", op=OpClass.STORE, tier=tier,
                                n_cores=total - readers, mlp=128, miku_managed=managed))
    return wls


def _fig14_build(platform, cell) -> List[SimJob]:
    sim_ns = cell["sim_ns"]
    wls = (_kv_workloads("ddr", "ddr", cell["ratio"], False)
           + _kv_workloads("cxl", "cxl", cell["ratio"], True))
    return [
        _job(platform, wls, sim_ns, window_ns=20_000.0),
        _job(platform, wls, sim_ns, window_ns=10_000.0, miku=True),
    ]


def _fig14_reduce(platform, cell, jobs, results) -> List[dict]:
    race, miku = results
    ddr = [w for w in jobs[0].workloads if w.name.startswith("ddr")]
    cxl = [w for w in jobs[0].workloads if w.name.startswith("cxl")]
    race_ddr = sum(race.bandwidth(w.name) for w in ddr)
    miku_ddr = sum(miku.bandwidth(w.name) for w in ddr)
    miku_cxl = sum(miku.bandwidth(w.name) for w in cxl)
    return [{
        "platform": cell["platform"],
        "ratio": cell["ratio"],
        "racing_ddr_gbps": race_ddr,
        "miku_ddr_gbps": miku_ddr,
        "miku_cxl_gbps": miku_cxl,
        "miku_gain": miku_ddr / max(race_ddr, 1e-9),
    }]


# -- Three-tier co-runs: DDR + local CXL + CXL behind a switch ---------------

_CORUN3_TIERS = ("ddr", "cxl", "cxl_sw")
_CORUN3P_SLOW = ("cxl", "cxl_sw")


def _corun3_jobs(platform, cell, **miku) -> List[SimJob]:
    """Each tier's bw-test alone, then the three co-running."""
    op, n = cell["op"], cell["n_threads"]
    wls = [bw_test(t, op, n, name=t, miku_managed=t != "ddr") for t in _CORUN3_TIERS]
    return ([_job(platform, [w], _BW_SIM_NS) for w in wls]
            + [_job(platform, wls, cell["sim_ns"], **miku)])


def _corun3_build(platform, cell) -> List[SimJob]:
    return _corun3_jobs(platform, cell, miku=cell["miku"])


def _corun3_reduce(platform, cell, jobs, results) -> List[dict]:
    *alone, corun = results
    row = {"platform": cell["platform"], "op": cell["op"].value, "miku": cell["miku"]}
    for tier, res in zip(_CORUN3_TIERS, alone):
        row[f"{tier}_alone_gbps"] = res.bandwidth(tier)
        row[f"{tier}_corun_gbps"] = corun.bandwidth(tier)
        row[f"t_{tier}_corun_ns"] = corun.tier_counters[tier].mean_service_time
    row["ddr_loss_pct"] = 100.0 * (1 - corun.bandwidth("ddr")
                                   / max(alone[0].bandwidth("ddr"), 1e-9))
    return [row]


def _corun3p_build(platform, cell) -> List[SimJob]:
    law = cell["law"]
    return _corun3_jobs(platform, cell, miku=law != "racing",
                        miku_law=law if law != "racing" else "pertier")


def _corun3p_reduce(platform, cell, jobs, results) -> List[dict]:
    *alone, corun = results
    row = {"platform": cell["platform"], "op": cell["op"].value, "law": cell["law"]}
    for tier, res in zip(_CORUN3_TIERS, alone):
        row[f"{tier}_alone_gbps"] = res.bandwidth(tier)
        row[f"{tier}_corun_gbps"] = corun.bandwidth(tier)
    row["ddr_pct_of_opt"] = 100.0 * corun.bandwidth("ddr") / max(
        alone[0].bandwidth("ddr"), 1e-9)
    # Per-slow-tier ladder telemetry: the merged law's broadcast makes the
    # two columns identical, the per-tier law's need not.
    top = 16.0  # the ladder's ceiling stands in for "unrestricted" in the mean
    for tier in _CORUN3P_SLOW:
        if cell["law"] == "racing":
            row[f"{tier}_restricted_windows"] = 0
            row[f"{tier}_mean_cap"] = top
            row[f"{tier}_mean_rate"] = 1.0
            continue
        ds = [d.for_tier(tier) for d in corun.decisions]
        caps = [float(d.max_concurrency) if d.max_concurrency is not None else top
                for d in ds]
        row[f"{tier}_restricted_windows"] = sum(1 for d in ds if d.restricted)
        row[f"{tier}_mean_cap"] = sum(caps) / max(len(caps), 1)
        row[f"{tier}_mean_rate"] = sum(d.rate_factor for d in ds) / max(len(ds), 1)
    return [row]


# -- Sweep-scale co-run grids (the batched lane at scale) ---------------------


def _corun_sweep_build(platform, cell) -> List[SimJob]:
    op, n = cell["op"], cell["threads"]
    wls = [
        bw_test("ddr", op, n, name="ddr", mlp=cell["mlp"], miku_managed=False),
        bw_test("cxl", op, n, name="cxl", mlp=cell["mlp"]),
    ]
    return [_job(platform, wls, cell["sim_ns"], miku=cell["miku"])]


def _corun_sweep_reduce(platform, cell, jobs, results) -> List[dict]:
    (res,) = results
    return [{
        "platform": cell["platform"],
        "op": cell["op"].value,
        "threads": cell["threads"],
        "mlp": cell["mlp"],
        "miku": cell["miku"],
        "ddr_gbps": res.bandwidth("ddr"),
        "cxl_gbps": res.bandwidth("cxl"),
        "restricted_windows": sum(1 for d in res.decisions if d.restricted),
    }]


# -- The tiering subsystem: migration as a request class, tiering policies ----


def _mig_spec(policy: str, managed: bool, drift: float, mig_cores: int,
              mig_mlp: int) -> TieringSpec:
    """TieringSpec for the migrate_interference co-run: the CXL demand
    workload's pages all start slow, with a drifting hot set that keeps the
    promotion/demotion engine busy for the whole run."""
    return TieringSpec(
        regions=(RegionSpec(
            workload="cxl",
            n_pages=2048,
            placement={"cxl": 1.0},
            pattern=HotSetPattern(hot_fraction=0.125, hot_weight=0.9,
                                  drift_pages=drift),
        ),),
        policy=policy,
        fast_capacity_pages=384,
        mig_cores=mig_cores,
        mig_mlp=mig_mlp,
        mig_miku_managed=managed,
    )


_MIGRATE_VARIANTS = ("demand_only", "naive", "miku")


def _migif_build(platform, cell) -> List[SimJob]:
    op, n, sim_ns = cell["op"], cell["n_threads"], cell["sim_ns"]
    drift = cell["drift_pages"]
    wls = [bw_test("ddr", op, n, name="ddr", miku_managed=False),
           bw_test("cxl", op, n, name="cxl")]
    # naive: the migration daemon races outside MIKU's reach (hotness_lru,
    # unmanaged); miku: the same candidates, but migration is a
    # MIKU-governed request class (managed workloads, coordinated deferral).
    naive = _mig_spec("hotness_lru", managed=False, drift=drift,
                      mig_cores=cell["mig_cores"], mig_mlp=cell["mig_mlp"])
    coord = _mig_spec("miku_coordinated", managed=True, drift=drift,
                      mig_cores=cell["mig_cores"], mig_mlp=cell["mig_mlp"])
    return [
        _job(platform, wls, sim_ns, miku=True),
        _job(platform, wls, sim_ns, miku=True, tiering=naive),
        _job(platform, wls, sim_ns, miku=True, tiering=coord),
    ]


def _migif_reduce(platform, cell, jobs, results) -> List[dict]:
    baseline = results[0].bandwidth("ddr")
    rows = []
    for variant, res in zip(_MIGRATE_VARIANTS, results):
        t = res.tiering
        rows.append({
            "platform": cell["platform"],
            "op": cell["op"].value,
            "variant": variant,
            "ddr_gbps": res.bandwidth("ddr"),
            "cxl_gbps": res.bandwidth("cxl"),
            "ddr_pct_of_demand_only": 100.0 * res.bandwidth("ddr") / max(baseline, 1e-9),
            "mig_gbps": res.bandwidth("mig-cxl") if t is not None else 0.0,
            "pages_promoted": t["pages_promoted"] if t else 0,
            "pages_demoted": t["pages_demoted"] if t else 0,
            "deferred_jobs": t["deferred_jobs"] if t else 0,
            "cxl_fast_fraction": t["fast_fraction"]["cxl"] if t else 0.0,
        })
    return rows


def _tierpol_build(platform, cell) -> List[SimJob]:
    op, n, sim_ns = cell["op"], cell["n_threads"], cell["sim_ns"]
    n_pages = 1024
    # A quarter of the region starts fast; the slow remainder is spread
    # evenly over the platform's slow tiers (the three-tier A-switch cell
    # promotes from two slow devices).
    slow = platform.tier_names[1:]
    placement = {"ddr": 0.25}
    for t in slow:
        placement[t] = 0.75 / len(slow)
    # The hot set starts at page n/4, the first slow page of the contiguous
    # initial placement: a static placement serves it from the slow tiers
    # forever, a hotness policy promotes it and then chases its drift.
    spec = TieringSpec(
        regions=(RegionSpec(
            workload="app",
            n_pages=n_pages,
            placement=placement,
            pattern=HotSetPattern(hot_fraction=0.125, hot_weight=0.9,
                                  drift_pages=cell["drift_pages"],
                                  hot_start=n_pages // 4),
        ),),
        policy=cell["policy"],
        fast_capacity_pages=320,
        mig_cores=8,
    )
    app = bw_test("ddr", op, n, name="app", miku_managed=False)
    return [_job(platform, [app], sim_ns, tiering=spec)]


def _tierpol_reduce(platform, cell, jobs, results) -> List[dict]:
    (res,) = results
    t = res.tiering
    return [{
        "platform": cell["platform"],
        "policy": cell["policy"],
        "drift_pages": cell["drift_pages"],
        "app_gbps": res.bandwidth("app"),
        "app_fast_fraction": t["fast_fraction"]["app"],
        "pages_promoted": t["pages_promoted"],
        "pages_demoted": t["pages_demoted"],
        "migrated_gb": t["migrated_bytes"] / 1e9,
    }]


# -- NUMA-remote DDR striping under a CXL co-run ------------------------------


def _numa_build(platform, cell) -> List[SimJob]:
    op, n, f = cell["op"], cell["n_threads"], cell["remote_fraction"]
    striped = WorkloadSpec(name="striped", op=op, tier="ddr", n_cores=n, mlp=160,
                           miku_managed=False, placement={"ddr": 1.0 - f, "ddr_remote": f})
    cxl_bg = bw_test("cxl", op, n, name="cxl")
    return [
        _job(platform, [striped], cell["sim_ns"]),
        _job(platform, [striped, cxl_bg], cell["sim_ns"]),
    ]


def _numa_reduce(platform, cell, jobs, results) -> List[dict]:
    alone, corun = results
    return [{
        "platform": cell["platform"],
        "op": cell["op"].value,
        "remote_fraction": cell["remote_fraction"],
        "striped_alone_gbps": alone.bandwidth("striped"),
        "striped_corun_gbps": corun.bandwidth("striped"),
        "cxl_corun_gbps": corun.bandwidth("cxl"),
        "striped_avg_lat_ns": alone.stats["striped"].mean_latency_ns(),
        "local_inserts": alone.tier_counters["ddr"].inserts,
        "remote_inserts": alone.tier_counters["ddr_remote"].inserts,
    }]


# -- Fabric scenarios: routed switch topologies --------------------------------
# No platform axis: each cell builds its platform from its topology axes (the
# fabric's import above registers "A-direct" and "A-spine" for the CLI).  The
# batched lane sends every fabric job to the scalar DES by name
# ("fabric_topology").

_FABRIC_SIM_NS = 300_000.0


def _fabric_spine_build(platform, cell) -> List[SimJob]:
    del platform  # built from the topology axes
    op, n, law = cell["op"], cell["n_threads"], cell["law"]
    pm = spine_leaf_platform(spine_slots=cell["spine_slots"],
                             spine_service_ns=cell["spine_service_ns"])
    ddr = bw_test("ddr", op, n, name="ddr", miku_managed=False, host="host0")
    cxl0 = bw_test("cxl", op, n, name="cxl0", host="host0")
    cxl1 = bw_test("cxl", op, n, name="cxl1", host="host1")
    return [
        _job(pm, [ddr], _BW_SIM_NS),
        _job(pm, [cxl0], _BW_SIM_NS),
        _job(pm, [ddr, cxl0, cxl1], cell["sim_ns"], miku=law != "racing",
             miku_law="peredge" if law != "racing" else "pertier"),
    ]


def _fabric_spine_reduce(platform, cell, jobs, results) -> List[dict]:
    del platform, jobs
    ddr_alone, cxl_alone, corun = results
    spine = (corun.fabric or {}).get("spine-cxl", {})
    row = {
        "law": cell["law"],
        "op": cell["op"].value,
        "ddr_alone_gbps": ddr_alone.bandwidth("ddr"),
        "cxl_alone_gbps": cxl_alone.bandwidth("cxl0"),
        "ddr_corun_gbps": corun.bandwidth("ddr"),
        "cxl0_corun_gbps": corun.bandwidth("cxl0"),
        "cxl1_corun_gbps": corun.bandwidth("cxl1"),
        "ddr_pct_of_alone": 100.0 * corun.bandwidth("ddr")
        / max(ddr_alone.bandwidth("ddr"), 1e-9),
        "tor_peak": corun.tor_peak,
        "spine_stall_events": spine.get("stall_events", 0),
        "spine_peak_occupancy": spine.get("peak_occupancy", 0),
    }
    row["spine_restricted_windows"] = (
        sum(1 for d in corun.decisions if d.for_tier("spine-cxl").restricted)
        if cell["law"] == "peredge" and corun.decisions else 0
    )
    return [row]


def _fabric_port_build(platform, cell) -> List[SimJob]:
    del platform
    pm = single_switch_platform(port_slots=cell["port_slots"],
                                port_service_ns=cell["port_service_ns"],
                                port_queue=cell["port_queue"])
    wl = bw_test("cxl", cell["op"], cell["n_threads"], name="cxl", host="host0")
    return [_job(pm, [wl], cell["sim_ns"])]


def _fabric_port_reduce(platform, cell, jobs, results) -> List[dict]:
    del platform, jobs
    (res,) = results
    port = (res.fabric or {}).get("sw0-cxl", {})
    return [{
        "op": cell["op"].value,
        "port_queue": cell["port_queue"],
        "cxl_gbps": res.bandwidth("cxl"),
        "tor_peak": res.tor_peak,
        "port_peak_occupancy": port.get("peak_occupancy", 0),
        "port_entry_limit": port.get("entry_limit", 0),
        "port_stall_events": port.get("stall_events", 0),
        "port_limited": int(port.get("peak_occupancy", 0) >= port.get("entry_limit", 0)),
    }]


def _fabric_miku_build(platform, cell) -> List[SimJob]:
    del platform
    op, n, law = cell["op"], cell["n_threads"], cell["law"]
    # A narrow uplink1 (host1) behind a wide spine: host1's CXL stream is
    # the congestion source, host0's the innocent one.
    pm = spine_leaf_platform(uplink_slots=(16, cell["narrow_slots"]),
                             uplink_service_ns=(18.0, cell["narrow_service_ns"]),
                             spine_slots=14, spine_service_ns=18.0)
    ddr = bw_test("ddr", op, n, name="ddr", miku_managed=False, host="host0")
    cxl0 = bw_test("cxl", op, n, name="cxl0", host="host0")
    cxl1 = bw_test("cxl", op, n, name="cxl1", host="host1")
    return [
        _job(pm, [cxl0], _BW_SIM_NS),
        _job(pm, [ddr, cxl0, cxl1], cell["sim_ns"], miku=law != "racing",
             miku_law=law if law != "racing" else "pertier"),
    ]


def _fabric_miku_reduce(platform, cell, jobs, results) -> List[dict]:
    del platform, jobs
    cxl0_alone, corun = results
    row = {
        "law": cell["law"],
        "op": cell["op"].value,
        "ddr_corun_gbps": corun.bandwidth("ddr"),
        "cxl0_corun_gbps": corun.bandwidth("cxl0"),
        "cxl1_corun_gbps": corun.bandwidth("cxl1"),
        "cxl0_alone_gbps": cxl0_alone.bandwidth("cxl0"),
        "cxl0_pct_of_alone": 100.0 * corun.bandwidth("cxl0")
        / max(cxl0_alone.bandwidth("cxl0"), 1e-9),
        "tor_peak": corun.tor_peak,
    }
    # Where the restriction landed: the whole cxl tier (pertier punishes
    # the innocent host too) or only the congested uplink edge (peredge).
    row["cxl_restricted_windows"] = sum(
        1 for d in corun.decisions if "cxl" in d.tiers and d.for_tier("cxl").restricted)
    row["uplink1_restricted_windows"] = sum(
        1 for d in corun.decisions
        if "uplink1" in d.tiers and d.for_tier("uplink1").restricted)
    return [row]


# -- SLO scenarios: open-loop offered load -------------------------------------

_SLO_SIM_NS = 300_000.0
#: The serving tenant's p99 budget; a NaN p99 (a window with no completion)
#: never satisfies ``p99 <= budget``, so it counts as blown.
_SLO_BUDGET_NS = 10_000.0
#: Placement axis: the serving tenant's DDR interleave fraction.
_SLO_PLACEMENTS = {"ddr": 1.0, "split": 0.5, "cxl_heavy": 0.25}


def _slo_workloads(cell, arrival) -> List[WorkloadSpec]:
    """An open-loop latency-critical serving tenant (never MIKU-managed)
    beside a closed-loop CXL bandwidth hog (MIKU's throttling candidate)."""
    serve = serve_test(4, arrival=arrival, ddr_fraction=_SLO_PLACEMENTS[cell["placement"]])
    return [serve, bw_test("cxl", cell["op"], 16, name="hog")]


def _slo_knee_build(platform, cell) -> List[SimJob]:
    arr = ArrivalSpec("poisson", rate=cell["rate"], seed=7)
    return [_job(platform, _slo_workloads(cell, arr), cell["sim_ns"],
                 miku=cell["policy"] == "miku", latency_hist=True)]


def _slo_knee_reduce(platform, cell, jobs, results) -> List[dict]:
    del platform, jobs
    (res,) = results
    st = res.stats["serve"]
    a = res.arrival["serve"]
    hist = st.latency_hist
    p99 = st.percentile_ns(0.99)
    budget = cell["budget_ns"]
    return [{
        "placement": cell["placement"],
        "policy": cell["policy"],
        "rate_rpns": cell["rate"],
        "p50_ns": st.percentile_ns(0.50),
        "p95_ns": hist.percentile(0.95) if hist is not None else float("nan"),
        "p99_ns": p99,
        "budget_ns": budget,
        "budget_blown": int(not (p99 <= budget)),  # a NaN p99 is blown
        "generated": a["generated"],
        "issued": a["issued"],
        "shed": a["shed"],
        "backlog": a["backlog"],
    }]


def _flash_crowd_build(platform, cell) -> List[SimJob]:
    arr = ArrivalSpec("flash_crowd", rate=cell["rate"], seed=7,
                      t_step_ns=cell["t_step_ns"], surge=cell["surge"],
                      surge_ns=cell["surge_ns"])
    return [_job(platform, _slo_workloads(cell, arr), cell["sim_ns"],
                 miku=cell["policy"] == "miku", latency_hist=True, record_windows=True)]


def _flash_crowd_reduce(platform, cell, jobs, results) -> List[dict]:
    del platform
    (job,), (res,) = jobs, results
    st = res.stats["serve"]
    a = res.arrival["serve"]
    t0 = cell["t_step_ns"]
    t1 = t0 + cell["surge_ns"]
    peak_q = 0
    surge_hist = LatencyHistogram()
    recovery_windows = 0
    for rec in res.window_records or ():
        arr_blk = rec.get("arrival", {}).get("serve")
        if arr_blk is None:
            continue
        peak_q = max(peak_q, arr_blk["queue_depth"])
        w_end = rec["t_ns"]
        w_start = w_end - job.window_ns
        if w_start < t1 and w_end > t0:  # the window overlaps the surge
            blob = rec.get("latency_hist", {}).get("serve")
            if blob:
                surge_hist = surge_hist.merge(LatencyHistogram.from_jsonable(blob))
        elif w_start >= t1 and arr_blk["queue_depth"] > 0:
            recovery_windows += 1
    return [{
        "placement": cell["placement"],
        "policy": cell["policy"],
        "peak_queue_depth": peak_q,
        "surge_p99_ns": surge_hist.percentile(0.99),
        "recovery_windows": recovery_windows,
        "p99_ns": st.percentile_ns(0.99),
        "shed": a["shed"],
        "backlog": a["backlog"],
    }]


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    Scenario(
        name="fig2_tiering",
        title="Aggregated bandwidth of tiered-memory management schemes",
        axes=(_platform_axis(), _op_axis()),
        figure="Fig. 2",
        metrics=(
            Metric("upper_ddr_only", "GB/s", "one copy, WSS fully in DDR"),
            Metric("lower_cxl_only", "GB/s", "one copy, WSS fully in CXL"),
            Metric("native", "GB/s", "application-directed placement"),
            Metric("interleave", "GB/s", "page-interleaved at the bw ratio"),
            Metric("os_managed", "GB/s", "interleaved + page-migration tax"),
            Metric("ideal_combined", "GB/s", "upper + lower"),
        ),
        run_cell=_fig2_run_cell,
    ),
    Scenario(
        name="fig3_bandwidth",
        title="DDR vs CXL single/multi-thread bandwidth",
        axes=(
            _platform_axis(("A", "A-1to1", "B", "B-1to1")),
            _op_axis(),
            Axis("threads", (1, 16), "bw-test thread count"),
            Axis("tier", _TWO_TIERS, "tier under test"),
        ),
        figure="Fig. 3",
        metrics=(
            Metric("bandwidth_gbps", "GB/s", "delivered bandwidth"),
            Metric("peak_model_gbps", "GB/s", "device-model peak"),
        ),
        build=_fig3_build,
        reduce=_fig3_reduce,
    ),
    Scenario(
        name="fig4_latency",
        title="Average and tail (p99) loaded latency per tier",
        axes=(
            _platform_axis(),
            Axis("tier", _TWO_TIERS, "tier under test"),
            Axis("threads", (1, 2, 4, 8, 16), "lat-test thread count"),
        ),
        figure="Fig. 4",
        metrics=(
            Metric("avg_ns", "ns"),
            Metric("p50_ns", "ns"),
            Metric("p95_ns", "ns", "from the mergeable latency histogram"),
            Metric("p99_ns", "ns"),
        ),
        build=_fig4_build,
        reduce=_fig4_reduce,
    ),
    Scenario(
        name="loaded_latency",
        title="Latency-under-load curve: probe latency vs bandwidth load",
        axes=(
            _platform_axis(),
            Axis("tier", _TWO_TIERS, "tier under test"),
            Axis("load_threads", (0, 2, 4, 8, 16),
                 "bw-test threads loading the same tier (0 = unloaded)"),
            _op_axis(OpClass.LOAD),
        ),
        figure="Fig. 4",
        metrics=(
            Metric("load_gbps", "GB/s", "bandwidth the load workload delivers"),
            Metric("avg_ns", "ns", "probe mean latency"),
            Metric("p50_ns", "ns"),
            Metric("p95_ns", "ns", "from the mergeable latency histogram"),
            Metric("p99_ns", "ns"),
        ),
        build=_loaded_lat_build,
        reduce=_loaded_lat_reduce,
    ),
    Scenario(
        name="fig5_corun",
        title="Co-run bandwidth collapse and ToR accounting",
        axes=(
            _platform_axis(("A", "B")),
            _op_axis(),
            Axis("n_threads", 16, "threads per co-running group"),
        ),
        figure="Fig. 5-6",
        metrics=(
            Metric("ddr_loss_pct", "%", "fast-tier loss under co-run"),
            Metric("t_cxl_corun_ns", "ns", "loaded slow-tier ToR residency"),
        ),
        build=_fig5_build,
        reduce=_fig5_reduce,
    ),
    Scenario(
        name="fig6_tor_correlation",
        title="ToR insertion rate vs delivered bandwidth (Pearson r)",
        axes=(_platform_axis(),),
        figure="Fig. 6",
        metrics=(
            Metric("pearson_r", "", "paper reports r = 0.998"),
        ),
        build=_fig6_build,
        reduce=_fig6_reduce,
    ),
    Scenario(
        name="fig7_llc",
        title="LLC partition (CAT) sweep under tiered co-run",
        axes=(
            _platform_axis(),
            Axis("wss_mb", (60.0, 120.0), "per-workload working-set size"),
            Axis("ddr_share", (0.95, 0.75, 0.5, 0.25, 0.05),
                 "DDR workload's LLC allocation fraction"),
        ),
        figure="Fig. 7",
        metrics=(
            Metric("ddr_gbps", "GB/s"),
            Metric("cxl_gbps", "GB/s"),
            Metric("total_gbps", "GB/s"),
        ),
        build=_fig7_build,
        reduce=_fig7_reduce,
    ),
    Scenario(
        name="fig8_sync",
        title="Cross-core CAS latency under tier background traffic",
        axes=(
            _platform_axis(),
            Axis("bg_tier", _TWO_TIERS, "background bw-test tier"),
            Axis("bg_threads", (0, 4, 8, 16), "background thread count"),
        ),
        figure="Fig. 8",
        metrics=(
            Metric("cas_latency_ns", "ns"),
        ),
        build=_fig8_build,
        reduce=_fig8_reduce,
    ),
    Scenario(
        name="fig9_service",
        title="Memory service time vs thread count (MIKU's signal)",
        axes=(
            _platform_axis(),
            _op_axis(OpClass.LOAD),
            Axis("tier", _TWO_TIERS, "tier under test"),
            Axis("threads", (1, 2, 4, 8, 16, 32), "bw-test thread count"),
        ),
        figure="Fig. 9",
        metrics=(
            Metric("service_time_ns", "ns", "ToR-derived mean service time"),
            Metric("bandwidth_gbps", "GB/s"),
        ),
        build=_fig9_build,
        reduce=_fig9_reduce,
    ),
    Scenario(
        name="fig10_miku",
        title="MIKU vs DataRacing vs Opt on alternating micro-benchmarks",
        axes=(
            _platform_axis(),
            _op_axis(),
            Axis("n_threads", 16, "threads per alternating group"),
            Axis("period_ns", 100_000.0, "tier-alternation period"),
            Axis("cycles", 3, "alternation cycles simulated"),
        ),
        figure="Fig. 10",
        metrics=(
            Metric("racing_ddr", "GB/s"),
            Metric("miku_ddr", "GB/s"),
            Metric("miku_cxl", "GB/s"),
            Metric("opt_ddr", "GB/s"),
        ),
        build=_fig10_build,
        reduce=_fig10_reduce,
    ),
    Scenario(
        name="fig11_llm",
        title="Co-located LLM serving: HBM vs host tier, racing vs MIKU",
        axes=(
            Axis("arch", "llama31-8b", "model architecture (smoke config)"),
            Axis("n_req_fast", 48), Axis("n_req_slow", 16),
            Axis("new_tokens", 24), Axis("chunks", 64),
        ),
        figure="Fig. 11-12",
        metrics=(
            Metric("hbm_tokens_per_s", "tok/s"),
            Metric("host_tokens_per_s", "tok/s"),
            Metric("hbm_pct_of_opt", "%"),
        ),
        run_cell=_fig11_run_cell,
        slow=True,
    ),
    Scenario(
        name="fig13_spark",
        title="Shuffle-heavy big-data phases co-running, racing vs MIKU",
        axes=(
            _platform_axis(),
            Axis("sim_ns", 400_000.0, "simulated horizon"),
        ),
        figure="Fig. 13",
        metrics=(
            Metric("ddr_pct_of_opt", "%", "paper: MIKU >= 81%"),
            Metric("cxl_pct_of_opt", "%"),
        ),
        build=_fig13_build,
        reduce=_fig13_reduce,
    ),
    Scenario(
        name="fig14_kv",
        title="Concurrent hashmap (YCSB) read:write sweep, racing vs MIKU",
        axes=(
            _platform_axis(),
            Axis("ratio", (0, 1, 4), "reads per write"),
            Axis("sim_ns", 300_000.0, "simulated horizon"),
        ),
        figure="Fig. 14",
        metrics=(
            Metric("racing_ddr_gbps", "GB/s"),
            Metric("miku_ddr_gbps", "GB/s"),
            Metric("miku_gain", "x", "MIKU / racing fast-tier bandwidth"),
        ),
        build=_fig14_build,
        reduce=_fig14_reduce,
    ),
    Scenario(
        name="corun3_switch",
        title="Three-tier co-run: DDR + local CXL + CXL-over-switch",
        axes=(
            _platform_axis("A-switch"),
            _op_axis(),
            Axis("n_threads", 16, "threads per co-running group"),
            Axis("miku", (False, True), "enable the MIKU controller"),
            Axis("sim_ns", 300_000.0, "co-run simulated horizon"),
        ),
        metrics=(
            Metric("ddr_loss_pct", "%", "fast-tier loss under 3-tier co-run"),
            Metric("cxl_sw_corun_gbps", "GB/s", "switched-CXL bandwidth"),
            Metric("t_cxl_sw_corun_ns", "ns", "switched-CXL ToR residency"),
        ),
        build=_corun3_build,
        reduce=_corun3_reduce,
    ),
    Scenario(
        name="corun3_pertier",
        title="Per-tier vs merged MIKU ladders on the three-tier co-run",
        axes=(
            _platform_axis("A-switch"),
            _op_axis(OpClass.STORE),
            Axis("law", ("racing", "merged", "pertier"),
                 "control law for the co-run (racing = no controller, merged = "
                 "MergedSlowPolicy broadcast, pertier = per-slow-tier ensemble)"),
            Axis("n_threads", 16, "threads per co-running group"),
            Axis("sim_ns", 300_000.0, "co-run simulated horizon"),
        ),
        metrics=(
            Metric("ddr_pct_of_opt", "%", "fast-tier recovery vs running alone"),
            Metric("cxl_mean_cap", "cores", "mean local-CXL core cap over the run"),
            Metric("cxl_sw_mean_cap", "cores",
                   "mean switched-CXL core cap (per-tier law: < cxl_mean_cap)"),
            Metric("cxl_sw_restricted_windows", "",
                   "windows the switch tier spent restricted"),
        ),
        build=_corun3p_build,
        reduce=_corun3p_reduce,
    ),
    Scenario(
        name="corun_sweep",
        title="Sweep-scale co-run grid (96 cells): threads x op x MIKU x platform",
        axes=(
            _platform_axis(("A", "B")),
            _op_axis(),
            Axis("threads", (2, 4, 8, 16), "threads per co-running group"),
            Axis("miku", (False, True), "enable the MIKU controller"),
            Axis("mlp", (96, 160), "outstanding cachelines per core"),
            Axis("sim_ns", 300_000.0, "co-run simulated horizon"),
        ),
        metrics=(
            Metric("ddr_gbps", "GB/s", "fast-tier co-run bandwidth"),
            Metric("cxl_gbps", "GB/s", "slow-tier co-run bandwidth"),
            Metric("restricted_windows", "", "windows MIKU spent restricting"),
        ),
        build=_corun_sweep_build,
        reduce=_corun_sweep_reduce,
        slow=True,
    ),
    Scenario(
        name="corun_sweep_1k",
        title="Kilo-cell co-run grid (1024 cells): the batched lane at scale",
        axes=(
            _platform_axis(("A", "B")),
            _op_axis((OpClass.LOAD, OpClass.STORE)),
            Axis("threads", (1, 2, 3, 4, 6, 8, 12, 16), "threads per co-running group"),
            Axis("miku", (False, True), "enable the MIKU controller"),
            Axis("mlp", (32, 40, 48, 56, 64, 80, 96, 112,
                         128, 144, 160, 176, 192, 208, 224, 256),
                 "outstanding cachelines per core"),
            Axis("sim_ns", 100_000.0, "co-run simulated horizon"),
        ),
        metrics=(
            Metric("ddr_gbps", "GB/s", "fast-tier co-run bandwidth"),
            Metric("cxl_gbps", "GB/s", "slow-tier co-run bandwidth"),
            Metric("restricted_windows", "", "windows MIKU spent restricting"),
        ),
        build=_corun_sweep_build,
        reduce=_corun_sweep_reduce,
        slow=True,
    ),
    Scenario(
        name="migrate_interference",
        title="Migration traffic as a request class: naive vs MIKU-coordinated",
        axes=(
            _platform_axis(),
            _op_axis(OpClass.LOAD),
            Axis("n_threads", 16, "threads per demand group"),
            Axis("drift_pages", 64.0, "hot-set drift per window (churn)"),
            Axis("mig_cores", 8, "migration-daemon cores per slow tier"),
            Axis("mig_mlp", 160, "migration-daemon MLP per core"),
            Axis("sim_ns", 300_000.0, "co-run simulated horizon"),
        ),
        metrics=(
            Metric("ddr_pct_of_demand_only", "%",
                   "DDR demand bandwidth vs the no-migration co-run"),
            Metric("mig_gbps", "GB/s", "migration-engine copy bandwidth"),
            Metric("pages_promoted", "pages"),
            Metric("deferred_jobs", "",
                   "migrations MIKU coordination pushed past throttled windows"),
        ),
        build=_migif_build,
        reduce=_migif_reduce,
    ),
    Scenario(
        name="tiering_policies",
        title="Hot-set drift vs tiering policy on 2- and 3-tier platforms",
        axes=(
            _platform_axis(("A", "A-switch")),
            Axis("policy", ("static", "hotness_lru"),
                 "tiering policy (repro_torch.tiering.policies registry)"),
            _op_axis(OpClass.LOAD),
            Axis("n_threads", 16, "app thread count"),
            Axis("drift_pages", 4.0,
                 "hot-set drift per window (fast drift outruns migration "
                 "bandwidth and the copy tax wins — try 16)"),
            Axis("sim_ns", 300_000.0, "simulated horizon"),
        ),
        metrics=(
            Metric("app_gbps", "GB/s", "delivered app bandwidth"),
            Metric("app_fast_fraction", "",
                   "access-weighted share served by the fast tier at the end"),
            Metric("pages_promoted", "pages"),
            Metric("migrated_gb", "GB", "total migration copy traffic"),
        ),
        build=_tierpol_build,
        reduce=_tierpol_reduce,
    ),
    Scenario(
        name="numa_remote",
        title="NUMA-remote DDR striping (placement vector) under CXL co-run",
        axes=(
            _platform_axis("A-numa"),
            _op_axis(OpClass.LOAD),
            Axis("remote_fraction", (0.0, 0.25, 0.5),
                 "request fraction striped to the remote socket's DDR"),
            Axis("n_threads", 16, "striped-workload thread count"),
            Axis("sim_ns", 200_000.0, "simulated horizon"),
        ),
        metrics=(
            Metric("striped_alone_gbps", "GB/s", "NUMA striping adds DIMM parallelism"),
            Metric("striped_avg_lat_ns", "ns"),
            Metric("remote_inserts", "", "requests served by the remote pool"),
        ),
        build=_numa_build,
        reduce=_numa_reduce,
    ),
    Scenario(
        name="fabric_spine_congestion",
        title="Two hosts share a spine downlink: congestion collapse vs "
              "per-edge MIKU recovery",
        axes=(
            _op_axis(OpClass.LOAD),
            Axis("law", ("racing", "peredge"),
                 "control law: racing (no controller) or the per-edge ladder ensemble"),
            Axis("n_threads", 16, "threads per workload"),
            Axis("spine_slots", 8, "shared spine downlink port servers"),
            Axis("spine_service_ns", 36.0, "spine per-cacheline service time"),
            Axis("sim_ns", _FABRIC_SIM_NS, "simulated horizon"),
        ),
        metrics=(
            Metric("ddr_corun_gbps", "GB/s",
                   "DDR under spine-stalled CXL ToR monopolization"),
            Metric("ddr_pct_of_alone", "%",
                   "racing collapses DDR; per-edge MIKU recovers it"),
            Metric("spine_stall_events", "",
                   "backpressure stalls at the shared spine port"),
            Metric("spine_restricted_windows", "",
                   "windows the spine edge ladder spent restricted"),
        ),
        build=_fabric_spine_build,
        reduce=_fabric_spine_reduce,
    ),
    Scenario(
        name="fabric_port_overflow",
        title="Port-queue limit vs ToR limit crossover behind one switch port",
        axes=(
            _op_axis(OpClass.LOAD),
            Axis("port_queue", (64, 256, 1024, 2048),
                 "switch port entry limit (cachelines; ToR is 2048)"),
            Axis("port_slots", 8, "switch port servers"),
            Axis("port_service_ns", 36.0, "port per-cacheline service time"),
            Axis("n_threads", 8, "CXL workload thread count"),
            Axis("sim_ns", _BW_SIM_NS, "simulated horizon"),
        ),
        metrics=(
            Metric("cxl_gbps", "GB/s", "port-service-bound throughput"),
            Metric("port_peak_occupancy", "",
                   "== entry limit while the port binds; < once the ToR does"),
            Metric("port_stall_events", "",
                   "admission backpressure events (0 once the ToR binds)"),
            Metric("port_limited", "",
                   "1 while the port queue is the binding limit, 0 past the "
                   "crossover"),
        ),
        build=_fabric_port_build,
        reduce=_fabric_port_reduce,
    ),
    Scenario(
        name="fabric_miku",
        title="Asymmetric uplinks: per-edge ladders throttle only the congested route",
        axes=(
            _op_axis(OpClass.LOAD),
            Axis("law", ("racing", "pertier", "peredge"),
                 "control law under asymmetric uplink congestion"),
            Axis("n_threads", 16, "threads per workload"),
            Axis("narrow_slots", 4, "host1 uplink port servers"),
            Axis("narrow_service_ns", 36.0, "host1 uplink per-cacheline service time"),
            Axis("sim_ns", _FABRIC_SIM_NS, "simulated horizon"),
        ),
        metrics=(
            Metric("ddr_corun_gbps", "GB/s", "fast tier held near solo"),
            Metric("cxl0_pct_of_alone", "%",
                   "the innocent host's CXL bandwidth — pertier punishes it, "
                   "peredge spares it"),
            Metric("cxl_restricted_windows", "",
                   "windows the whole cxl tier spent restricted"),
            Metric("uplink1_restricted_windows", "",
                   "windows only the congested uplink spent restricted"),
        ),
        build=_fabric_miku_build,
        reduce=_fabric_miku_reduce,
    ),
    Scenario(
        name="slo_knee",
        title="Offered-load sweep: where each placement/policy blows the "
              "p99 latency budget",
        axes=(
            _platform_axis(),
            _op_axis(OpClass.LOAD),
            Axis("placement", ("ddr", "cxl_heavy"),
                 "serving tenant's tier placement "
                 "(DDR interleave fraction: ddr=1.0, cxl_heavy=0.25)"),
            Axis("policy", ("racing", "miku"),
                 "control policy over the co-running CXL hog"),
            Axis("rate", (0.002, 0.005, 0.010, 0.020, 0.032),
                 "offered arrival rate (requests/ns), Poisson", parse=float),
            Axis("budget_ns", _SLO_BUDGET_NS, "p99 latency budget defining the knee",
                 parse=float),
            Axis("sim_ns", _SLO_SIM_NS, "simulated horizon"),
        ),
        metrics=(
            Metric("p50_ns", "ns",
                   "serving tenant median latency (arrival to retire, backlog "
                   "wait included)"),
            Metric("p95_ns", "ns", "from the mergeable latency histogram"),
            Metric("p99_ns", "ns", "the SLO-governing tail"),
            Metric("budget_blown", "",
                   "1 when p99 exceeds budget_ns — the knee is the lowest blown "
                   "rate; CXL-heavy placement knees before DDR, MIKU moves the "
                   "knee above racing"),
            Metric("generated", "", "open-loop arrivals generated"),
            Metric("issued", "", "arrivals issued into the pipeline"),
            Metric("shed", "", "arrivals shed at the queue limit"),
            Metric("backlog", "",
                   "arrival-queue depth at horizon end — nonzero means the "
                   "offered rate exceeds capacity"),
        ),
        build=_slo_knee_build,
        reduce=_slo_knee_reduce,
    ),
    Scenario(
        name="flash_crowd",
        title="Flash crowd: control-plane transient response to an offered-load step",
        axes=(
            _platform_axis(),
            _op_axis(OpClass.LOAD),
            Axis("placement", "split", "serving tenant's tier placement (see slo_knee)"),
            Axis("policy", ("racing", "miku"),
                 "control policy over the co-running CXL hog"),
            Axis("rate", 0.004, "base offered rate (requests/ns)", parse=float),
            Axis("surge", 6.0, "rate multiplier during the crowd", parse=float),
            Axis("t_step_ns", 100_000.0, "crowd onset", parse=float),
            Axis("surge_ns", 60_000.0, "crowd duration", parse=float),
            Axis("sim_ns", _SLO_SIM_NS, "simulated horizon"),
        ),
        metrics=(
            Metric("peak_queue_depth", "",
                   "worst arrival-backlog depth — racing lets the queue run "
                   "away, MIKU caps it"),
            Metric("surge_p99_ns", "ns", "p99 over windows overlapping the surge"),
            Metric("recovery_windows", "",
                   "post-surge windows with a nonzero backlog (drain time)"),
            Metric("p99_ns", "ns", "whole-run serving p99"),
            Metric("shed", "", "arrivals shed at the queue limit"),
            Metric("backlog", "",
                   "arrival-queue depth at horizon end — nonzero means the crowd"
                   " never drained"),
        ),
        build=_flash_crowd_build,
        reduce=_flash_crowd_reduce,
    ),
)}

#: The reference's scenarios the port does not run yet: none, all 25 are
#: registered above.
UNPORTED: Dict[str, str] = {}
