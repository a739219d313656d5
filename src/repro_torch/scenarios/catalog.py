"""The generated scenario catalog (a port of ``repro.scenarios.catalog``):
the source of ``docs/torch_scenarios.md``.

``python -m repro_torch.launch.sweep --list --format md`` prints
:func:`catalog_md`, and a test holds the committed file to it, so the
registry and its documentation cannot drift.  Everything here is a pure,
deterministic function of the registry.  Each section is the reference's;
the port has no figure modules, so no section names one.
"""

from __future__ import annotations

from typing import List

from repro_torch.scenarios.registry import all_scenarios
from repro_torch.scenarios.spec import Scenario, format_default

_HEADER = """\
# Scenario catalog of the PyTorch port

<!-- GENERATED FILE — do not edit by hand.
     Regenerate with:
         PYTHONPATH=src python -m repro_torch.launch.sweep --list --format md > docs/torch_scenarios.md
     tests/test_torch_catalog.py fails if this file is stale. -->

Every experiment of the port is a registered, declarative
[`Scenario`](../src/repro_torch/scenarios/spec.py): parameter axes (grid
axes expand into cells), result metrics, and the `build` function that
turns one cell into [`SimJob`](../src/repro_torch/memsim/sweep.py)s.  Run
any of them with:

```bash
PYTHONPATH=src python -m repro_torch.launch.sweep NAME \\
    [--set axis=value ...] [--format csv|json] [--trace PATH] \\
    [--lane batched|scalar] [--processes N] [--device cpu]
```

Grid axes are marked `*`: comma lists in `--set` sweep them
(`--set threads=1,16`).  The default `--lane batched` runs the whole grid
through the batched sweep lane (`repro_torch.memsim.batched`, its
per-window solve on the card); `--trace PATH` records per-window
control-plane telemetry.
"""


def _scenario_md(sc: Scenario) -> List[str]:
    lines = [f"## `{sc.name}`", ""]
    bits = [sc.title]
    if sc.figure:
        bits.append(f"reproduces **{sc.figure}**")
    lines.append(".  ".join(bits) + ".")
    lines.append("")
    facts = ["multi-stage (`run_cell`)" if sc.run_cell is not None
             else "grid (`build` + `reduce`)"]
    if sc.slow:
        facts.append("slow — CI runs it in the non-gating lane")
    lines.append(f"*Form:* {'; '.join(facts)}.")
    lines.append("")
    if sc.axes:
        lines.append("| axis | default | description |")
        lines.append("|---|---|---|")
        for a in sc.axes:
            mark = "\\*" if a.is_grid else ""
            lines.append(f"| `{a.name}`{mark} | `{format_default(a.default)}` "
                         f"| {a.help} |")
        lines.append("")
    if sc.metrics:
        lines.append("| metric | unit | description |")
        lines.append("|---|---|---|")
        for m in sc.metrics:
            unit = f"`{m.unit}`" if m.unit else ""
            lines.append(f"| `{m.name}` | {unit} | {m.help} |")
        lines.append("")
    return lines


def catalog_md() -> str:
    """The full markdown catalog, in registry declaration order."""
    lines = [_HEADER]
    scs = all_scenarios()
    lines.append("| scenario | figure | title |")
    lines.append("|---|---|---|")
    for sc in scs:
        lines.append(f"| [`{sc.name}`](#{sc.name}) | {sc.figure or '—'} | {sc.title} |")
    lines.append("")
    for sc in scs:
        lines.extend(_scenario_md(sc))
    return "\n".join(lines).rstrip() + "\n"
