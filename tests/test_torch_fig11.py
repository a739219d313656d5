"""Port parity: the §6 case study (fig11_llm) in the port's registry, and
the serving CLI at its defaults, on the CPU.

fig11's rows are the simulated queue clock's (the reference's tier
constants), so they depend on byte counts, not on the tokens: at the
reference's defaults (48 + 16 requests, 24 new tokens, 64 chunks) the
port's rows must equal the reference's, MIKU's restricted windows
included."""

import pytest
import torch

from repro.scenarios import run_scenario as ref_run_scenario
from repro_torch.scenarios import SCENARIOS, Axis, Scenario, run_scenario

torch.set_num_threads(1)


def test_fig11_rows_equal_reference_at_defaults():
    ref_rows = ref_run_scenario("fig11_llm").rows
    rows = run_scenario("fig11_llm", device="cpu").rows
    assert rows == ref_rows
    opt, racing, miku = rows
    # The paper's §6 result: racing costs the HBM instance, MIKU wins most
    # of it back by restricting the host stream in some windows.
    assert racing["hbm_pct_of_opt"] < miku["hbm_pct_of_opt"] <= 100.0
    assert 0 < miku["restricted_windows"] < miku["windows"]


def test_fig11_is_a_run_cell_scenario():
    sc = SCENARIOS["fig11_llm"]
    assert sc.run_cell is not None and sc.build is None and sc.slow
    assert [a.name for a in sc.axes] == ["arch", "n_req_fast", "n_req_slow", "new_tokens",
                                         "chunks"]
    with pytest.raises(ValueError, match="exactly one form"):
        Scenario(name="both", title="", axes=(Axis("x", 1),), build=lambda *a: [],
                 reduce=lambda *a: [], run_cell=lambda *a: [])
    with pytest.raises(ValueError, match="exactly one form"):
        Scenario(name="neither", title="")


def test_sweep_cli_runs_fig11_on_cpu(capsys):
    from repro_torch.launch.sweep import main

    main(["fig11_llm", "--set", "n_req_fast=4", "--set", "n_req_slow=2",
          "--set", "new_tokens=4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("variant,hbm_tokens_per_s,host_tokens_per_s,hbm_pct_of_opt,"
                        "host_pct_of_opt,restricted_windows,windows")
    assert [line.split(",")[0] for line in lines[1:]] == ["opt", "racing", "miku"]


def test_serve_cli_runs_its_defaults_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["[serve/miku] hbm",
                                                      "[serve/miku] host"]
    assert "(24 requests)" in lines[0] and "(8 requests)" in lines[1]
