"""Port parity: fig10_miku (MIKU vs DataRacing vs Opt, the heaviest grid
figure) on the port's batched lane against the reference's, with
tests/test_torch_figures.py's checks; alone in its file so that parallel
workers share the load."""

import torch

from test_torch_figures import check_grid_scenario

torch.set_num_threads(1)


def test_fig10_miku_matches_reference_batched_lane(monkeypatch):
    check_grid_scenario("fig10_miku", monkeypatch)
