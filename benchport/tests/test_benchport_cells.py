"""Each cell end to end at a small size: on the CPU with the port's plain
versions (every check against the limits the cell states), and on a card
(marked ``chip``)."""

import json

import pytest
import torch

import run
from small import SECONDS, SMALL, TRACED

CELLS = sorted(SMALL)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_is_correct(workload, trace):
    over, traffic = (TRACED if trace else SMALL).get(workload,
                                                     SMALL[workload])
    out = run.run(workload, 2**31 + 7, SECONDS, trace,
                  device=torch.device("cpu"), overrides=over,
                  traffic_overrides=traffic)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["exact"]["value"] == 0
    json.dumps(out)
    if not trace:
        assert "setup_s" in out["metrics"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_small_run_on_the_card(workload, cuda_card):
    over, traffic = SMALL[workload]
    out = run.run(workload, 12345, SECONDS, True, device=cuda_card,
                  overrides=over, traffic_overrides=traffic)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
