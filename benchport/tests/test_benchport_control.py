"""The control: the plain reference computed in bfloat16 in the
program's place fails the cell's limits, while the program's own
readings pass them (small sizes on the CPU; the cell's own size on the
card with ``python3 benchport/control.py``)."""

import json
from pathlib import Path

import pytest
import torch

import control
from small import SMALL

LIMITS = Path(__file__).resolve().parents[1] / "limits"


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_and_program_passes(workload):
    over, traffic = SMALL[workload]
    limits = json.loads((LIMITS / f"{workload}.json").read_text())
    lines = control.readings(workload, [101, 202], torch.device("cpu"),
                             overrides=over, traffic=traffic,
                             stream=open("/dev/null", "w"))
    for line in lines:
        prog, ctl = line["program"], line["control"]
        assert all(prog[k] <= limits[k] for k in limits), prog
        assert any(ctl[k] > limits[k] for k in ctl), ctl
