"""Each fault the cells can have, planted under the timed path of a whole
run, makes ``correct`` false; and the control (the reference in the
precision below the traffic's, in the program's place) reads above the
program."""

import pytest
import torch

from conftest import tiny_config, tiny_traffic
from perfbench import faults, harness
from perfbench.drivers.common import Context


def tiny_cell(name: str, kind: str, traffic: str, **changes):
    real = harness.load_cell(harness.load_benchmark(), name)
    return harness.Cell(name, 1, tiny_config(kind),
                        tiny_traffic(traffic, **changes), real.limits,
                        real.end_to_end, real.per_layer)


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_training_fault_is_not_correct(fault, cpu):
    c = tiny_cell("diinn-rdn.train", "rdn", "train-b16-x234")
    out = harness.run_cell(c, 11, 0.2, False, cpu, 0.0,
                           plant=faults.TRAIN[fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.UPSCALE))
def test_an_upscaling_fault_is_not_correct(fault, cpu):
    c = tiny_cell("diinn-edsr.upscale", "edsr", "upscale-192x256")
    out = harness.run_cell(c, 11, 0.2, False, cpu, 0.0,
                           plant=faults.UPSCALE[fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("kind,traffic,control,number,ratio", [
    ("rdn", "train-b16-x234", "fp8", "pred_gap", 3.0),
    ("edsr", "train-b16-x234", "fp8", "pred_gap", 3.0),
    ("rdn", "train-b16-x234", "int8", "grad_norm_gap_median", 1.0),
    ("edsr", "upscale-192x256", "tf32", "max_abs_gap", 3.0)])
def test_the_control_reads_above_the_program(kind, traffic, control, number,
                                             ratio, cpu):
    """Each control's path at a tiny size: it reads above the program (at
    the cells' own size, on the card, it fails their limits:
    ``test_perfbench_card.py``)."""
    from perfbench import control as readings_of
    lower, upper = [], []
    for seed in (1, 2, 3):
        ctx = Context(tiny_config(kind), tiny_traffic(traffic), seed, 0.0,
                      False, cpu, 0.0, log=lambda msg: None)
        got = dict(readings_of.readings(ctx, [control], with_faults=False))
        lower.append(got["program"][number])
        upper.append(got[f"control_{control}"][number])
    assert sorted(upper)[1] >= ratio * sorted(lower)[1], (lower, upper)
