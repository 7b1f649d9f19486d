"""Shared settings of the benchmark's own tests: the ``cuda`` marker, and
tiny configurations and traffic for runs on the CPU."""

import copy
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips on a host without CUDA")


TINY = {
    "rdn": {"name": "tiny-rdn",
            "encoder": {"kind": "rdn", "in_channels": 3, "blocks": 2,
                        "convs": 2, "growth": 16, "growth0": 16},
            "decoder": {"mode": 3, "hidden_dims": [32, 32, 32],
                        "init_q": False, "sine": "polynomial",
                        "out_channels": 3},
            "program": {"model": {"arch": "diinn", "encoder": "rdn-tiny",
                                  "mode": 3, "init_q": False,
                                  "hidden_dims": [32, 32, 32]}}},
    "edsr": {"name": "tiny-edsr",
             "encoder": {"kind": "edsr-baseline", "in_channels": 3,
                         "resblocks": 2, "features": 16},
             "decoder": {"mode": 3, "hidden_dims": [32, 32, 32],
                         "init_q": False, "sine": "polynomial",
                         "out_channels": 3},
             "program": {"model": {"arch": "diinn",
                                   "encoder": "edsr-baseline-tiny",
                                   "mode": 3, "init_q": False,
                                   "hidden_dims": [32, 32, 32]}}},
}


def tiny_config(kind: str = "rdn") -> dict:
    return copy.deepcopy(TINY[kind])


def tiny_traffic(name: str, **changes) -> dict:
    """A traffic file of the benchmark cut to a CPU test's size."""
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    if t["kind"] == "train":
        t.update(batch=2, patch=8, pool=4, trace_steps=2,
                 reference_block=300, reference_image_block=3)
    else:
        t.update(lr_hw=[12, 16], eval_bsize=200, trace_requests=4,
                 reference_block=500)
    t.update(changes)
    return t


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
