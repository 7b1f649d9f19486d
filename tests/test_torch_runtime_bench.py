"""Port parity for the runtime benchmark CLI (``cli/runtime_bench.py``),
and the card default of the new entry points.

- The JSON line's keys (one per family and scale) equal the JAX CLI's for
  the same small arguments; every value is a positive time. The times
  themselves are not compared: they are the CPU's here.
- ``cli.demo`` and ``cli.runtime_bench`` run on the card unless given
  ``--device cpu``, and refuse to run on a host without CUDA.
"""

import json

import pytest
import torch

from tpu_diinn.cli import runtime_bench as jbench
from tpu_diinn_torch.cli import demo as tdemo
from tpu_diinn_torch.cli import runtime_bench as tbench
from tests.test_torch_train import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--input", "8", "--scales", "2", "2.5", "--encoder", "rdn-tiny",
        "--iters", "1"]


def test_runtime_bench_keys_match_jax(capsys, monkeypatch):
    monkeypatch.setenv("TPU_DIINN_COMPILE_CACHE", "0")
    want = jbench.main(ARGS)
    capsys.readouterr()
    got = tbench.main(ARGS + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert list(got) == list(want) and len(got) == 8
    assert all(v > 0 for v in got.values())
    assert json.loads(lines[-1]) == got and len(lines) == 9
    assert lines[0].startswith("bicubic  x2    16x16: ")


@pytest.mark.parametrize("main,args", [
    (tdemo.main, ["sr", "--lr_path", "unused.png", "--output_size", "8",
                  "8", "--ckpt_path", "unused.npz"]),
    (tbench.main, ARGS)])
def test_cli_defaults_to_cuda_and_refuses_cpu_fallback(main, args):
    if torch.cuda.is_available():
        pytest.skip("host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
