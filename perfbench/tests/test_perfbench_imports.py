"""What the harness and the reference load, seen from a fresh process:
no JAX, no JAX package (top-level names compared whole, since the port's
name begins with the JAX package's), and in the reference nothing of the
program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_diinn"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after("import perfbench.reference.diinn, "
                       "perfbench.reference.precision, perfbench.weights")
    assert not top & FORBIDDEN
    assert "tpu_diinn_torch" not in top


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, 'perfbench/tests')\n"
        "import torch\n"
        "from conftest import tiny_config, tiny_traffic\n"
        "from perfbench import harness, control\n"
        "real = harness.load_cell(harness.load_benchmark(), "
        "'diinn-edsr.upscale')\n"
        "c = harness.Cell('t', 1, tiny_config('edsr'), "
        "tiny_traffic('upscale-192x256'), real.limits, real.end_to_end, "
        "real.per_layer)\n"
        "out = harness.run_cell(c, 3, 0.2, False, torch.device('cpu'), 0.0)\n"
        "assert out['correct'], out\n"
        "assert harness.forbidden_modules() == []\n")
    top = loaded_after(code)
    assert "tpu_diinn_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_imports_only_torch():
    for f in (ROOT / "perfbench" / "reference").glob("*.py"):
        text = f.read_text()
        for line in text.splitlines():
            if line.startswith(("import ", "from ")):
                mod = line.split()[1].split(".")[0]
                assert mod in {"__future__", "math", "typing", "torch",
                               "perfbench"}, (f.name, line)
