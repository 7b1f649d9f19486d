"""Runs one cell of ``BENCHMARK.json`` once, from the checkout's root:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs as many CUDA devices as the cell asks for (exit 2 otherwise, with
no result), and the program (``tpu_diinn_torch``) beside this folder.
Caches stay inside the checkout: the program builds its kernels under
``build/tpu_diinn_torch/``, and Triton's cache is ``build/perfbench/
triton``. See ``harness.py`` for what a run prints.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench",
                                              "triton")
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") !=
                        os.path.dirname(os.path.abspath(__file__))]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
