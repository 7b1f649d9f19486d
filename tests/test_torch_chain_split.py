"""``tpu_diinn_torch/tools/chain_split.py``'s cuts against this tree.

Each cut is a text edit of a copy of ``tpu_diinn_torch/csrc`` that must
find its anchor in the current sources (the tool asserts so) and leave
device code that still compiles. Here each cut is made in a copy of the
package and its host harness (``decoder_fused_host.cpp`` for the
forward's cuts, ``decoder_bwd_host.cpp`` for the backward's) is checked
by g++ (``-fsyntax-only``): a source edit that moves an anchor fails
here, not in a card run. The cut copies' timings need a card
(``chain_split.py`` itself). Skips without g++.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

from tpu_diinn_torch.tools import chain_split as C

BWD_HARNESS = "decoder_bwd_host.cpp"
FWD_HARNESS = "decoder_fused_host.cpp"


@pytest.mark.parametrize("cut", sorted(C.CUTS) + sorted(C.FWD_CUTS))
def test_cut_applies_and_compiles(tmp_path, cut):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the cut copy")
    tree = tmp_path / "tree"
    src = Path(C.__file__).resolve().parents[1]
    shutil.copytree(src, tree / "tpu_diinn_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = C._cut(tree, cut)
    csrc = out / "tpu_diinn_torch" / "csrc"
    harness = FWD_HARNESS if (cut in C.FWD_CUTS or cut in (
        "no_mma", "no_refill")) else BWD_HARNESS
    proc = subprocess.run([gxx, "-std=c++20", "-fsyntax-only", "-pthread",
                           "-Wno-unknown-pragmas", "-I", str(csrc),
                           str(csrc / harness)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
