"""The backward CUDA kernels' device code, run on the CPU.

``tpu_diinn_torch/csrc/decoder_bwd_host.cpp`` compiles
``decoder_bwd.cuh`` with g++ and runs ``run_bwd``'s whole launch sequence
with one host thread per CUDA thread, the warpgroup products (wgmma),
TMA copies and mbarriers emulated (see that file). Here it is held against
the plain PyTorch versions on seeded inputs with the wrapper's own weight
slabs (``mma_b_slabs``): dz and every weight gradient within 1e-5 of the
plain version's largest magnitude (the emulation reads TF32 operands and
sums in another order; 3xTF32 keeps fp32-level error, about 2e-7 here),
with the upstream gradient zeroed where a relu pre-activation lies within
1e-5 of zero (``chip_smoke.relu_margin``), and the kq half of dbcat
exactly zero. It cannot check the PTX (descriptor bits, copies) or the
timing: the ``cuda``-marked tests and ``chip_smoke.py`` do that on a card.
Skips without g++.
"""

import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import relu_margin
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import decoder_fused as K

CSRC = Path(K.__file__).resolve().parents[1] / "csrc"
TOL = 1e-5
MARGIN = 1e-5


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    exe = tmp_path_factory.mktemp("host") / "decoder_bwd_host"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(CSRC),
                    str(CSRC / "decoder_bwd_host.cpp"), "-o", str(exe)],
                   check=True, capture_output=True)
    return exe


def _params(gen, h, n_layers):
    def u(shape, fan_in):
        return (torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)
    return {"w0": u((3, h), 3), "b0": u((h,), 3),
            "wcat": u((n_layers - 1, h, 2 * h), h),
            "bcat": u((n_layers - 1, 2 * h), h), "wl": u((h, 3), h),
            "bl": u((3,), h)}


# (hidden, L, B, LR (h, w), integer ratio or None, HR (h, w) of a window)
CASES = [
    (32, 3, 1, (5, 4), (2, 3), None),      # ragged tile, s_h != s_w
    (64, 2, 2, (3, 3), (3, 3), None),      # B > 1
    (32, 4, 1, (6, 5), None, (14, 11)),    # window, one column cut off
    (32, 2, 1, (24, 24), (2, 2), None),    # 2,304 queries: two splits
    (256, 2, 1, (2, 3), (2, 2), None),     # flagship width, two passes
    (64, 3, 2, (2, 2), None, (2, 4)),      # window of 2 x 3 queries
]


@pytest.mark.parametrize("h,n_layers,b,lr,ratio,win", CASES)
def test_host_emulation_matches_plain(harness, tmp_path, h, n_layers, b, lr,
                                      ratio, win):
    gen = torch.Generator().manual_seed(h + lr[0])
    p = _params(gen, h, n_layers)
    z = torch.randn((b, *lr, n_layers * h), generator=gen)
    if ratio is None:
        rows = grids.nearest_exact_indices(lr[0], win[0])
        cols = grids.nearest_exact_indices(lr[1], win[1])[1:]
        syn = grids.syn_input_grid(lr, win)[:, 1:].contiguous()
        s_h = s_w = 1
        hw = (rows.size, cols.size)
    else:
        s_h, s_w = ratio
        hw = (lr[0] * s_h, lr[1] * s_w)
        rows, cols = np.arange(hw[0]) // s_h, np.arange(hw[1]) // s_w
        syn = grids.syn_input_grid(lr, hw)
    keep = relu_margin(z, syn, rows, cols, p) > MARGIN
    g = torch.randn((b, *hw, 3), generator=gen) * keep[..., None]
    wf, wt = (K.mma_b_slabs(w) for w in K.chain_b_operands(p["wcat"]))
    for name, t in [("z", z), ("syn", syn), ("w0", p["w0"]), ("b0", p["b0"]),
                    ("wf", wf), ("bcat", p["bcat"]), ("wl", p["wl"]),
                    ("wt", wt), ("g", g)]:
        t.contiguous().numpy().astype(np.float32).tofile(tmp_path / name)
    np.asarray(rows, np.int32).tofile(tmp_path / "rows")
    np.asarray(cols, np.int32).tofile(tmp_path / "cols")
    args = (int(ratio is None), b, *lr, *hw, s_h, s_w, h, n_layers)
    subprocess.run([str(harness), str(tmp_path), *map(str, args)],
                   check=True, capture_output=True, timeout=600)

    if ratio is None:
        dz_ref, want = K.decode_window_bwd_ref(z, syn, rows, cols, p, g)
    else:
        dz_ref, want = K.decode_int_bwd_ref(z, syn, s_h, s_w, p, g)
    dz = torch.from_numpy(np.fromfile(tmp_path / "dz_out", np.float32))
    flat = torch.from_numpy(np.fromfile(tmp_path / "grads_out", np.float32))
    pairs = [("dz", dz.reshape(z.shape), dz_ref)]
    at = 0
    for key in K.PARAM_KEYS:
        n = want[key].numel()
        pairs.append((key, flat[at:at + n].reshape(want[key].shape),
                      want[key]))
        at += n
    assert at == flat.numel()
    for name, got, ref in pairs:
        err = (got - ref).abs().max().item()
        assert err <= TOL * ref.abs().max().item(), (name, err)
    assert pairs[4][1][:, :h].abs().max().item() == 0.0  # kq half of dbcat
