"""The forward CUDA kernels' device code, run on the CPU.

``tpu_diinn_torch/csrc/decoder_fused_host.cpp`` compiles
``decoder_fused.cuh`` (and the chain routine of ``hopper_chain.cuh`` that
the backward shares) with g++ and runs ``run_fwd``'s launch with one host
thread per CUDA thread, the warpgroup products (wgmma), TMA copies and
mbarriers emulated (``hopper_host.h``). Here it is held against the plain
PyTorch versions on seeded inputs with the wrapper's own weight slabs
(``forward_slabs``): both routes, hidden 32, 64 and 256, L = 1 (no
products) and L = 4, ragged last tiles, within 1e-5 of the plain
version's largest magnitude (the emulation reads TF32 operands and sums in
another order; 3xTF32 keeps fp32-level error). The bf16 instances (the
Bf16 policy: bf16 z, weights and q tiles, one bf16 product per k16 step)
are held against the plain bf16 versions (``pack_params(..., bfloat16)``)
on the same shapes within 1e-2 of the largest magnitude: both round q to
bf16 after fp32 sums taken in different orders, so now and then a q
element rounds to the other neighbour, a bf16 ulp (2^-8 of it) that the
later layers carry on. It cannot check the PTX
(descriptor bits, copies) or the timing: the ``cuda``-marked tests and
``chip_smoke.py`` do that on a card. Skips without g++.
"""

import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import decoder_fused as K

CSRC = Path(K.__file__).resolve().parents[1] / "csrc"
TOL = 1e-5
TOL_BF16 = 1e-2


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    exe = tmp_path_factory.mktemp("host") / "decoder_fused_host"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(CSRC),
                    str(CSRC / "decoder_fused_host.cpp"), "-o", str(exe)],
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
    (32, 4, 1, (5, 4), (2, 3), None),      # 120 queries: a ragged 2nd tile
    (64, 1, 2, (3, 3), (3, 3), None),      # L = 1: no products, B > 1
    (256, 4, 1, (2, 3), (2, 2), None),     # flagship width, two passes
    (256, 1, 1, (3, 2), (3, 5), None),     # flagship width, L = 1
    (32, 4, 1, (6, 5), None, (14, 11)),    # window, one column cut off
    (64, 4, 2, (2, 2), None, (2, 4)),      # window of 2 x 3 queries
    (32, 1, 1, (4, 4), None, (9, 7)),      # window, L = 1
]


def tofile(t: torch.Tensor, path) -> None:
    """A tensor's raw little-endian bits (bf16 as its 16 bits)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    t.numpy().tofile(path)


def run_case(harness, tmp_path, h, n_layers, b, lr, ratio, win,
             dtype=torch.float32):
    """(the emulated kernel's output, the plain version's) for one case,
    z and the weights in ``dtype``."""
    gen = torch.Generator().manual_seed(h + lr[0] + n_layers)
    p = _params(gen, h, n_layers)
    p = {k: v.to(dtype) if k in K.WEIGHT_KEYS else v for k, v in p.items()}
    z = torch.randn((b, *lr, n_layers * h), generator=gen).to(dtype)
    if ratio is None:
        rows = grids.nearest_exact_indices(lr[0], win[0])
        cols = grids.nearest_exact_indices(lr[1], win[1])[1:]
        syn = grids.syn_input_grid(lr, win, dtype=dtype)[:, 1:]
        s_h = s_w = 1
        hw = (rows.size, cols.size)
    else:
        s_h, s_w = ratio
        hw = (lr[0] * s_h, lr[1] * s_w)
        rows, cols = np.arange(hw[0]) // s_h, np.arange(hw[1]) // s_w
        syn = grids.syn_input_grid(lr, hw, dtype=dtype)
    syn = syn.float().contiguous()
    wf = K.forward_slabs(p["wcat"])
    for name, t in [("z", z), ("syn", syn), ("w0", p["w0"]), ("b0", p["b0"]),
                    ("wf", wf), ("bcat", p["bcat"]), ("wl", p["wl"]),
                    ("bl", p["bl"])]:
        tofile(t, tmp_path / name)
    np.asarray(rows, np.int32).tofile(tmp_path / "rows")
    np.asarray(cols, np.int32).tofile(tmp_path / "cols")
    args = (int(ratio is None), b, *lr, *hw, s_h, s_w, h, n_layers,
            int(dtype == torch.bfloat16))
    subprocess.run([str(harness), str(tmp_path), *map(str, args)],
                   check=True, capture_output=True, timeout=600)

    if ratio is None:
        want = K.decode_window_fwd_ref(z, syn, rows, cols, p)
    else:
        want = K.decode_int_fwd_ref(z, syn, s_h, s_w, p)
    got = torch.from_numpy(np.fromfile(tmp_path / "out_out", np.float32))
    return got.reshape(want.shape), want


@pytest.mark.parametrize("h,n_layers,b,lr,ratio,win", CASES)
def test_host_emulation_matches_plain(harness, tmp_path, h, n_layers, b, lr,
                                      ratio, win):
    got, want = run_case(harness, tmp_path, h, n_layers, b, lr, ratio, win)
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


@pytest.mark.parametrize("h,n_layers,b,lr,ratio,win", CASES)
def test_host_emulation_bf16_matches_plain(harness, tmp_path, h, n_layers,
                                           b, lr, ratio, win):
    got, want = run_case(harness, tmp_path, h, n_layers, b, lr, ratio, win,
                         torch.bfloat16)
    err = (got - want).abs().max().item()
    assert err <= TOL_BF16 * want.abs().max().item(), err
