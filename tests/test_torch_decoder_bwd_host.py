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
exactly zero. The bf16 instances (the Bf16 policy) are held against the
plain bf16 versions on the same shapes plus hidden 256 at L = 4, within
1e-2 of the largest magnitude, the upstream gradient zeroed where a relu
pre-activation of the bf16 chain lies within 1e-3 of zero: both sides
round q, d, dpre_0 and g to bf16 after fp32 sums taken in different
orders, so now and then a value rounds to the other neighbour (2^-8 of
it), and dz is rounded to bf16 once. The bf16 cases cover both of its dz
routes: folded inside the chain kernel's pixel-ordered tiles (integer
ratios with s_h * s_w <= 64, among them a ragged last tile and x3's dead
row) and through fold_dz_bf16_kernel (the window, and (9, 8)), and a single
layer. ``test_scratch_bytes_a_query`` reads the scratch the harness
allocates. It cannot check the PTX (descriptor bits, copies) or the
timing: the ``cuda``-marked tests and ``chip_smoke.py`` do that on a
card. Skips without g++.
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
TOL_BF16, MARGIN_BF16 = 1e-2, 1e-3


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


def tofile(t: torch.Tensor, path) -> None:
    """A tensor's raw little-endian bits (bf16 as its 16 bits)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    t.numpy().tofile(path)


def run_case(harness, tmp_path, h, n_layers, b, lr, ratio, win,
             dtype=torch.float32, margin=MARGIN):
    """[(name, the emulated kernel's result, the plain version's)] for dz
    and each weight gradient of one case, z and the weights in ``dtype``."""
    gen = torch.Generator().manual_seed(h + lr[0])
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
    keep = relu_margin(z, syn, rows, cols, p) > margin
    g = torch.randn((b, *hw, 3), generator=gen) * keep[..., None]
    wf, wt = (K.mma_b_slabs(w) for w in K.chain_b_operands(p["wcat"]))
    for name, t in [("z", z), ("syn", syn), ("w0", p["w0"]), ("b0", p["b0"]),
                    ("wf", wf), ("bcat", p["bcat"]), ("wl", p["wl"]),
                    ("wt", wt), ("g", g)]:
        tofile(t, tmp_path / name)
    np.asarray(rows, np.int32).tofile(tmp_path / "rows")
    np.asarray(cols, np.int32).tofile(tmp_path / "cols")
    args = (int(ratio is None), b, *lr, *hw, s_h, s_w, h, n_layers,
            int(dtype == torch.bfloat16))
    subprocess.run([str(harness), str(tmp_path), *map(str, args)],
                   check=True, capture_output=True, timeout=600)

    if ratio is None:
        dz_ref, want = K.decode_window_bwd_ref(z, syn, rows, cols, p, g)
    else:
        dz_ref, want = K.decode_int_bwd_ref(z, syn, s_h, s_w, p, g)
    raw = np.fromfile(tmp_path / "dz_out",
                      np.int16 if dtype == torch.bfloat16 else np.float32)
    dz = torch.from_numpy(raw)
    dz = dz.view(torch.bfloat16) if dtype == torch.bfloat16 else dz
    flat = torch.from_numpy(np.fromfile(tmp_path / "grads_out", np.float32))
    pairs = [("dz", dz.reshape(z.shape).float(), dz_ref.float())]
    at = 0
    for key in K.PARAM_KEYS:
        n = want[key].numel()
        pairs.append((key, flat[at:at + n].reshape(want[key].shape),
                      want[key]))
        at += n
    assert at == flat.numel()
    if n_layers > 1:  # the kq half of dbcat
        assert pairs[4][1][:, :h].abs().max().item() == 0.0
    return pairs


@pytest.mark.parametrize("h,n_layers,b,lr,ratio,win", CASES)
def test_host_emulation_matches_plain(harness, tmp_path, h, n_layers, b, lr,
                                      ratio, win):
    pairs = run_case(harness, tmp_path, h, n_layers, b, lr, ratio, win)
    for name, got, ref in pairs:
        err = (got - ref).abs().max().item()
        assert err <= TOL * ref.abs().max().item(), (name, err)


@pytest.mark.parametrize("h,n_layers,b,lr,ratio,win", CASES + [
    (256, 4, 1, (2, 2), (2, 2), None),     # flagship width and depth
    (32, 3, 2, (3, 5), (4, 4), None),      # x4: 4 pixels a tile, ragged
    (256, 4, 1, (3, 3), (3, 3), None),     # x3: 7 pixels and a dead row
    (32, 2, 1, (2, 2), (9, 8), None),      # 72 queries a pixel: fold pass
    (256, 4, 1, (3, 3), None, (5, 7)),     # window, flagship width
    (64, 1, 2, (3, 2), (2, 2), None),      # one layer
])
def test_host_emulation_bf16_matches_plain(harness, tmp_path, h, n_layers,
                                           b, lr, ratio, win):
    pairs = run_case(harness, tmp_path, h, n_layers, b, lr, ratio, win,
                     torch.bfloat16, MARGIN_BF16)
    for name, got, ref in pairs:
        if ref.numel() == 0:  # one layer: no dWcat, dbcat
            assert got.numel() == 0, name
            continue
        err = (got - ref).abs().max().item()
        assert err <= TOL_BF16 * ref.abs().max().item(), (name, err)



# the flagship's training shapes (smoke phase 3b: B 4, LR 48, hidden 256,
# L = 4): x2, x3, x4 and the x2.5 window; a bound of bytes a query each
SCRATCH_CASES = [
    (torch.bfloat16, 2, 6144), (torch.bfloat16, 3, 6144),
    (torch.bfloat16, 4, 6144), (torch.bfloat16, 2.5, 10240),
    (torch.float32, 4, 18432),
]


@pytest.mark.parametrize("dtype,scale,limit", SCRATCH_CASES)
def test_scratch_bytes_a_query(harness, dtype, scale, limit):
    """The scratch the harness allocates (its ``plan`` mode prints it for
    a shape without running it), per query and without the weight
    gradients' partial sums: the bf16 integer route at most 6,144 B (bf16
    q and d; x3's dead row of every tile included), its window route at
    most 10,240 (plus fp32 dz terms); the fp32 design exactly 18,432. The
    partial sums come on top."""
    b, lr, h_out = 4, 48, int(48 * scale)
    window = int(scale != int(scale))
    s = 1 if window else int(scale)
    out = subprocess.run(
        [str(harness), "-", str(window), str(b), str(lr), str(lr),
         str(h_out), str(h_out), str(s), str(s), "256", "4",
         str(int(dtype == torch.bfloat16)), "plan"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()
    plan = {k: int(v) for k, v in zip(out[::2], out[1::2])}
    assert plan["n_query"] == b * h_out * h_out
    per_query = plan["activation_bytes"] / plan["n_query"]
    if dtype == torch.bfloat16:
        assert per_query <= limit, plan
    else:
        assert per_query == limit, plan
    assert plan["scratch_bytes"] > plan["activation_bytes"]
