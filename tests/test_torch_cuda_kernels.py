"""The CUDA decoder kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
a card and the CUDA toolkit (no JAX needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: forward, max abs error 1e-4, for fp32 sums taken in another
order over K <= 2 * hidden. Backward, max abs error <= 1e-4 of the plain
version's largest magnitude, for dz and for each weight gradient (sums
over up to every query of the call). The backward comparisons zero the
upstream gradient of the queries whose relu pre-activations come within
1e-5 of zero (``chip_smoke.relu_margin``): there two correct fp32
implementations may take different sides of the relu mask.
"""

import numpy as np
import pytest
import torch

from chip_smoke import relu_margin
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import decoder_fused as K
from tpu_diinn_torch.nn.diinn import DIINN

pytestmark = pytest.mark.cuda


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _params(hidden, n_layers, gen, dev):
    h = hidden
    shapes = {"w0": (3, h), "b0": (h,), "wcat": (n_layers - 1, h, 2 * h),
              "bcat": (n_layers - 1, 2 * h), "wl": (h, 3), "bl": (3,)}
    return {k: ((torch.rand(s, generator=gen) * 2 - 1) / np.sqrt(h)).to(dev)
            for k, s in shapes.items()}


@pytest.mark.parametrize("hidden,n_layers", [(32, 4), (64, 3), (32, 2),
                                             (256, 4)])
@pytest.mark.parametrize("lr,s", [((5, 7), (3, 3)), ((16, 16), (4, 4)),
                                  ((9, 6), (8, 2))])
def test_decode_int_fwd_matches_plain(hidden, n_layers, lr, s):
    dev = _device()
    gen = torch.Generator().manual_seed(hidden + lr[0])
    p = _params(hidden, n_layers, gen, dev)
    z = torch.randn((2, *lr, n_layers * hidden), generator=gen).to(dev)
    out_hw = (lr[0] * s[0], lr[1] * s[1])
    syn = grids.syn_input_grid(lr, out_hw, device=dev)
    before = K.launches["decode_int_fwd"]
    got = K.decode_int_fwd(z, syn, s[0], s[1], p)
    torch.cuda.synchronize()
    assert K.launches["decode_int_fwd"] == before + 1
    want = K.decode_int_fwd_ref(z, syn, s[0], s[1], p)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("hidden", [32, 256])
@pytest.mark.parametrize("window", [(0, 22, 0, 28), (3, 19, 5, 14)])
def test_decode_window_fwd_matches_plain(hidden, window):
    dev = _device()
    gen = torch.Generator().manual_seed(hidden)
    p = _params(hidden, 4, gen, dev)
    lr, out_hw = (7, 9), (22, 28)
    z = torch.randn((2, *lr, 4 * hidden), generator=gen).to(dev)
    r0, r1, c0, c1 = window
    rows = grids.nearest_exact_indices(lr[0], out_hw[0])[r0:r1]
    cols = grids.nearest_exact_indices(lr[1], out_hw[1])[c0:c1]
    syn = grids.syn_input_grid(lr, out_hw, device=dev)[r0:r1, c0:c1]
    syn = syn.contiguous()
    got = K.decode_window_fwd(z, syn, K.index_vector(rows, lr[0], dev),
                              K.index_vector(cols, lr[1], dev), p)
    torch.cuda.synchronize()
    want = K.decode_window_fwd_ref(z, syn, rows, cols, p)
    assert (got - want).abs().max().item() <= 1e-4


MARGIN = 1e-5


def _bwd_case(hidden, n_layers, b, lr, out_hw, window, seed):
    dev = _device()
    gen = torch.Generator().manual_seed(seed)
    p = _params(hidden, n_layers, gen, dev)
    z = torch.randn((b, *lr, n_layers * hidden), generator=gen).to(dev)
    rows = grids.nearest_exact_indices(lr[0], out_hw[0])
    cols = grids.nearest_exact_indices(lr[1], out_hw[1])
    syn = grids.syn_input_grid(lr, out_hw, device=dev)
    if window is not None:
        r0, r1, c0, c1 = window
        rows, cols = rows[r0:r1], cols[c0:c1]
        syn = syn[r0:r1, c0:c1].contiguous()
    g = torch.randn((b, rows.size, cols.size, 3), generator=gen).to(dev)
    keep = relu_margin(z, syn, rows, cols, p) > MARGIN
    return z, syn, rows, cols, p, (g * keep[..., None]).contiguous()


def _assert_bwd_close(got, want):
    dz, grads = got
    dz_ref, grads_ref = want
    pairs = [("dz", dz, dz_ref)] + [(k, grads[k], grads_ref[k])
                                   for k in K.PARAM_KEYS]
    for name, a, b in pairs:
        assert a.shape == b.shape, name
        if b.numel():
            err = (a - b).abs().max().item()
            assert err <= 1e-4 * b.abs().max().item(), (name, err)
    h = grads["w0"].shape[1]
    assert grads["bcat"][:, :h].abs().max().item() == 0.0


@pytest.mark.parametrize("hidden,n_layers", [(32, 4), (64, 3), (256, 4)])
@pytest.mark.parametrize("b,lr,s", [(2, (6, 8), (2, 2)), (1, (5, 7), (3, 3)),
                                    (3, (9, 6), (4, 4))])
def test_decode_int_bwd_matches_plain(hidden, n_layers, b, lr, s):
    """Ragged last tiles (5x7 x3 = 315 queries, 9x6 x4 = 864 per image)
    and B > 1."""
    out_hw = (lr[0] * s[0], lr[1] * s[1])
    z, syn, _, _, p, g = _bwd_case(hidden, n_layers, b, lr, out_hw, None,
                                   hidden + lr[0])
    before = K.launches["decode_int_bwd"]
    got = K.decode_int_bwd(z, syn, s[0], s[1], p, g)
    torch.cuda.synchronize()
    assert K.launches["decode_int_bwd"] == before + 1
    _assert_bwd_close(got, K.decode_int_bwd_ref(z, syn, s[0], s[1], p, g))


@pytest.mark.parametrize("hidden", [32, 64, 256])
@pytest.mark.parametrize("b,window", [(1, None), (2, (3, 19, 5, 14))])
def test_decode_window_bwd_matches_plain(hidden, b, window):
    z, syn, rows, cols, p, g = _bwd_case(hidden, 3, b, (7, 9), (22, 28),
                                         window, hidden)
    before = K.launches["decode_window_bwd"]
    got = K.decode_window_bwd(z, syn, K.index_vector(rows, 7, z.device),
                              K.index_vector(cols, 9, z.device), p, g)
    torch.cuda.synchronize()
    assert K.launches["decode_window_bwd"] == before + 1
    _assert_bwd_close(got, K.decode_window_bwd_ref(z, syn, rows, cols, p, g))


def test_decode_int_bwd_is_deterministic():
    """The weight-gradient reduction sums fixed splits in a fixed order:
    two calls on the same inputs agree bit for bit (9,216 queries, three
    splits)."""
    z, syn, _, _, p, g = _bwd_case(64, 3, 1, (24, 24), (96, 96), None, 7)
    a = K.decode_int_bwd(z, syn, 4, 4, p, g)
    b = K.decode_int_bwd(z, syn, 4, 4, p, g)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in K.PARAM_KEYS)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _device()
    gen = torch.Generator().manual_seed(0)
    p = _params(32, 4, gen, dev)
    z = torch.randn((1, 4, 4, 128), generator=gen).to(dev)
    syn = grids.syn_input_grid((4, 4), (8, 8), device=dev)
    with pytest.raises(ValueError, match="float32"):
        K.decode_int_fwd(z.double(), syn, 2, 2, p)
    with pytest.raises(ValueError, match="contiguous"):
        K.decode_int_fwd(z.transpose(1, 2), syn, 2, 2, p)
    with pytest.raises(ValueError, match="hidden"):
        K.decode_int_fwd(torch.randn((1, 4, 4, 4 * 48), device=dev), syn,
                         2, 2, _params(48, 4, gen, dev))
    cols = K.index_vector(np.arange(8) // 2, 4, dev)
    with pytest.raises(ValueError, match="rows must be a 1-D contiguous"):
        K.decode_window_fwd(z, syn, np.arange(8) // 2, cols, p)
    with pytest.raises(ValueError, match="rows must be a 1-D contiguous"):
        K.decode_window_bwd(z, syn, cols.cpu(), cols, p,
                            torch.zeros((1, 8, 8, 3), device=dev))
    with pytest.raises(ValueError, match="g must be"):
        K.decode_int_bwd(z, syn, 2, 2, p, torch.zeros((1, 8, 7, 3),
                                                      device=dev))


def test_grad_recording_flagship_forward_launches_the_kernels():
    """The flagship config (RDN-B, mode 3, 4 x 256, fp32) with its
    parameters recording gradients: each route launches its forward
    kernel, and a backward through it launches the matching backward
    kernel once and fills every parameter's gradient."""
    dev = _device()
    torch.backends.cudnn.allow_tf32 = False
    net = DIINN(generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(dev)
    for fwd, bwd, out_hw in (("decode_int_fwd", "decode_int_bwd", (32, 32)),
                             ("decode_window_fwd", "decode_window_bwd",
                              (25, 25))):
        before = {k: K.launches[k] for k in (fwd, bwd)}
        net.zero_grad()
        out = net(x, out_hw, 30000)
        torch.cuda.synchronize()
        assert K.launches[fwd] == before[fwd] + 1
        assert out.requires_grad and out.shape == (1, *out_hw, 3)
        out.sum().backward()
        torch.cuda.synchronize()
        assert K.launches[bwd] == before[bwd] + 1
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in net.parameters())
