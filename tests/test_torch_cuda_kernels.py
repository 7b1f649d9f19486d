"""The CUDA kernels against their plain PyTorch versions, on a card: the
decoder's, and at the end the fp32 inference encoder's conv.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
a card and the CUDA toolkit (no JAX needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: forward, max abs error 1e-4, for fp32 sums taken in another
order over K <= 2 * hidden. Backward, max abs error <= 1e-4 of the plain
version's largest magnitude, for dz and for each weight gradient (sums
over up to every query of the call). The backward comparisons zero the
upstream gradient of the queries whose relu pre-activations come within
1e-5 of zero (``chip_smoke.relu_margin``): there two correct fp32
implementations may take different sides of the relu mask. The bf16
instances' tolerances are stated beside their tests, at the end.
"""

import numpy as np
import pytest
import torch

from chip_smoke import relu_margin
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import decoder_fused as K
from tpu_diinn_torch.kernels import encoder_conv as EC
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


def test_decode_window_fwd_single_layer_matches_plain():
    """L = 1 (no products: layer 0 and the head alone), hidden 64, a
    window with a ragged last tile."""
    dev = _device()
    gen = torch.Generator().manual_seed(64)
    p = _params(64, 1, gen, dev)
    lr, out_hw = (7, 9), (22, 28)
    z = torch.randn((2, *lr, 64), generator=gen).to(dev)
    rows = grids.nearest_exact_indices(lr[0], out_hw[0])[2:21]
    cols = grids.nearest_exact_indices(lr[1], out_hw[1])[1:26]
    syn = grids.syn_input_grid(lr, out_hw, device=dev)[2:21, 1:26]
    syn = syn.contiguous()
    before = K.launches["decode_window_fwd"]
    got = K.decode_window_fwd(z, syn, K.index_vector(rows, lr[0], dev),
                              K.index_vector(cols, lr[1], dev), p)
    torch.cuda.synchronize()
    assert K.launches["decode_window_fwd"] == before + 1
    want = K.decode_window_fwd_ref(z, syn, rows, cols, p)
    assert (got - want).abs().max().item() <= 1e-4


def test_decode_int_fwd_is_deterministic():
    """Two calls on the same inputs agree bit for bit (flagship width,
    x4 x3 on LR 9x7, B 2: 1,512 queries a batch, a ragged last tile)."""
    dev = _device()
    gen = torch.Generator().manual_seed(5)
    p = _params(256, 4, gen, dev)
    z = torch.randn((2, 9, 7, 4 * 256), generator=gen).to(dev)
    syn = grids.syn_input_grid((9, 7), (36, 21), device=dev)
    a = K.decode_int_fwd(z, syn, 4, 3, p)
    b = K.decode_int_fwd(z, syn, 4, 3, p)
    assert torch.equal(a, b)


def test_decode_window_fwd_is_deterministic():
    """As for the integer route, at x2.5 (LR 24 -> 60, B 2)."""
    dev = _device()
    gen = torch.Generator().manual_seed(6)
    p = _params(256, 4, gen, dev)
    z = torch.randn((2, 24, 24, 4 * 256), generator=gen).to(dev)
    idx = grids.nearest_exact_indices(24, 60)
    syn = grids.syn_input_grid((24, 24), (60, 60), device=dev)
    v = K.index_vector(idx, 24, dev)
    a = K.decode_window_fwd(z, syn, v, v, p)
    b = K.decode_window_fwd(z, syn, v, v, p)
    assert torch.equal(a, b)


def test_decode_window_fwd_streaming_band_matches_plain():
    """The x20 streaming band of the demo's 5120 x 5120 output: LR
    256 x 256, z of 4 x 256 channels, one band of 32 rows over all 5120
    columns (B 1), fp32 within 1e-4 and the bf16 instance within 2e-2 of
    the largest magnitude (the bf16 bound below)."""
    dev = _device()
    gen = torch.Generator().manual_seed(20)
    p = _params(256, 4, gen, dev)
    z = torch.randn((1, 256, 256, 4 * 256), generator=gen).to(dev)
    lo, hi = 2560, 2592
    rows = grids.nearest_exact_indices(256, 5120)[lo:hi]
    cols = grids.nearest_exact_indices(256, 5120)
    syn = grids.syn_input_grid((256, 256), (5120, 5120),
                               device=dev)[lo:hi].contiguous()
    rv, cv = K.index_vector(rows, 256, dev), K.index_vector(cols, 256, dev)
    got = K.decode_window_fwd(z, syn, rv, cv, p)
    want = K.decode_window_fwd_ref(z, syn, rows, cols, p)
    assert got.shape == (1, 32, 5120, 3)
    assert (got - want).abs().max().item() <= 1e-4
    zb, pb = z.to(torch.bfloat16), {
        k: v.to(torch.bfloat16) if k in K.WEIGHT_KEYS else v
        for k, v in p.items()}
    got = K.decode_window_fwd(zb, syn, rv, cv, pb)
    want = K.decode_window_fwd_ref(zb, syn, rows, cols, pb)
    err = (got - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err


def test_streaming_decode_equals_one_window_decode(monkeypatch):
    """``predict_streaming`` (one ``decode_window_fwd`` launch a band) and
    one window over the whole x20 grid agree bit for bit: the same chain
    per query, tiled otherwise (flagship decoder widths over an RDN-tiny
    encoder, LR 16 x 16 -> 320 x 320, bands of 32 rows)."""
    from tpu_diinn_torch.train.streaming import predict_streaming
    from tpu_diinn_torch.train.task import denormalize, normalize
    dev = _device()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net = DIINN(encoder_spec="rdn-tiny",
                generator=torch.Generator().manual_seed(2)).to(dev)
    x = torch.rand((1, 16, 16, 3),
                   generator=torch.Generator().manual_seed(3)).to(dev)
    before = K.launches["decode_window_fwd"]
    got = predict_streaming(net, x, (320, 320), band_rows=32)
    assert K.launches["decode_window_fwd"] == before + 10
    with torch.no_grad():
        whole = net(normalize(x), (320, 320), None)
    want = torch.clamp(denormalize(whole), 0.0, 1.0).cpu().numpy()
    assert np.array_equal(got, want)


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


def test_decode_window_bwd_flagship_width_matches_plain():
    """Hidden 256, L = 4 at x2.5 (LR 16x14 -> 40x35, B 2: 2,800 queries,
    two weight-gradient splits), the flagship's fractional training
    route."""
    z, syn, rows, cols, p, g = _bwd_case(256, 4, 2, (16, 14), (40, 35),
                                         None, 11)
    before = K.launches["decode_window_bwd"]
    got = K.decode_window_bwd(z, syn, K.index_vector(rows, 16, z.device),
                              K.index_vector(cols, 14, z.device), p, g)
    torch.cuda.synchronize()
    assert K.launches["decode_window_bwd"] == before + 1
    _assert_bwd_close(got, K.decode_window_bwd_ref(z, syn, rows, cols, p, g))


def _stripe_case(hidden, b, lr, out_hw, start, width, seed):
    """A clamped column stripe of the ``out_hw`` grid, as query sharding
    decodes it (``parallel/sharding.py``): HR columns [start, start +
    width) with those past the last one repeating it."""
    from tpu_diinn_torch.parallel.sharding import stripe_columns
    dev = _device()
    gen = torch.Generator().manual_seed(seed)
    p = _params(hidden, 4, gen, dev)
    z = torch.randn((b, *lr, 4 * hidden), generator=gen).to(dev)
    hr_cols = stripe_columns(out_hw[1], start, width)
    rows = grids.nearest_exact_indices(lr[0], out_hw[0])
    cols = grids.nearest_exact_indices(lr[1], out_hw[1])[hr_cols]
    ry, rx = grids.rel_coord_axes(lr, out_hw, device=dev)
    syn = grids.syn_from_axes(ry, rx[torch.from_numpy(hr_cols).to(dev)],
                              grids.area_ratio(lr, out_hw)).contiguous()
    g = torch.randn((b, rows.size, cols.size, 3), generator=gen).to(dev)
    keep = relu_margin(z, syn, rows, cols, p) > MARGIN
    return z, syn, rows, cols, p, (g * keep[..., None]).contiguous()


@pytest.mark.parametrize("hidden", [32, 256])
@pytest.mark.parametrize("start,width", [(48, 8), (56, 8), (21, 3)],
                         ids=["overhang", "past_the_edge", "narrow"])
def test_decode_window_stripe_matches_plain(hidden, start, width):
    """The stripes of ``decode_sharded`` and the space-sharded step: the
    last stripe of a 53-column grid with its overhang repeating column 52
    (and one that starts past it: all columns repeated), and a stripe of 3
    columns, narrower than the kernels' query tile."""
    z, syn, rows, cols, p, g = _stripe_case(hidden, 2, (16, 16), (41, 53),
                                            start, width, hidden + start)
    rv = K.index_vector(rows, 16, z.device)
    cv = K.index_vector(cols, 16, z.device)
    before = dict(K.launches)
    got = K.decode_window_fwd(z, syn, rv, cv, p)
    got_b = K.decode_window_bwd(z, syn, rv, cv, p, g)
    torch.cuda.synchronize()
    assert K.launches["decode_window_fwd"] == before["decode_window_fwd"] + 1
    assert K.launches["decode_window_bwd"] == before["decode_window_bwd"] + 1
    want = K.decode_window_fwd_ref(z, syn, rows, cols, p)
    assert (got - want).abs().max().item() <= 1e-4
    if start + width > 53:          # the repeated columns agree exactly
        last = 53 - start if start < 53 else 0
        for j in range(max(last, 1), width):
            assert torch.equal(got[:, :, j], got[:, :, max(last - 1, 0)])
    _assert_bwd_close(got_b, K.decode_window_bwd_ref(z, syn, rows, cols, p,
                                                     g))


def _assert_same(a, b):
    """Two backward results (dz, grads) agree bit for bit."""
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in K.PARAM_KEYS)


def _assert_equal_calls(call):
    _assert_same(call(), call())


def test_decode_int_bwd_is_deterministic():
    """The weight-gradient reduction sums fixed splits in a fixed order:
    two calls on the same inputs agree bit for bit (9,216 queries, five
    splits)."""
    z, syn, _, _, p, g = _bwd_case(64, 3, 1, (24, 24), (96, 96), None, 7)
    _assert_equal_calls(lambda: K.decode_int_bwd(z, syn, 4, 4, p, g))


def test_decode_window_bwd_is_deterministic():
    """As for the integer route, at x2.5 (LR 24 -> 60, B 2: 7,200 queries,
    four splits)."""
    z, syn, rows, cols, p, g = _bwd_case(64, 3, 2, (24, 24), (60, 60), None,
                                         8)
    rv = K.index_vector(rows, 24, z.device)
    cv = K.index_vector(cols, 24, z.device)
    _assert_equal_calls(lambda: K.decode_window_bwd(z, syn, rv, cv, p, g))


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


def test_grad_recording_flagship_forward_launches_the_kernels(monkeypatch):
    """The flagship config (RDN-B, mode 3, 4 x 256, fp32) with its
    parameters recording gradients: each route launches its forward
    kernel, and a backward through it launches the matching backward
    kernel once and fills every parameter's gradient."""
    dev = _device()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
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


# The bf16 instances (the JAX package's bf16 mode: z and the weights bf16,
# q rounded to bf16 before each product, fp32 sums) against their plain
# bf16 versions. Both round to bf16 after fp32 sums taken in different
# orders, so now and then an element rounds to the other neighbour (2^-8
# of it) and the later layers carry that on: the forward is held to 2e-2
# of the plain version's largest magnitude, the backward to 1e-2, with the
# upstream gradient zeroed within 1e-3 of a relu's switch point of the
# bf16 chain.
BF16 = torch.bfloat16


def _as_bf16(z, p):
    return z.to(BF16), {k: v.to(BF16) if k in K.WEIGHT_KEYS else v
                        for k, v in p.items()}


def _close_bf16(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("hidden,n_layers", [(32, 4), (64, 3), (256, 4)])
@pytest.mark.parametrize("lr,s", [((5, 7), (3, 3)), ((9, 6), (8, 2))])
def test_decode_int_fwd_bf16_matches_plain(hidden, n_layers, lr, s):
    dev = _device()
    gen = torch.Generator().manual_seed(hidden + lr[0])
    z, p = _as_bf16(torch.randn((2, *lr, n_layers * hidden),
                                generator=gen).to(dev),
                    _params(hidden, n_layers, gen, dev))
    out_hw = (lr[0] * s[0], lr[1] * s[1])
    syn = grids.syn_input_grid(lr, out_hw, dtype=BF16, device=dev).float()
    before = dict(K.launches)
    got = K.decode_int_fwd(z, syn, s[0], s[1], p)
    torch.cuda.synchronize()
    assert K.launches["decode_int_fwd_bf16"] == \
        before["decode_int_fwd_bf16"] + 1
    assert K.launches["decode_int_fwd"] == before["decode_int_fwd"]
    assert got.dtype == torch.float32
    _close_bf16(got, K.decode_int_fwd_ref(z, syn, s[0], s[1], p), 2e-2)


@pytest.mark.parametrize("hidden", [32, 256])
def test_decode_window_fwd_bf16_matches_plain(hidden):
    dev = _device()
    gen = torch.Generator().manual_seed(hidden)
    lr, out_hw = (7, 9), (22, 28)
    z, p = _as_bf16(torch.randn((2, *lr, 4 * hidden), generator=gen).to(dev),
                    _params(hidden, 4, gen, dev))
    rows = grids.nearest_exact_indices(lr[0], out_hw[0])[3:19]
    cols = grids.nearest_exact_indices(lr[1], out_hw[1])[5:14]
    syn = grids.syn_input_grid(lr, out_hw, dtype=BF16, device=dev)
    syn = syn[3:19, 5:14].float().contiguous()
    got = K.decode_window_fwd(z, syn, K.index_vector(rows, lr[0], dev),
                              K.index_vector(cols, lr[1], dev), p)
    torch.cuda.synchronize()
    _close_bf16(got, K.decode_window_fwd_ref(z, syn, rows, cols, p), 2e-2)


@pytest.mark.parametrize("window", [False, True])
def test_bf16_forward_runs_its_own_kernel_on_a_persistent_grid(window):
    """Both bf16 forward routes launch ``decode_fwd_bf16_kernel`` (counted
    in the device's own records) and no ``decode_fwd_kernel``. At hidden
    256 with more 128-query tiles than the card has SMs (B 2, LR 48 x4:
    288 tiles; the persistent grid's walk wraps) the output is within the
    plain bf16 version's tolerance above, finite, and two calls agree bit
    for bit."""
    from torch.profiler import ProfilerActivity, profile
    dev = _device()
    gen = torch.Generator().manual_seed(7)
    h_in, s = 48, 4
    z, p = _as_bf16(torch.randn((2, h_in, h_in, 4 * 256),
                                generator=gen).to(dev),
                    _params(256, 4, gen, dev))
    h_out = h_in * s
    syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out), dtype=BF16,
                               device=dev).float()
    if window:
        idx = np.arange(h_out) // s
        iv = K.index_vector(idx, h_in, dev)
        run = lambda: K.decode_window_fwd(z, syn, iv, iv, p)    # noqa: E731
        want = K.decode_window_fwd_ref(z, syn, idx, idx, p)
    else:
        run = lambda: K.decode_int_fwd(z, syn, s, s, p)         # noqa: E731
        want = K.decode_int_fwd_ref(z, syn, s, s, p)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = run()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert sum(e.count for e in prof.key_averages()
               if "decode_fwd_bf16_kernel<" in e.key) == 1, names
    assert not any("decode_fwd_kernel<" in k for k in names), names
    assert torch.isfinite(got).all()
    _close_bf16(got, want, 2e-2)
    assert torch.equal(got, run())


def _bwd_case_bf16(hidden, n_layers, b, lr, out_hw, window, seed):
    z, syn, rows, cols, p, _ = _bwd_case(hidden, n_layers, b, lr, out_hw,
                                         window, seed)
    z, p = _as_bf16(z, p)
    syn = grids.syn_input_grid(lr, out_hw, dtype=BF16, device=z.device)
    if window is not None:
        r0, r1, c0, c1 = window
        syn = syn[r0:r1, c0:c1]
    syn = syn.float().contiguous()
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn((b, rows.size, cols.size, 3), generator=gen).to(z.device)
    keep = relu_margin(z, syn, rows, cols, p) > 1e-3
    return z, syn, rows, cols, p, (g * keep[..., None]).contiguous()


def _assert_bwd_close_bf16(got, want):
    dz, grads = got
    assert dz.dtype == BF16
    pairs = [("dz", dz, want[0])] + [(k, grads[k], want[1][k])
                                    for k in K.PARAM_KEYS]
    for name, a, b in pairs:
        if name != "dz":
            assert a.dtype == torch.float32, name
        _close_bf16(a, b, 1e-2)
    h = grads["w0"].shape[1]
    assert grads["bcat"][:, :h].abs().max().item() == 0.0


@pytest.mark.parametrize("hidden,n_layers", [(32, 4), (64, 3), (256, 4)])
@pytest.mark.parametrize("b,lr,s", [(2, (6, 8), (2, 2)), (1, (5, 7), (3, 3)),
                                    (3, (9, 6), (4, 4)), (1, (4, 3), (9, 8))])
def test_decode_int_bwd_bf16_matches_plain(hidden, n_layers, b, lr, s):
    """x2, x3 and x4 fold dz inside the chain kernel's pixel-ordered tiles
    (96 pixels at x2: 6 tiles of 16; 35 at x3: 5 tiles of 7, each with a
    dead row; 162 at x4: 41 tiles of 4, the last ragged); (9, 8), 72
    queries a pixel, goes through fold_dz_bf16_kernel. Two calls agree bit for
    bit."""
    out_hw = (lr[0] * s[0], lr[1] * s[1])
    z, syn, _, _, p, g = _bwd_case_bf16(hidden, n_layers, b, lr, out_hw,
                                        None, hidden + lr[0])
    before = K.launches["decode_int_bwd_bf16"]
    got = K.decode_int_bwd(z, syn, s[0], s[1], p, g)
    torch.cuda.synchronize()
    assert K.launches["decode_int_bwd_bf16"] == before + 1
    _assert_bwd_close_bf16(got, K.decode_int_bwd_ref(z, syn, s[0], s[1], p,
                                                     g))
    _assert_same(got, K.decode_int_bwd(z, syn, s[0], s[1], p, g))


@pytest.mark.parametrize("hidden", [32, 64, 256])
def test_decode_window_bwd_bf16_matches_plain(hidden):
    z, syn, rows, cols, p, g = _bwd_case_bf16(hidden, 3, 2, (7, 9), (22, 28),
                                              (3, 19, 5, 14), hidden)
    rv = K.index_vector(rows, 7, z.device)
    cv = K.index_vector(cols, 9, z.device)
    before = K.launches["decode_window_bwd_bf16"]
    got = K.decode_window_bwd(z, syn, rv, cv, p, g)
    torch.cuda.synchronize()
    assert K.launches["decode_window_bwd_bf16"] == before + 1
    _assert_bwd_close_bf16(got, K.decode_window_bwd_ref(z, syn, rows, cols,
                                                        p, g))
    _assert_same(got, K.decode_window_bwd(z, syn, rv, cv, p, g))


def test_bf16_flagship_forward_and_backward_launch_bf16_instances():
    """The flagship config in bf16 (``dtype=bfloat16``, fp32 parameters):
    each route launches its bf16 forward and backward instances and no
    fp32 one, and every parameter gets a finite fp32 gradient."""
    dev = _device()
    net = DIINN(generator=torch.Generator().manual_seed(0),
                dtype=BF16).to(dev)
    x = torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(dev)
    for fwd, bwd, out_hw in (("decode_int_fwd", "decode_int_bwd", (32, 32)),
                             ("decode_window_fwd", "decode_window_bwd",
                              (25, 25))):
        before = dict(K.launches)
        net.zero_grad()
        out = net(x, out_hw, 30000)
        assert out.dtype == BF16
        out.float().sum().backward()
        torch.cuda.synchronize()
        after = dict(K.launches)
        assert after[fwd + "_bf16"] == before[fwd + "_bf16"] + 1
        assert after[bwd + "_bf16"] == before[bwd + "_bf16"] + 1
        assert all(after[k] == before[k] for k in K.KERNELS)
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   and torch.isfinite(p.grad).all()
                   for p in net.parameters())


@pytest.mark.parametrize("scale,kind,name", [
    (2.0, "kernel", "decode_int_fwd"),
    (2.5, "traced", "decode_window_fwd")])
def test_bucketed_graph_replays_match_eager_and_count_launches(scale, kind,
                                                               name):
    """Bucketed eval (``train/bucketed.py``) of a tiny DIINN (rdn-tiny,
    hidden 32): two images of different true sizes in one bucket go
    through the bucket's one captured CUDA graph; each replay's metrics
    equal an eager run of the same program function on the same buffers
    bit for bit, and the launch counts hold the warm-up, every replay and
    every eager check (5 row bands a run on the traced route)."""
    from tpu_diinn_torch.train.bucketed import BucketedEval
    from tpu_diinn_torch.train.task import SRTask
    dev = _device()
    net = DIINN(encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                generator=torch.Generator().manual_seed(0)).to(dev)
    ev = BucketedEval(SRTask(net, eval_bsize=997), quantum=32)
    rng = np.random.default_rng(0)
    K.reset_launches()
    eager_runs = 0
    for h, w in ((21, 17), (19, 16)):
        lr = rng.random((1, h, w, 3), dtype=np.float32)
        hr = rng.random((1, round(h * scale), round(w * scale), 3),
                        dtype=np.float32)
        got = ev.metrics(lr, hr, scale)
        (key,) = ev._programs
        assert key[0] == kind
        prog = ev._programs[key]
        per_run = prog.launches[name]
        assert per_run == (1 if kind == "kernel" else 5)
        assert K.launches[name] == (1 + prog.replays + eager_runs) * per_run
        want = ev.eager(key).tolist()
        eager_runs += 1
        assert got == want and all(np.isfinite(got))
    assert ev.n_programs == 1
    # the device's own records (CUPTI) of one more replay: the graph runs
    # the kernels that were booked for it
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev.replay(key)
        torch.cuda.synchronize()
    assert sum(e.count for e in prof.key_averages()
               if "decode_fwd_kernel<" in e.key) == per_run



def test_spans_reach_a_profiler_that_records_the_host_and_not_cuda_alone():
    """One bf16 fused training step (rdn-tiny, hidden 32, scales 2 and 3)
    under the profiler as the benchmark's traced stretch starts it
    (``perfbench/trace.py::Stretch``, CUDA activity alone), and under one
    that records the host too (the trainer's ``trainer.profile_dir``
    window, ``profiling.trace``). With CUDA alone the profiler registers
    no callback for ``record_function``, so no program span is recorded;
    with the host, every span is a host event, the decoder's backward on
    autograd's thread among them, and ``build_trace`` keeps none of their
    echoes as a device operation."""
    from torch.profiler import ProfilerActivity, profile
    from perfbench import spans, trace
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.train import loop
    dev = _device()
    cfg = load_config(None, ["model.encoder=rdn-tiny",
                             "model.hidden_dims=[32,32,32]",
                             "model.dtype=bfloat16"])
    state = loop.init_state(cfg, 1000, device=dev)
    step = loop.make_train_step(state)
    rng = np.random.default_rng(0)
    batch = {s: (rng.random((2, 12, 12, 3), dtype=np.float32),
                 rng.random((2, 12 * s, 12 * s, 3), dtype=np.float32))
             for s in (2, 3)}
    step(loop.to_device(batch, dev))
    stretch = trace.Stretch(True, 0, 1, torch.cuda.synchronize)
    stretch.begin(0)
    step(loop.to_device(batch, dev))
    stretch.end(0)
    names = set(spans.LAYER_OF) | {"train_step 2", "train_step 3"}
    cuda_only = stretch.trace
    assert cuda_only.busy_s > 0 and not spans.program_spans(cuda_only)
    assert not {n for n, _, _ in cuda_only.device} & names
    before = dict(K.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(loop.to_device(batch, dev))
        torch.cuda.synchronize()
    assert K.launches["decode_int_bwd_bf16"] == (
        before["decode_int_bwd_bf16"] + 2)
    t = trace.build_trace(prof, 1, 0.0)
    assert {"train_step 3", "step.forward", "step.backward", "step.update",
            "to_device", "encoder", "lr_conv", "decoder", "decoder.prepare",
            "decoder.backward", "decoder.backward.prepare"} <= {
                n for n, _, _ in spans.program_spans(t)}
    assert not {n for n, _, _ in t.device} & names
    assert spans.idle_by_layer(t) is not None


# The fp32 inference encoder's implicit-GEMM conv (kernels/encoder_conv)
# against cuDNN's fp32 conv with TF32 off, at every (Cin, Cout, k) of
# RDN-B, EDSR-baseline and the stacked LR conv. Tolerance: 4e-6 of the
# reference's largest magnitude. Three TF32 products a multiply-add
# (a_lo b_hi + a_hi b_lo + a_hi b_hi) leave about 2^-21 of relative error
# each, and a sum runs over K <= 4,608 terms (RDN-B's conv7: 512 channels
# x 9 taps); cuDNN's fp32 sums in another order.
ENC_TOL = 4e-6
ENC_SHAPES = ([(3, 64, 3)] + [(64 * c, 64, 3) for c in range(1, 9)]
              + [(576, 64, 1), (1024, 64, 1), (64, 1024, 3)])


@pytest.mark.parametrize("hw", [(192, 256), (47, 53)])
@pytest.mark.parametrize("cin,cout,k", ENC_SHAPES)
def test_encoder_conv_matches_cudnn_fp32(cin, cout, k, hw, monkeypatch):
    """Batch 1 into a dense output; batch 2 with ReLU and a residual, the
    input a channel prefix of a wider slab and the output a channel slice
    of another, whose other channels stay untouched; and for a 1x1 conv,
    batch 2 in place, as a residual dense block's local fusion runs it:
    the output and the residual are the input slab's first Cout channels,
    and a second output gets the same values."""
    dev = _device()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator().manual_seed(cin * 7 + cout + k + hw[0])
    for batch, relu, res, wide in ((1, False, False, False),
                                   (2, True, True, True)):
        xs = torch.rand((batch, *hw, cin + 8 * wide), generator=gen).to(dev)
        x = xs[..., :cin]
        wt = ((torch.rand((cout, cin, k, k), generator=gen) * 2 - 1)
              / np.sqrt(cin * k * k)).to(dev)
        b = (torch.rand((cout,), generator=gen) * 2 - 1).to(dev)
        r = (torch.randn((batch, *hw, cout), generator=gen).to(dev)
             if res else None)
        slab = torch.full((batch, *hw, cout + 16 * wide), float("nan"),
                          device=dev)
        out = slab[..., 8:8 + cout] if wide else slab
        before = EC.launches
        EC.conv(x, wt, b, out, relu=relu, residual=r,
                slabs=EC.weight_slabs(wt))
        torch.cuda.synchronize()
        assert EC.launches == before + 1
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), wt, b,
            padding=(k - 1) // 2).permute(0, 2, 3, 1)
        if relu:
            want = torch.relu(want)
        if res:
            want = want + r
        err = (out - want).abs().max().item()
        assert err <= ENC_TOL * want.abs().max().item(), (batch, err)
        if wide:
            assert torch.isnan(slab[..., :8]).all()
            assert torch.isnan(slab[..., 8 + cout:]).all()
    if k == 1:
        xs = torch.rand((2, *hw, cin), generator=gen).to(dev)
        want = torch.nn.functional.conv2d(
            xs.permute(0, 3, 1, 2), wt, b).permute(0, 2, 3, 1)
        want = want + xs[..., :cout]
        rest = xs[..., cout:].clone()
        out2 = torch.full((2, *hw, cout + 16), float("nan"), device=dev)
        EC.conv(xs, wt, b, xs[..., :cout], residual=xs[..., :cout],
                out2=out2[..., 8:8 + cout], slabs=EC.weight_slabs(wt))
        torch.cuda.synchronize()
        for got in (xs[..., :cout], out2[..., 8:8 + cout]):
            err = (got - want).abs().max().item()
            assert err <= ENC_TOL * want.abs().max().item(), ("in place",
                                                              err)
        assert torch.equal(xs[..., cout:], rest)
        assert torch.isnan(out2[..., :8]).all()
        assert torch.isnan(out2[..., 8 + cout:]).all()


def test_encoder_conv_refuses_what_the_kernel_does_not_take():
    dev = _device()
    x = torch.rand((1, 8, 8, 64), device=dev)
    w = torch.rand((64, 64, 3, 3), device=dev)
    b = torch.rand((64,), device=dev)
    ws = EC.weight_slabs(w)
    slab = torch.empty((1, 8, 8, 128), device=dev)
    with pytest.raises(ValueError, match="kernel size"):
        EC.conv(x, torch.rand((64, 64, 5, 5), device=dev), b,
                slab[..., 64:], slabs=ws)
    with pytest.raises(ValueError, match="float32"):
        EC.conv(x.double(), w.double(), b, slab[..., 64:], slabs=ws)
    with pytest.raises(ValueError, match="overlap"):
        EC.conv(slab[..., :64], w, b, slab[..., 32:96], slabs=ws)
    with pytest.raises(ValueError, match="out must be"):
        EC.conv(x, w, b, slab[..., :32], slabs=ws)
    with pytest.raises(ValueError, match="slabs must be"):
        EC.conv(x, w, b, slab[..., 64:], slabs=None)


@pytest.mark.parametrize("encoder,launches", [("rdn", 149),
                                              ("edsr-baseline", 35)])
def test_fp32_predict_on_the_slab_path_matches_cudnn(encoder, launches,
                                                     monkeypatch):
    """A DIINN fp32 request at 192x256 x3.14 (``SRTask.predict`` under
    inference mode) runs every encoder conv and the stacked LR conv as the
    implicit-GEMM kernel, 149 launches over RDN-B (148 convs and the LR
    conv), 35 over EDSR-baseline; its output and the encoder's features
    agree with the cuDNN path's (the slab path turned off) within 1e-6
    absolute and ENC_TOL of the features' largest magnitude."""
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.train import loop
    from tpu_diinn_torch.train.task import normalize
    dev = _device()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    task = loop.build_task(load_config(None, [f"model.encoder={encoder}"]),
                           device=dev)
    x = torch.rand((1, 192, 256, 3),
                   generator=torch.Generator().manual_seed(3)).to(dev)
    size = (round(192 * 3.14), round(256 * 3.14))
    with torch.inference_mode():
        before = EC.launches
        got = task.predict(x, size)
        torch.cuda.synchronize()
        assert EC.launches == before + launches
        feat = task.net.encoder(normalize(x))
        monkeypatch.setattr(EC, "engaged", lambda *a, **k: False)
        want = task.predict(x, size)
        want_feat = task.net.encoder(normalize(x))
        torch.cuda.synchronize()
    assert EC.launches == before + launches + launches - 1
    assert (got - want).abs().max().item() <= 1e-6
    gap = (feat - want_feat).abs().max().item()
    assert gap <= ENC_TOL * want_feat.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_step_launches_no_encoder_conv(dtype):
    """A fused training step (autograd on) keeps the cuDNN path in either
    compute dtype: ``encoder_conv.launches`` does not move."""
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.train import loop
    dev = _device()
    cfg = load_config(None, ["model.encoder=rdn-tiny",
                             "model.hidden_dims=[32,32,32]",
                             f"model.dtype={dtype}"])
    state = loop.init_state(cfg, 1000, device=dev)
    step = loop.make_train_step(state)
    rng = np.random.default_rng(0)
    batch = {s: (rng.random((2, 12, 12, 3), dtype=np.float32),
                 rng.random((2, 12 * s, 12 * s, 3), dtype=np.float32))
             for s in (2, 3)}
    before = EC.launches
    step(loop.to_device(batch, dev))
    torch.cuda.synchronize()
    assert EC.launches == before


def test_liif_imnet_feat_on_the_conv_kernel_matches_plain(monkeypatch):
    """LIIF's feature conv (``imnet_feat``, 64 -> 256, 3x3, no bias) at
    192x256 in fp32 inference is one launch of the implicit-GEMM kernel,
    its zero bias kept on the module, within ENC_TOL of the plain version
    (``encoder_conv.conv_ref``) and of the module's own cuDNN conv."""
    from tpu_diinn_torch.nn.liif import LIIF
    dev = _device()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net = LIIF(generator=torch.Generator().manual_seed(5)).to(dev)
    feat = torch.randn((1, 192, 256, 64),
                       generator=torch.Generator().manual_seed(6)).to(dev)
    w = net.imnet_feat.conv.weight.detach()
    with torch.inference_mode():
        before = EC.launches
        got = net.feat_conv(feat)
        torch.cuda.synchronize()
        assert EC.launches == before + 1
        want = torch.empty_like(got)
        EC.conv_ref(feat, w, torch.zeros(256, device=dev), want)
        cudnn = net.imnet_feat(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (1, 192, 256, 256)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= ENC_TOL * scale
    assert (got - cudnn).abs().max().item() <= ENC_TOL * scale


def test_liif_fp32_predict_launches_the_conv_for_imnet_feat(monkeypatch):
    """A LIIF-RDN fp32 request at 192x256 x3.14 runs RDN-B's 148 convs and
    ``imnet_feat`` on the kernel, 149 launches; its output agrees with the
    cuDNN path's (the slab path off) within 1e-6 absolute; the decode
    counters read the request's chunks and 4 x its queries."""
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.nn import liif
    from tpu_diinn_torch.train import loop
    dev = _device()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    task = loop.build_task(load_config(None, ["model.arch=liif"]),
                           device=dev)
    x = torch.rand((1, 192, 256, 3),
                   generator=torch.Generator().manual_seed(3)).to(dev)
    size = (round(192 * 3.14), round(256 * 3.14))
    with torch.inference_mode():
        before = EC.launches
        liif.reset_counters()
        got = task.predict(x, size)
        torch.cuda.synchronize()
        assert EC.launches == before + 149
        chunk = task.eval_bsize // size[0]
        assert liif.chunks == -(-size[1] // chunk)
        assert liif.corner_queries == 4 * size[0] * size[1]
        monkeypatch.setattr(EC, "engaged", lambda *a, **k: False)
        want = task.predict(x, size)
        torch.cuda.synchronize()
    assert EC.launches == before + 149
    assert (got - want).abs().max().item() <= 1e-6


# LIIF's query-MLP kernel (kernels/liif_decoder): the benchmark cell's
# limit on the largest absolute gap against the plain reference
LIIF_TOL = 1e-6


def _liif_setup(monkeypatch, seed=5):
    import json
    from pathlib import Path

    from tpu_diinn_torch.nn.liif import LIIF
    dev = _device()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net = LIIF(generator=torch.Generator().manual_seed(seed)).to(dev)
    config = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                         / "configs" / "liif-rdn.json").read_text())
    return dev, net, config


def _torch_path(monkeypatch, fn):
    """fn() with the kernel's dispatch off (the torch path)."""
    from tpu_diinn_torch.kernels import liif_decoder as ld
    with monkeypatch.context() as m:
        m.setattr(ld, "engaged", lambda *a, **k: False)
        return fn()


@pytest.mark.parametrize("b,scale,bsize", [
    (1, 2, 30000),       # x2: one chunk of the whole width
    (2, 3.14, 4000),     # x3.14, batch 2: chunks of 26 columns, 8 chunks
    (1, 4, 7000),        # x4: chunks of 36 columns, the last of 4
    (1, 8, 30000),       # x8: chunks of 78 columns, the last of 44
])
def test_liif_fused_decode_matches_the_torch_path_and_the_reference(
        monkeypatch, b, scale, bsize):
    """``LIIF.decode`` of a seeded 48x64 feature map (64 channels, the
    published widths) on the kernel, one launch a chunk (``fused_chunks ==
    chunks``, and the wrapper's ``launches``), within LIIF_TOL of the torch
    path and of
    ``perfbench/reference/liif.py``'s decode (one 580-wide layer 0 a query
    and corner, plain float32)."""
    from perfbench.reference import liif as R
    from perfbench.reference.precision import Rounding
    from tpu_diinn_torch.kernels import liif_decoder as ld
    from tpu_diinn_torch.nn import liif
    dev, net, config = _liif_setup(monkeypatch)
    lr = (48, 64)
    size = (round(lr[0] * scale), round(lr[1] * scale))
    feat = torch.randn((b, *lr, 64), generator=torch.Generator()
                       .manual_seed(6)).to(dev)
    with torch.inference_mode():
        liif.reset_counters()
        ld.reset_launches()
        got = net.decode(feat, size, bsize)
        torch.cuda.synchronize()
        chunk = max(1, bsize // size[0])
        assert liif.chunks == liif.fused_chunks == ld.launches == -(
            -size[1] // chunk)
        assert liif.corner_queries == 4 * b * size[0] * size[1]
        plain = _torch_path(monkeypatch, lambda: net.decode(feat, size,
                                                            bsize))
        params = {k: v.detach() for k, v in net.state_dict().items()}
        want = R.decode(params, config, feat.permute(0, 3, 1, 2), size,
                        Rounding("fp32"), block=1 << 17)
    assert got.shape == (b, *size, 3) and got.is_contiguous()
    assert (got - plain).abs().max().item() <= LIIF_TOL
    assert (got - want).abs().max().item() <= LIIF_TOL


def test_liif_fused_stripes_and_bucketed_decode_match_the_torch_path(
        monkeypatch):
    """``decode_stripe`` with a clamped last stripe (columns past the width
    repeat the last) and ``decode_traced`` on the bucketed eval's padded
    int32 vectors (a 151x201 decode on a 192x256 canvas, row bands of 117
    rows) on the kernel, within LIIF_TOL of the torch path, one launch a
    stripe and a band."""
    import numpy as np

    from tpu_diinn_torch.kernels import liif_decoder as ld
    from tpu_diinn_torch.nn import liif
    from tpu_diinn_torch.nn.liif import _CORNERS, _corner_axis_indices
    dev, net, _ = _liif_setup(monkeypatch)
    lr, size = (48, 64), (151, 201)
    feat = torch.randn((1, *lr, 64), generator=torch.Generator()
                       .manual_seed(7)).to(dev)
    with torch.inference_mode():
        liif.reset_counters()
        ld.reset_launches()
        got = net.decode_stripe(feat, size, 190, 16)
        assert liif.fused_chunks == liif.chunks == ld.launches == 1
        want = _torch_path(monkeypatch,
                           lambda: net.decode_stripe(feat, size, 190, 16))
        assert got.shape == (1, 151, 16, 3)
        assert (got - want).abs().max().item() <= LIIF_TOL
        assert torch.equal(got[:, :, 11:], got[:, :, 10:11].expand(
            -1, -1, 5, -1))

        pad = (192, 256)

        def padded(a, n):
            out = np.zeros(n, a.dtype)
            out[:len(a)] = a
            return torch.from_numpy(out).to(dev)
        per_corner = []
        for vy, vx in _CORNERS:
            iy, ry = _corner_axis_indices(lr[0], size[0], vy)
            ix, rx = _corner_axis_indices(lr[1], size[1], vx)
            per_corner.append((padded(iy, pad[0]), padded(ry, pad[0]),
                               padded(ix, pad[1]), padded(rx, pad[1])))
        cell = torch.tensor([2.0 * lr[0] / size[0], 2.0 * lr[1] / size[1]],
                            device=dev)
        liif.reset_counters()
        ld.reset_launches()
        got = net.decode_traced(feat, per_corner, cell, pad, 30000)
        assert liif.fused_chunks == liif.chunks == ld.launches == 2
        want = _torch_path(monkeypatch, lambda: net.decode_traced(
            feat, per_corner, cell, pad, 30000))
    assert got.shape == (1, *pad, 3)
    assert (got - want).abs().max().item() <= LIIF_TOL


def test_liif_decode_chunk_counts_only_what_it_launches(monkeypatch):
    """``decode_chunk`` of an empty chunk (no columns) returns its empty
    output and launches nothing; a chunk of one column launches once."""
    from tpu_diinn_torch.kernels import liif_decoder as ld
    dev, net, _ = _liif_setup(monkeypatch)
    z = torch.zeros((1, 4, 5, 256), device=dev)
    small, slabs = ld.operands(net)
    with torch.inference_mode():
        for w in (0, 1):
            vecs = [(torch.zeros(3, dtype=torch.int64, device=dev),
                     torch.zeros(3, device=dev),
                     torch.zeros(w, dtype=torch.int64, device=dev),
                     torch.zeros(w, device=dev))] * 4
            ld.reset_launches()
            out = ld.decode_chunk(z, vecs, torch.ones(2, device=dev), small,
                                  slabs)
            torch.cuda.synchronize()
            assert out.shape == (1, 3, w, 3)
            assert ld.launches == w
