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
implementations may take different sides of the relu mask. The bf16
instances' tolerances are stated beside their tests, at the end.
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
