"""Port parity: the fused decoder's backward plain versions.

``decode_int_bwd_ref`` and ``decode_window_bwd_ref`` (explicit PyTorch
transcriptions of the Pallas ``_chain_bwd``, ``index_add_`` as the adjoint
of the gather) against

- JAX ``jax.grad`` through ``decode_fused(..., interpret=True)``, the
  Pallas backward kernels in interpret mode, with z built as
  tests/test_pallas_decoder.py builds it (rtol/atol 2e-4, as there);
- torch autograd through ``_chain_ref`` (the forward plain version):
  rtol/atol 2e-5, which covers the derivative of the polynomial sine
  against the polynomial cosine the backward uses (both within 1.4e-6 of
  the exact functions) and fp32 summation order.

The kq half of dbcat is zero: the kq biases are folded into z and take
their gradient through it, as ``_split_wgrads`` returns them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.core import grids as jgrids
from tpu_diinn.kernels.decoder_fused import decode_fused
from tpu_diinn.kernels.decoder_fused import pack_params as jpack
from tpu_diinn.nn.diinn import ImplicitDecoder as JDecoder
from tpu_diinn_torch.core import grids as tgrids
from tpu_diinn_torch.kernels import decoder_fused as tk

HIDDEN, LAYERS = 32, 3
TOL = 2e-4


def _jax_case(b, h_in, w_in, h_out, w_out, seed=0):
    dec = JDecoder(in_channels=8, hidden_dims=(HIDDEN,) * LAYERS, mode=3,
                   init_q=False)
    key = jax.random.PRNGKey(seed)
    feat = jax.random.normal(key, (b, h_in, w_in, 8))
    params = dec.init(key, feat, (h_out, w_out))
    zs = dec.apply(params, feat, method=JDecoder.lr_features)
    kp = jpack(params["params"], n_layers=LAYERS, dtype=jnp.float32)
    # the kernels' contract: z carries the kq biases of layers 1..L-1
    z = jnp.concatenate(zs, axis=-1) + jnp.concatenate(
        [jnp.zeros((HIDDEN,)), kp["bkq"].reshape(-1)])
    syn = jgrids.syn_input_grid((h_in, w_in), (h_out, w_out))
    g = jax.random.normal(jax.random.PRNGKey(9), (b, h_out, w_out, 3))
    return z, syn, kp, g


def _jax_grads(z, syn, kp, g, size):
    def loss(z_, kp_):
        out = decode_fused(z_, syn, size, kp_, interpret=True)
        return jnp.sum(out * g)
    return jax.grad(loss, argnums=(0, 1))(z, kp)


def _port(z, kp, g):
    p = {"w0": kp["w0"], "b0": kp["b0"],
         "wcat": jnp.concatenate([kp["wkq"], kp["wq"]], axis=2),
         "bcat": jnp.concatenate([kp["bkq"], kp["bq"]], axis=1),
         "wl": kp["wl"], "bl": kp["bl"]}
    t = {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in p.items()}
    return (torch.from_numpy(np.array(z, dtype=np.float32)), t,
            torch.from_numpy(np.array(g, dtype=np.float32)))


def _assert_matches_jax(dz, grads, dz_j, dkp_j):
    h = HIDDEN

    def close(got, want, name):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)

    close(dz, dz_j, "dz")
    close(grads["w0"], dkp_j["w0"], "w0")
    close(grads["b0"], dkp_j["b0"], "b0")
    close(grads["wcat"][:, :, :h], dkp_j["wkq"], "wkq")
    close(grads["wcat"][:, :, h:], dkp_j["wq"], "wq")
    close(grads["bcat"][:, h:], dkp_j["bq"], "bq")
    close(grads["wl"], dkp_j["wl"], "wl")
    close(grads["bl"], dkp_j["bl"], "bl")
    assert float(np.abs(np.asarray(dkp_j["bkq"])).max()) == 0.0
    assert grads["bcat"][:, :h].abs().max().item() == 0.0


@pytest.mark.parametrize("s", [2, 3, 4])
def test_decode_int_bwd_ref_matches_pallas(s):
    b, h_in, w_in = 2, 6, 8
    size = (h_in * s, w_in * s)
    z, syn, kp, g = _jax_case(b, h_in, w_in, *size, seed=s)
    dz_j, dkp_j = _jax_grads(z, syn, kp, g, size)
    tz, tp, tg = _port(z, kp, g)
    tsyn = tgrids.syn_input_grid((h_in, w_in), size)
    dz, grads = tk.decode_int_bwd_ref(tz, tsyn, s, s, tp, tg)
    _assert_matches_jax(dz, grads, dz_j, dkp_j)
    # the CPU branch of the dispatcher is the plain version
    dz2, grads2 = tk.decode_int_bwd(tz, tsyn, s, s, tp, tg)
    assert torch.equal(dz2, dz)
    assert all(torch.equal(grads2[k], grads[k]) for k in tk.PARAM_KEYS)


def test_decode_window_bwd_ref_matches_pallas():
    b, h_in, w_in, h_out, w_out = 1, 5, 7, 22, 26
    z, syn, kp, g = _jax_case(b, h_in, w_in, h_out, w_out, seed=1)
    dz_j, dkp_j = _jax_grads(z, syn, kp, g, (h_out, w_out))
    tz, tp, tg = _port(z, kp, g)
    tsyn = tgrids.syn_input_grid((h_in, w_in), (h_out, w_out))
    rows = tgrids.nearest_exact_indices(h_in, h_out)
    cols = tgrids.nearest_exact_indices(w_in, w_out)
    dz, grads = tk.decode_window_bwd_ref(tz, tsyn, rows, cols, tp, tg)
    _assert_matches_jax(dz, grads, dz_j, dkp_j)
    dz2, _ = tk.decode_window_bwd(tz, tsyn, tk.index_vector(rows, h_in,
                                                            "cpu"),
                                  tk.index_vector(cols, w_in, "cpu"), tp, tg)
    assert torch.equal(dz2, dz)


def _seeded(b, h_in, w_in, seed):
    rng = np.random.default_rng(seed)
    h = HIDDEN
    shapes = {"w0": (3, h), "b0": (h,), "wcat": (LAYERS - 1, h, 2 * h),
              "bcat": (LAYERS - 1, 2 * h), "wl": (h, 3), "bl": (3,)}
    p = {k: torch.from_numpy((rng.uniform(-1, 1, s)
                              / np.sqrt(h if k != "w0" else 3)).astype(
                                  np.float32))
         for k, s in shapes.items()}
    z = torch.from_numpy(rng.standard_normal(
        (b, h_in, w_in, LAYERS * h)).astype(np.float32))
    return z, p, rng


@pytest.mark.parametrize("route", ["int", "window", "window_slice"])
def test_bwd_refs_match_autograd_through_chain_ref(route):
    b, h_in, w_in = 2, 5, 7
    z, p, rng = _seeded(b, h_in, w_in, seed=len(route))
    if route == "int":
        size = (3 * h_in, 3 * w_in)
        rows = np.arange(size[0]) // 3
        cols = np.arange(size[1]) // 3
    else:
        size = (17, 23)
        rows = tgrids.nearest_exact_indices(h_in, size[0])
        cols = tgrids.nearest_exact_indices(w_in, size[1])
    syn = tgrids.syn_input_grid((h_in, w_in), size)
    if route == "window_slice":          # a chunk of columns, as the eval
        rows, cols, syn = rows[2:15], cols[4:13], syn[2:15, 4:13]
    g = torch.from_numpy(rng.standard_normal(
        (b, len(rows), len(cols), 3)).astype(np.float32))
    zg = z.clone().requires_grad_(True)
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = tk.decode_window_fwd_ref(zg, syn, rows, cols, pg)
    (out * g).sum().backward()
    if route == "int":
        dz, grads = tk.decode_int_bwd_ref(z, syn, 3, 3, p, g)
    else:
        dz, grads = tk.decode_window_bwd_ref(z, syn, rows, cols, p, g)
    np.testing.assert_allclose(dz.numpy(), zg.grad.numpy(), rtol=2e-5,
                               atol=2e-5)
    for k in tk.PARAM_KEYS:
        np.testing.assert_allclose(grads[k].numpy(), pg[k].grad.numpy(),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    assert grads["bcat"][:, :HIDDEN].abs().max().item() == 0.0
    if route == "window_slice":          # LR pixels no query reads
        untouched = np.ones((h_in, w_in), bool)
        untouched[np.ix_(np.unique(rows), np.unique(cols))] = False
        assert np.abs(dz.numpy()[:, untouched]).max() == 0.0


def test_decode_node_returns_the_plain_backward():
    """``decode`` as an autograd node on the CPU: its gradients are the
    backward plain version's, and the packed weights' gradients reach the
    tensors they were packed from."""
    z, p, rng = _seeded(1, 4, 6, seed=3)
    syn = tgrids.syn_input_grid((4, 6), (8, 12))
    g = torch.from_numpy(rng.standard_normal((1, 8, 12, 3)).astype(
        np.float32))
    zg = z.clone().requires_grad_(True)
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    (tk.decode(zg, syn, pg, ratio=(2, 2)) * g).sum().backward()
    dz, grads = tk.decode_int_bwd_ref(z, syn, 2, 2, p, g)
    assert torch.equal(zg.grad, dz)
    assert all(torch.equal(pg[k].grad, grads[k]) for k in tk.PARAM_KEYS)


# -- the backward kernels' 3xTF32 weight split (wrapper side, CPU) ---------

def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor-core product reads of an fp32 operand: its top
    19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def test_tf32_split_is_exact_and_rounds_to_nearest():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((3, 64, 96), generator=g) * torch.logspace(-30, 30, 96)
    w[0, 0, :4] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -11, -(1 + 2 ** -11)])
    hi, lo = tk.tf32_split(w)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi + lo, w)
    # nearest: |lo| at most half a TF32 ulp (2^-11 relative); ties away
    assert bool((lo.abs() <= w.abs() * 2.0 ** -11).all())
    assert hi[0, 0, 2].item() == 1.0 + 2.0 ** -10
    assert hi[0, 0, 3].item() == -(1.0 + 2.0 ** -10)


@pytest.mark.parametrize("h", [32, 64, 256])
def test_chain_b_operands_columns(h):
    """Warpgroup wg owns hidden columns [wg h/2, (wg + 1) h/2): forward
    pass p reads the k and then the a column of each of its jb columns
    from wg h/2 + p jb; dq reads [Wkq | Wq]^T's columns of the same j."""
    wcat = torch.arange(h * 2 * h, dtype=torch.float32).reshape(
        1, h, 2 * h)
    fwd, dq = tk.chain_b_operands(wcat)
    passes = fwd.shape[2]
    jb = h // 2 // passes
    assert fwd.shape == (1, h, passes, 2, 2 * jb)
    assert dq.shape == (1, 2 * h, 1, 2, h // 2)
    for p in range(passes):
        for wg in range(2):
            j = [wg * h // 2 + p * jb + c for c in range(jb)]
            assert torch.equal(fwd[:, :, p, wg], wcat[:, :, j + [h + c
                                                             for c in j]])
            assert torch.equal(dq[:, :, 0, wg],
                               wcat.transpose(1, 2)[:, :, wg * h // 2:
                                                    (wg + 1) * h // 2])


def test_mma_b_slabs_layout():
    """Slab (layer, pass p, k8 step s, warpgroup wg) holds hi then lo;
    element (k = 8s + 4h + c, column 8g + r) at [g, h, r, c]."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn((2, 16, 1, 2, 32), generator=g)
    hi, lo = tk.tf32_split(w)
    x = tk.mma_b_slabs(w)
    assert x.shape == (2, 1, 2, 2, 2, 4, 2, 8, 4) and x.is_contiguous()
    gg, hh, r, c = torch.meshgrid(*(torch.arange(n) for n in (4, 2, 8, 4)),
                                  indexing="ij")
    for s in range(2):
        for wg in range(2):
            k = 8 * s + 4 * hh + c
            n = 8 * gg + r
            for part, want in enumerate((hi, lo)):
                assert torch.equal(x[:, 0, s, wg, part],
                                   want[:, k, 0, wg, n])


def test_3xtf32_product_keeps_fp32_error():
    """a_lo b_hi + a_hi b_lo + a_hi b_hi with operands read as TF32 (the
    kernels' scheme) against the float64 product: fp32-level error, where
    one TF32 product (a_hi b_hi) is about 1e-3 off."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn((64, 256), generator=g)
    w = torch.randn((256, 96), generator=g) / 16
    exact = a.double() @ w.double()
    ah, al = tk.tf32_split(a)
    wh, wl = tk.tf32_split(w)

    def prod(x, y):
        return _tf32_trunc(x).double() @ _tf32_trunc(y).double()

    three = prod(al, wh) + prod(ah, wl) + prod(ah, wh)
    scale = exact.abs().max().item()
    assert (three - exact).abs().max().item() <= 1e-6 * scale
    assert (prod(ah, wh) - exact).abs().max().item() > 1e-4 * scale
