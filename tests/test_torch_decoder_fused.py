"""Port parity: the fused decoder's plain versions against the Pallas kernels.

The JAX side runs ``decode_fused_int_eval`` / ``decode_fused_window`` in
Pallas interpret mode, as tests/test_pallas_decoder.py does. The port side
runs ``decode_int_fwd_ref`` / ``decode_window_fwd_ref`` and the CPU branch
of their dispatchers. Tolerance: atol 1e-5 in fp32, for the different
summation order of the K <= 96 (syn, head) and K = 32..512 contractions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.core import grids as jgrids
from tpu_diinn.kernels import decoder_fused as jk
from tpu_diinn_torch.core import grids as tgrids
from tpu_diinn_torch.kernels import decoder_fused as tk

HIDDEN, LAYERS = 32, 4
ATOL = 1e-5


def _inputs(b, h_in, w_in, seed, hidden=HIDDEN, n_layers=LAYERS):
    rng = np.random.default_rng(seed)
    h = hidden
    p = {
        "w0": rng.uniform(-1, 1, (3, h)),
        "b0": rng.uniform(-1, 1, (h,)),
        "wkq": rng.uniform(-1, 1, (n_layers - 1, h, h)) / np.sqrt(h),
        "bkq": rng.uniform(-1, 1, (n_layers - 1, h)) / np.sqrt(h),
        "wq": rng.uniform(-1, 1, (n_layers - 1, h, h)) / np.sqrt(h),
        "bq": rng.uniform(-1, 1, (n_layers - 1, h)) / np.sqrt(h),
        "wl": rng.uniform(-1, 1, (h, 3)) / np.sqrt(h),
        "bl": rng.uniform(-1, 1, (3,)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    z = rng.standard_normal((b, h_in, w_in, n_layers * h)).astype(np.float32)
    return z, p


def _port_params(p):
    t = {
        "w0": p["w0"], "b0": p["b0"],
        "wcat": np.concatenate([p["wkq"], p["wq"]], axis=2),
        "bcat": np.concatenate([p["bkq"], p["bq"]], axis=1),
        "wl": p["wl"], "bl": p["bl"],
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t.items()}


@pytest.mark.parametrize("s", [2, 3, 4, 8])
def test_decode_int_ref_matches_pallas_int_eval(s):
    b, h_in, w_in = 2, 5, 7                        # ragged: Pallas pads
    z, p = _inputs(b, h_in, w_in, seed=s)
    out_size = (s * h_in, s * w_in)
    syn = jgrids.syn_input_grid((h_in, w_in), out_size)
    want = np.asarray(jk.decode_fused_int_eval(
        jnp.asarray(z), syn, out_size, {k: jnp.asarray(v)
                                        for k, v in p.items()},
        interpret=True))
    tsyn = tgrids.syn_input_grid((h_in, w_in), out_size)
    tp = _port_params(p)
    got = tk.decode_int_fwd_ref(torch.from_numpy(z), tsyn, s, s, tp)
    assert got.shape == want.shape == (b, *out_size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    before = dict(tk.launches)
    disp = tk.decode_int_fwd(torch.from_numpy(z), tsyn, s, s, tp)
    np.testing.assert_array_equal(disp.numpy(), got.numpy())
    assert tk.launches == before          # the CPU branch launches nothing


@pytest.mark.parametrize("ratio", [3.14, 1.7])
@pytest.mark.parametrize("window", ["full", "slice"])
def test_decode_window_ref_matches_pallas_window(ratio, window):
    b, h_in, w_in = 2, 9, 11
    z, p = _inputs(b, h_in, w_in, seed=int(ratio * 100))
    h_out, w_out = round(h_in * ratio), round(w_in * ratio)
    if window == "full":
        r_lo, r_hi, c_lo, c_hi = 0, h_out, 0, w_out
    else:
        r_lo, r_hi, c_lo, c_hi = 3, h_out - 2, 5, min(w_out, 5 + 9)
    ridx = jgrids.nearest_exact_indices(h_in, h_out)[r_lo:r_hi]
    cidx = jgrids.nearest_exact_indices(w_in, w_out)[c_lo:c_hi]
    r0, r1 = int(ridx[0]), int(ridx[-1]) + 1
    c0, c1 = int(cidx[0]), int(cidx[-1]) + 1
    syn = jgrids.syn_input_grid((h_in, w_in), (h_out, w_out))
    # the JAX window path stages only the window's LR patch, with sliced
    # one-hot gather matrices (nn/diinn.py decode_window)
    srow = jgrids.nearest_exact_onehot(h_in, h_out)[r_lo:r_hi, r0:r1]
    scol = jgrids.nearest_exact_onehot(w_in, w_out)[c_lo:c_hi, c0:c1]
    want = np.asarray(jk.decode_fused_window(
        jnp.asarray(z[:, r0:r1, c0:c1]), syn[r_lo:r_hi, c_lo:c_hi],
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(srow), jnp.asarray(scol), interpret=True))
    # the port reads the whole LR map through the window's index vectors
    tsyn = tgrids.syn_input_grid((h_in, w_in), (h_out, w_out))
    tsyn = tsyn[r_lo:r_hi, c_lo:c_hi].contiguous()
    rows = tgrids.nearest_exact_indices(h_in, h_out)[r_lo:r_hi]
    cols = tgrids.nearest_exact_indices(w_in, w_out)[c_lo:c_hi]
    tp = _port_params(p)
    got = tk.decode_window_fwd_ref(torch.from_numpy(z), tsyn, rows, cols, tp)
    assert got.shape == want.shape == (b, r_hi - r_lo, c_hi - c_lo, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    disp = tk.decode_window_fwd(torch.from_numpy(z), tsyn,
                                tk.index_vector(rows, h_in, "cpu"),
                                tk.index_vector(cols, w_in, "cpu"), tp)
    np.testing.assert_array_equal(disp.numpy(), got.numpy())


def test_window_wrappers_take_index_vectors_only():
    """``index_vector`` checks the host indices once; the window wrappers
    take only its int32 tensors on z's device."""
    z, p = _inputs(1, 4, 4, seed=0)
    tz, tp = torch.from_numpy(z), _port_params(p)
    syn = tgrids.syn_input_grid((4, 4), (8, 8))
    with pytest.raises(ValueError, match="indices out of"):
        tk.index_vector(np.array([0, 4]), 4, "cpu")
    with pytest.raises(ValueError, match="non-decreasing"):
        tk.index_vector(np.array([1, 0]), 4, "cpu")
    rows = tk.index_vector(np.arange(8) // 2, 4, "cpu")
    assert rows.dtype == torch.int32 and rows.tolist() == [0, 0, 1, 1, 2,
                                                           2, 3, 3]
    g = torch.zeros((1, 8, 8, 3))
    for bad in (np.arange(8) // 2, rows.long(), rows[::2]):
        with pytest.raises(ValueError, match="cols must be a 1-D"):
            tk.decode_window_fwd(tz, syn, rows, bad, tp)
        with pytest.raises(ValueError, match="rows must be a 1-D"):
            tk.decode_window_bwd(tz, syn, bad, rows, tp, g)


def test_pack_params_layout():
    from tpu_diinn_torch.nn.diinn import ImplicitDecoder
    dec = ImplicitDecoder(in_channels=8, hidden_dims=(HIDDEN,) * LAYERS,
                          generator=torch.Generator().manual_seed(0))
    kp = tk.pack_params(dict(dec.named_parameters()), LAYERS)
    # the packed weights keep their autograd history (forward_only reads it)
    assert all(v.requires_grad for v in kp.values())
    kp = {k: v.detach() for k, v in kp.items()}
    assert kp["wcat"].shape == (LAYERS - 1, HIDDEN, 2 * HIDDEN)
    for i in range(1, LAYERS):
        np.testing.assert_array_equal(
            kp["wcat"][i - 1, :, :HIDDEN].numpy(),
            getattr(dec, f"kq{i}").dense.weight.detach().numpy().T)
        np.testing.assert_array_equal(
            kp["wcat"][i - 1, :, HIDDEN:].numpy(),
            getattr(dec, f"q{i}").dense.weight.detach().numpy().T)
        np.testing.assert_array_equal(
            kp["bcat"][i - 1, HIDDEN:].numpy(),
            getattr(dec, f"q{i}").dense.bias.detach().numpy())
    assert all(v.is_contiguous() and v.dtype == torch.float32
               for v in kp.values())
