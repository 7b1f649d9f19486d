"""Port parity for the model families against the reference and the
committed weights, and their training steps against JAX.

- The PyTorch reference's golden fixtures (``tests/golden``: weights
  regenerated by ``parity_utils.fill_values``, inputs, outputs and input
  gradients) through the port's own ``compat/torch_loader.py`` and
  ``state_dict_from_jax``, at the tolerances of
  ``tests/test_model_parity.py``: modules rtol 2e-4, atol 3e-5 of the
  largest magnitude; full models rtol 5e-4, atol 1e-4 (LIIF's input
  gradient through RDN-B atol 2e-3: the fixture's own fp32 reference is
  that far from the float64 truth). ``diinn_dec_m{1..4}_q1`` go through
  ``ImplicitDecoder(init_q=True)``, ``diinn_full_m3`` through the
  flagship DIINN.
- ``results/{liif,metasr}_weights.npz`` load ``strict=True`` and equal
  the JAX loader's values.
- Two ``make_train_step`` steps of a tiny LIIF and MetaSR (RDN-tiny) from
  the same params on the same batches as the JAX trainer: loss atol 1e-5,
  grad norm rtol 1e-4, params atol 1e-5 (as ``tests/test_torch_train.py``
  for DIINN); and ``cli.train model.arch=...`` on the CPU, whose
  checkpoint the JAX package loads and runs to the port's output (atol
  1e-5).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.train import loop as jloop
from tpu_diinn.train.checkpoint import load_params_npz as jax_load
from tpu_diinn_torch.cli import train as tcli
from tpu_diinn_torch.compat import torch_loader as tl
from tpu_diinn_torch.nn.diinn import ImplicitDecoder
from tpu_diinn_torch.nn.edsr import EDSRBaseline
from tpu_diinn_torch.nn.liif import LIIF
from tpu_diinn_torch.nn.metasr import MetaSR
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.train.checkpoint import (load_params_npz,
                                              state_dict_from_jax)
from tests.test_model_parity import load_fixture, nchw_to_nhwc
from tests.test_torch_train import (TINY, _flatten, _tiny_batches,
                                    jax_train_oracle, port_train)


def check_golden(net_fn, d, rtol=2e-4, atol=3e-5, grad_atol=None):
    """``net_fn`` (NHWC in and out) against the fixture's output and input
    gradient."""
    x = torch.from_numpy(nchw_to_nhwc(d["x"]).copy()).requires_grad_(True)
    g = torch.from_numpy(nchw_to_nhwc(d["g"]).copy())
    want_y = nchw_to_nhwc(d["y"])
    want_xg = nchw_to_nhwc(d["x_grad"])
    y = net_fn(x)
    (y * g).sum().backward()
    scale_y = max(1e-3, float(np.abs(want_y).max()))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=rtol,
                               atol=atol * scale_y)
    scale_g = max(1e-3, float(np.abs(want_xg).max()))
    np.testing.assert_allclose(x.grad.numpy(), want_xg, rtol=rtol,
                               atol=(grad_atol or atol) * scale_g)


def _load(net, tree):
    net.load_state_dict(state_dict_from_jax(tl.flatten(tree)), strict=True)
    return net


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_init_q_decoder_golden(mode):
    sd, d = load_fixture(f"diinn_dec_m{mode}_q1")
    dec = _load(ImplicitDecoder(in_channels=16, hidden_dims=(32, 32, 32),
                                mode=mode, init_q=True),
                {"params": tl.convert_diinn_decoder(
                    sd, "", in_channels=16, n_layers=3, hidden=32,
                    mode=mode, init_q=True)})
    size = tuple(int(v) for v in d["size"])
    check_golden(lambda x: dec(x, size), d)


@pytest.mark.parametrize("tag,tol", [
    ("liif_full", dict(rtol=5e-4, atol=1e-4, grad_atol=2e-3)),
    ("liif_decode", {}),
    ("metasr_full", dict(rtol=5e-4, atol=1e-4)),
    ("metasr_decode", {})])
def test_family_golden(tag, tol):
    sd, d = load_fixture(tag)
    size = tuple(int(v) for v in d["size"])
    if tag.startswith("liif"):
        net = _load(LIIF(), tl.convert_liif(sd))
    else:
        net = _load(MetaSR(), tl.convert_metasr(sd))
    fn = net if tag.endswith("full") else net.decode
    check_golden(lambda x: fn(x, size), d, **tol)


def test_diinn_full_golden():
    """The flagship DIINN (RDN-B, mode 3) at a non-integer scale through
    ``convert_diinn``: the fused route's plain versions, with autograd."""
    sd, d = load_fixture("diinn_full_m3")
    net = _load(make_net("diinn"), tl.convert_diinn(sd, mode=3))
    size = tuple(int(v) for v in d["size"])
    check_golden(lambda x: net(x, size), d, rtol=5e-4, atol=1e-4)


def test_edsr_baseline_golden():
    sd, d = load_fixture("edsr_baseline")
    net = _load(EDSRBaseline(n_resblocks=4, n_feats=24),
                tl.convert_edsr_baseline(sd, n_resblocks=4))
    check_golden(net, d)


@pytest.mark.parametrize("family", ["liif", "metasr"])
def test_committed_weights_load_strictly(family):
    path = f"results/{family}_weights.npz"
    flat, meta = load_params_npz(path)
    jtree, jmeta = jax_load(path)
    assert meta == jmeta and meta["config"]["model"]["arch"] == family
    jflat = _flatten(jtree["params"])
    assert set(flat) == set(jflat)
    m = meta["config"]["model"]
    net = make_net(m["arch"], encoder_spec=m["encoder"],
                   hidden_dims=m["hidden_dims"])
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    params = net.state_dict()
    for key, want in jflat.items():
        *mods, leaf = key.split("/")[1:]
        name = ".".join(mods + ["weight" if leaf == "kernel" else "bias"])
        want = np.asarray(want, dtype=np.float32)
        if leaf == "kernel" and want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            want = want.T
        np.testing.assert_array_equal(params[name].numpy(), want,
                                      err_msg=name)


@pytest.mark.parametrize("arch", ["liif", "metasr"])
@pytest.mark.parametrize("scales", [[2, 3], [2, 2.5]])
def test_family_train_steps_match_jax(arch, scales):
    ov = TINY + [f"data.train_scales={json.dumps(scales)}",
                 f"model.arch={arch}"]
    batches = _tiny_batches(tuple(scales))
    start, want, want_params = jax_train_oracle(ov, batches, 2)
    got, got_params = port_train(ov, batches, 2, start)
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]
    assert set(got_params) == set(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(got_params[k], w, rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["liif", "metasr"])
def test_family_cli_train_checkpoint_runs_in_jax(arch, tmp_path):
    ov = TINY + [f"model.arch={arch}", "data.num_workers=2",
                 f"trainer.ckpt_dir={tmp_path}", f"trainer.log_dir={tmp_path}"]
    state = tcli.main(["--device", "cpu", "--max-steps", "2"] + ov)
    assert state.step == 2
    jstate, meta = jax_load(str(tmp_path / "last.npz"))
    assert meta["config"]["model"]["arch"] == arch and meta["step"] == 2
    x = np.random.default_rng(1).uniform(0, 1, (1, 6, 7, 3)).astype(
        np.float32)
    out = jloop.build_task(jload_config(None, ov)).net.apply(
        jstate["params"], jnp.asarray(x), (15, 17))
    with torch.no_grad():
        ref = state.task.net(torch.from_numpy(x), (15, 17))
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), rtol=0,
                               atol=1e-5)
