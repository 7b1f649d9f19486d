"""Port parity: the DIINN model against the JAX DIINN on the same params.

The JAX params come from flax ``init`` (tiny configs) or the flagship
export, and reach the port through ``state_dict_from_jax``. The port runs
under ``torch.no_grad()``, so mode 3 takes the fused route (the kernels'
plain versions on the CPU) unless ``use_fused=False`` forces the eager
``hr_step``; the JAX side runs its XLA path, or with ``use_fused=True`` its
Pallas kernels in interpret mode. Tolerance: atol 1e-5 (fp32, different
summation order). The flagship weights are held in
test_torch_diinn_flagship.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.nn.diinn import DIINN as JDIINN
from tpu_diinn_torch.nn.diinn import DIINN
from tpu_diinn_torch.train.checkpoint import state_dict_from_jax


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _tiny_pair(mode, jax_fused, port_fused, seed=0):
    jnet = JDIINN(mode=mode, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                  use_fused=jax_fused)
    x0 = jnp.zeros((1, 6, 7, 3), jnp.float32)
    params = jnet.init(jax.random.PRNGKey(seed), x0, (12, 14))
    tnet = DIINN(mode=mode, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                 use_fused=port_fused)
    tnet.load_state_dict(state_dict_from_jax(_flatten(params)), strict=True)
    return jnet, params, tnet.eval()


CASES = [
    # (mode, lr (h, w), out (h, w), bsize, jax use_fused, port use_fused)
    (3, (6, 7), (12, 14), None, None, None),      # x2, whole grid
    (3, (6, 7), (12, 14), None, None, False),     # x2, eager hr_step
    (3, (5, 6), (20, 24), 60, None, None),        # x4 int-eval route
    (3, (5, 6), (20, 24), 60, True, None),        #   vs the Pallas kernel
    (3, (7, 9), (22, 28), 60, None, None),        # x3.14 chunked windows
    (3, (7, 9), (22, 28), 60, True, None),        #   vs the Pallas kernel
    (3, (7, 9), (22, 28), 60, None, False),       #   eager chunks
    (4, (7, 9), (22, 28), 60, None, None),        # mode 4, chunk-local conv
    (4, (5, 6), (20, 24), 100, None, None),       # mode 4 x4: chunks too
    (2, (6, 7), (12, 14), None, None, None),      # mode 2 (eager)
    (1, (7, 9), (22, 28), 60, None, None),        # mode 1 (eager)
]


@pytest.mark.parametrize("mode,lr_hw,out_hw,bsize,jax_fused,port_fused",
                         CASES)
def test_tiny_diinn_matches_jax(mode, lr_hw, out_hw, bsize, jax_fused,
                                port_fused):
    jnet, params, tnet = _tiny_pair(mode, jax_fused, port_fused)
    rng = np.random.default_rng(sum(lr_hw) + mode)
    x = rng.uniform(-1, 1, (2, *lr_hw, 3)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), out_hw, bsize))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), out_hw, bsize).numpy()
    assert got.shape == want.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_exact_sin_decoder_matches_jax():
    """exact_sin=True (stock sine) falls outside the fused gate: both sides
    run their eager chains."""
    jnet = JDIINN(mode=3, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                  exact_sin=True)
    x = np.random.default_rng(9).uniform(-1, 1, (1, 7, 9, 3)).astype(
        np.float32)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x), (22, 28))
    tnet = DIINN(mode=3, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                 exact_sin=True)
    tnet.load_state_dict(state_dict_from_jax(_flatten(params)), strict=True)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), (22, 28)))
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(x), (22, 28)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(20, 24), (22, 28)])
def test_grad_recording_keeps_the_fused_route(out_hw):
    """Autograd does not change the route: with gradients recorded, the
    fused decoder still runs (its plain versions on the CPU), gives the
    no-grad output, and its backward (several window nodes at bsize 60 for
    x3.14; one integer-ratio node for x4) gives the gradients that
    ``use_fused=False`` takes through ``hr_step``, within atol 1e-5 (fp32,
    another summation order)."""
    gen = torch.Generator().manual_seed(0)
    tnet = DIINN(mode=3, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                 generator=gen).eval()
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (1, 5, 6, 3)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, *out_hw, 3)).astype(np.float32))
    with torch.no_grad():
        want = tnet(x, out_hw, 60)
    got = tnet(x, out_hw, 60)
    assert got.requires_grad
    assert torch.equal(got.detach(), want)
    (got * g).sum().backward()
    fused = {k: p.grad.clone() for k, p in tnet.named_parameters()}
    tnet.zero_grad()
    tnet.decoder.use_fused = False
    (tnet(x, out_hw, 60) * g).sum().backward()
    for k, p in tnet.named_parameters():
        np.testing.assert_allclose(fused[k].numpy(), p.grad.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
