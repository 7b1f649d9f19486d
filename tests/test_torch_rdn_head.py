"""RDN's PixelShuffle head and ``RDNSmall`` in the port against the JAX
package's ``tpu_diinn/nn/rdn.py``, on the same numpy weights
(``seeded_params``, numpy seed per case) and the same seeded input.

Tolerance: the largest gap of the output, and of the input's gradient of
sum(out * g), at most 1e-5 of the JAX value's largest magnitude, fp32 on
both sides (oneDNN and XLA sum the convolutions in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.nn.rdn import RDN as JRDN
from tpu_diinn.nn.rdn import RDNSmall as JRDNSmall
from tpu_diinn_torch.nn.rdn import RDN, RDNSmall
from tpu_diinn_torch.train.checkpoint import (seeded_params,
                                              state_dict_from_jax)

TOL = 1e-5


def _tree(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(
        np.float32)


def _gap(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("r", [None, 2, 3, 4])
def test_rdn_head_matches_jax(r):
    tnet = RDN(growth0=16, config="tiny", upsampling=r)
    flat = seeded_params(tnet, seed=10 + (r or 0))
    tnet.load_state_dict(state_dict_from_jax(flat), strict=True)
    jnet = JRDN(growth0=16, config="tiny", upsampling=r)
    params = _tree(flat)
    x = _rand((2, 6, 7, 3), 1)
    s = r or 1
    out_c = 3 if r else 16
    g = _rand((2, 6 * s, 7 * s, out_c), 2) - 0.5
    assert tnet.out_dim == jnet.out_dim == out_c
    # the JAX init makes the same parameter tree (names and shapes)
    jshapes = jax.tree_util.tree_map(
        jnp.shape, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    assert jshapes == jax.tree_util.tree_map(jnp.shape, params)

    want = jnet.apply(params, jnp.asarray(x))
    want_g = jax.grad(lambda xx: (jnet.apply(params, xx)
                                  * jnp.asarray(g)).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tnet(xt)
    (got * torch.from_numpy(g)).sum().backward()
    assert tuple(got.shape) == tuple(want.shape) == (2, 6 * s, 7 * s, out_c)
    assert _gap(got.detach().numpy(), want) <= TOL
    assert _gap(xt.grad.numpy(), want_g) <= TOL


def test_rdn_head_scale_outside_2_3_4_raises():
    with pytest.raises(ValueError, match="2, 3 or 4"):
        RDN(growth0=16, config="tiny", upsampling=5)
    with pytest.raises(ValueError, match="2, 3 or 4"):
        JRDN(growth0=16, config="tiny", upsampling=5).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)))


@pytest.mark.parametrize("r", [None, 4])
def test_rdn_small_is_rdn_16_tiny(r):
    small, full = RDNSmall(upsampling=r), RDN(16, "tiny", upsampling=r)
    assert ({k: v.shape for k, v in small.state_dict().items()}
            == {k: v.shape for k, v in full.state_dict().items()})
    flat = seeded_params(full, seed=3)
    for net in (small, full):
        net.load_state_dict(state_dict_from_jax(flat), strict=True)
    x = torch.from_numpy(_rand((1, 5, 6, 3), 4))
    assert torch.equal(small(x), full(x))
    jx = jnp.asarray(x.numpy())
    jparams = _tree(flat)
    np.testing.assert_array_equal(
        np.asarray(JRDNSmall(upsampling=r).apply(jparams, jx)),
        np.asarray(JRDN(16, "tiny", upsampling=r).apply(jparams, jx)))
