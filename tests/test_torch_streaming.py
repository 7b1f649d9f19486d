"""Port parity for the streaming decode (``train/streaming.py``).

- The port's ``predict_streaming`` against the JAX package's on the same
  seeded weights (``seeded_params``) and inputs, within 1e-5 (as the JAX
  package holds its own streaming decode against its whole-image
  predict): the fused mode 3 (the kernels' plain versions here), the
  eager decoder (``use_fused=false``), mode 4 and ``init_q``, at integer
  and fractional sizes, with bands that do and do not divide H_out. The
  JAX side decodes each band through its XLA route (its streaming decoder
  takes the Pallas kernels only on a TPU).
- One bf16 case, the eager route at ``tests/test_torch_bf16.py``'s
  eager bounds (its ``check``: 6e-2 absolute, and at most 1/5 of JAX's
  own bf16-against-fp32 gap).
- The port's streaming decode equals, bit for bit, its own one-window
  decode (``net(..., bsize=None)``, normalized and clamped): the same
  chain per query, tiled otherwise.
- The stacked LR conv runs once per image, however many bands.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.nn.diinn import DIINN as JDIINN
from tpu_diinn.train.streaming import predict_streaming as jstream
from tpu_diinn_torch.nn.diinn import DIINN, ImplicitDecoder
from tpu_diinn_torch.train.checkpoint import (seeded_params,
                                              state_dict_from_jax)
from tpu_diinn_torch.train.streaming import predict_streaming
from tpu_diinn_torch.train.task import denormalize, normalize
from tests.test_torch_bf16 import DIINN_ATOL, check
from tests.test_torch_families import _unflatten
from tests.test_torch_train import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = (14, 18)
HIDDEN = (32, 32)


def _nets(mode=3, init_q=False, use_fused=None, dtype=None):
    """The port's tiny DIINN on seeded weights, the JAX twin, its params."""
    net = DIINN(mode=mode, init_q=init_q, encoder_spec="rdn-tiny",
                hidden_dims=HIDDEN, use_fused=use_fused,
                dtype=torch.float32 if dtype is None else torch.bfloat16)
    flat = seeded_params(net, 7)
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    jnet = JDIINN(mode=mode, init_q=init_q, encoder_spec="rdn-tiny",
                  hidden_dims=HIDDEN, dtype=dtype)
    return net, jnet, _unflatten(flat)


def _lr(b=1):
    return np.random.default_rng(3).uniform(
        0, 1, (b, *LR, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_stream(mode, init_q, dtype, size, band):
    """The JAX package's streaming decode of ``_lr(2)``, computed once per
    case: its decoder runs op by op, and each new shape compiles (the
    JAX twin has no ``use_fused``, so the fused and eager cases share it)."""
    _, jnet, params = _nets(mode, init_q, dtype=dtype)
    return jstream(jnet, params, _lr(2), size, band_rows=band)


@pytest.mark.parametrize("mode,init_q,use_fused,size,band", [
    (3, False, None, (28, 36), 14),       # x2, bands divide H_out
    (3, False, None, (45, 59), 16),       # fractional, they do not
    (3, False, False, (45, 59), 16),      # the eager decoder
    (4, False, None, (45, 59), 16),       # mode 4: window-local head
    (3, True, None, (28, 36), 14),        # init_q
])
def test_predict_streaming_matches_jax(mode, init_q, use_fused, size, band):
    net, _, _ = _nets(mode, init_q, use_fused)
    want = _jax_stream(mode, init_q, None, size, band)
    got = predict_streaming(net, _lr(2), size, band_rows=band)
    assert got.dtype == np.float32 and got.shape == (2, *size, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_predict_streaming_bf16_matches_jax():
    net, _, _ = _nets(use_fused=False, dtype=jnp.bfloat16)
    size = (28, 36)
    want16 = _jax_stream(3, False, jnp.bfloat16, size, 14)
    want32 = _jax_stream(3, False, None, size, 14)
    got = predict_streaming(net, _lr(2), size, band_rows=14)
    check(got, want16, want32, DIINN_ATOL["eager"], "streaming bf16")


@pytest.mark.parametrize("use_fused,size", [(None, (45, 59)),
                                            (None, (28, 36)),
                                            (False, (45, 59))])
def test_predict_streaming_equals_one_window_decode(use_fused, size):
    net, _, _ = _nets(use_fused=use_fused)
    x = _lr()
    got = predict_streaming(net, x, size, band_rows=16)
    with torch.no_grad():
        whole = net(normalize(torch.from_numpy(x)), size, None)
        want = torch.clamp(denormalize(whole), 0.0, 1.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_stacked_lr_conv_runs_once_per_image(monkeypatch):
    net, _, _ = _nets()
    calls = []
    orig = ImplicitDecoder.lr_features_stacked

    def counted(self, feat):
        calls.append(feat.shape)
        return orig(self, feat)
    monkeypatch.setattr(ImplicitDecoder, "lr_features_stacked", counted)
    predict_streaming(net, _lr(), (45, 59), band_rows=8)
    assert len(calls) == 1
