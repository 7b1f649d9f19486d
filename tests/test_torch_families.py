"""Port parity for the model families: LIIF, MetaSR, the EDSR encoders,
MLP, the bicubic baseline and DIINN's ``init_q``, against the JAX package
on the same numpy weights (flax ``init``, carried across by
``state_dict_from_jax``) and the same seeded numpy inputs.

Tolerances (as ``tests/test_model_parity.py``): modules rtol 2e-4, atol
3e-5 of the largest magnitude; full models (encoder and decoder) rtol
5e-4, atol 1e-4 of it; both for the forward and the input gradient. They
cover fp32 sums in another order. The bf16 cases hold ``check`` of
``tests/test_torch_bf16.py``: a stated tolerance against JAX bf16, and the
port's gap at most 1/5 of JAX's own bf16-against-fp32 gap.

The reference's golden fixtures, the committed weights and the training
steps are held in ``tests/test_torch_families_golden.py``.

Oracles for ``chip_smoke.py``, made by JAX on the CPU (the card machine
has no JAX) and committed under ``tpu_diinn_torch/testdata/``:

    python -m tests.test_torch_families --benchmarks-oracle liif \\
        tpu_diinn_torch/testdata/liif_benchmarks_jax_cpu.json
    python -m tests.test_torch_families --benchmarks-oracle metasr \\
        tpu_diinn_torch/testdata/metasr_benchmarks_jax_cpu.json
    python -m tests.test_torch_families --benchmarks-oracle bicubic \\
        tpu_diinn_torch/testdata/bicubic_benchmarks_jax_cpu.json
    python -m tests.test_torch_families --diinn-edsr-oracle \\
        tpu_diinn_torch/testdata/diinn_edsr_jax_cpu.json
    python -m tests.test_torch_families --init-q-oracle \\
        tpu_diinn_torch/testdata/init_q_jax_cpu.json
    python -m tests.test_torch_families --families-train-oracle \\
        tpu_diinn_torch/testdata/families_train_jax_cpu.json

(each about the time of the JAX CLI on the CPU: minutes; run them one at
a time, with ``TPU_DIINN_COMPILE_CACHE=0``).
"""

import itertools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.core import grids as jgrids
from tpu_diinn.nn import registry as jreg
from tpu_diinn.nn.bicubic import BicubicNet as JBicubic
from tpu_diinn.nn.diinn import DIINN as JDIINN
from tpu_diinn.nn.diinn import unfold3x3 as junfold
from tpu_diinn.nn.edsr import EDSR as JEDSR
from tpu_diinn.nn.edsr import EDSRBaseline as JEDSRBaseline
from tpu_diinn.nn.liif import LIIF as JLIIF
from tpu_diinn.nn.liif import _corner_axis_indices as jcorner
from tpu_diinn.nn.metasr import MetaSR as JMetaSR
from tpu_diinn.nn.metasr import _axis_lookup as jlookup
from tpu_diinn.nn.mlp import MLP as JMLP
from tpu_diinn_torch.cli import benchmarks as tcli
from tpu_diinn_torch.core import grids as tgrids
from tpu_diinn_torch.nn import registry as treg
from tpu_diinn_torch.nn.bicubic import BicubicNet
from tpu_diinn_torch.nn.diinn import DIINN
from tpu_diinn_torch.nn.edsr import EDSR, EDSRBaseline
from tpu_diinn_torch.nn.layers import unfold3x3
from tpu_diinn_torch.nn.liif import LIIF, _corner_axis_indices
from tpu_diinn_torch.nn.metasr import MetaSR, _axis_lookup
from tpu_diinn_torch.nn.mlp import MLP
from tpu_diinn_torch.train.checkpoint import (seeded_params,
                                              state_dict_from_jax)
from tests.test_torch_bf16 import _ulp, check

REPO = Path(__file__).resolve().parents[1]
TESTDATA = REPO / "tpu_diinn_torch" / "testdata"
MODULE_TOL = (2e-4, 3e-5)
MODEL_TOL = (5e-4, 1e-4)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def close(got, want, tol, what=""):
    rtol, atol = tol
    want = np.asarray(want)
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def fwd_grad_pair(jfn, tfn, x, g, tol):
    """``jfn`` (JAX) and ``tfn`` (the port) on the NHWC numpy input ``x``:
    the outputs, and the gradients of sum(out * g) with respect to x."""
    want = jfn(jnp.asarray(x))
    want_g = jax.grad(lambda xx: (jfn(xx) * jnp.asarray(g)).sum())(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    (got * torch.from_numpy(g)).sum().backward()
    assert tuple(got.shape) == tuple(want.shape)
    close(got.detach().numpy(), want, tol, "forward")
    close(xt.grad.numpy(), want_g, tol, "input gradient")


def _port(net, params):
    net.load_state_dict(state_dict_from_jax(_flatten(params)), strict=True)
    return net


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# index maps, unfold, MLP, bicubic
# ---------------------------------------------------------------------------

# (n_in, n_out): integer scales (ties at every query), fractional ones
SIZES = [(6, 12), (5, 15), (7, 28), (8, 64), (7, 22), (48, 120), (82, 256),
         (13, 13)]


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_index_maps_match_jax(n_in, n_out):
    """The nearest lookups of LIIF's corners and MetaSR's axes, and
    ``nearest_grid_sample_indices`` over shifted query coordinates (ties
    included): equal indices and rel-coords."""
    for v in (-1, 1):
        idx, rel = _corner_axis_indices(n_in, n_out, v)
        jidx, jrel = jcorner(n_in, n_out, v, True)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(rel, jrel)
    idx, rel = _axis_lookup(n_in, n_out)
    jidx, jrel = jlookup(n_in, n_out)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(rel, jrel)
    coords = -1.0 + 1.0 / n_out + (2.0 / n_out) * np.arange(n_out)
    for shift in (0.0, 1.0 / n_in, -1.0 / n_in, 1e-6):
        c = np.clip(coords + shift, -1.0, 1.0)
        np.testing.assert_array_equal(
            tgrids.nearest_grid_sample_indices(n_in, c),
            jgrids.nearest_grid_sample_indices(n_in, c))
    np.testing.assert_array_equal(
        tgrids.cell_grid((n_out, n_in)).numpy(),
        np.asarray(jgrids.cell_grid((n_out, n_in))))


@pytest.mark.parametrize("shape", [(2, 5, 6, 3), (1, 4, 4, 16)])
def test_unfold3x3_matches_jax_and_torch_unfold(shape):
    x = _rand(shape, sum(shape))
    got = unfold3x3(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(junfold(jnp.asarray(x))))
    b, h, w, c = shape
    ref = torch.nn.functional.unfold(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, padding=1)
    np.testing.assert_array_equal(
        got.numpy(), ref.reshape(b, c * 9, h, w).permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("hidden", [(16,), (24, 8, 32)])
def test_mlp_matches_jax(hidden):
    jnet = JMLP(out_dim=5, hidden=hidden)
    x = _rand((3, 4, 7), len(hidden))
    params = jnet.init(jax.random.PRNGKey(len(hidden)), jnp.asarray(x))
    tnet = _port(MLP(7, 5, hidden), params)
    g = _rand((3, 4, 5), 11)
    fwd_grad_pair(lambda xx: jnet.apply(params, xx), tnet, x, g, MODULE_TOL)


@pytest.mark.parametrize("lr_hw,out_hw", [((6, 7), (12, 14)),
                                          ((9, 8), (28, 25)),
                                          ((16, 12), (7, 5))])
def test_bicubic_net_matches_jax(lr_hw, out_hw):
    x = _rand((2, *lr_hw, 3), sum(out_hw))
    g = _rand((2, *out_hw, 3), 3)
    jnet = JBicubic()
    assert list(BicubicNet().parameters()) == []
    fwd_grad_pair(lambda xx: jnet.apply({}, xx, out_hw),
                  lambda xx: BicubicNet()(xx, out_hw), x, g, MODULE_TOL)


# ---------------------------------------------------------------------------
# EDSR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,scale", [("baseline", None), ("full", 2),
                                           ("full", 3), ("full", 4)])
def test_edsr_matches_jax(variant, scale):
    x = _rand((2, 6, 7, 3), 3, 0.0, 1.0)
    if variant == "baseline":
        jnet = JEDSRBaseline(n_resblocks=3, n_feats=16)
        tnet = EDSRBaseline(n_resblocks=3, n_feats=16)
        out_shape = (2, 6, 7, 16)
    else:
        jnet = JEDSR(n_resblocks=2, n_feats=16, scale=scale)
        tnet = EDSR(n_resblocks=2, n_feats=16, scale=scale)
        out_shape = (2, 6 * scale, 7 * scale, 3)
    params = jnet.init(jax.random.PRNGKey(scale or 0), jnp.asarray(x))
    tnet = _port(tnet, params)
    g = _rand(out_shape, 5)
    fwd_grad_pair(lambda xx: jnet.apply(params, xx), tnet, x, g, MODULE_TOL)


# ---------------------------------------------------------------------------
# LIIF and MetaSR
# ---------------------------------------------------------------------------

def _family_pair(arch, encoder, seed=0, dtype=None):
    """The JAX net, its flax-init params, and the port's net on them."""
    hid = (32, 32, 32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    if arch == "liif":
        jnet = JLIIF(encoder_spec=encoder, hidden=hid, dtype=dtype)
        tnet = LIIF(encoder_spec=encoder, hidden=hid, dtype=tdt)
    else:
        c = jreg.encoder_out_dim(encoder)
        jnet = JMetaSR(encoder_spec=encoder, feat_dim=c, dtype=dtype)
        tnet = MetaSR(encoder_spec=encoder, feat_dim=c, dtype=tdt)
    params = jnet.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 5, 6, 3), jnp.float32), (10, 12))
    return jnet, params, _port(tnet, params)


FAMILY_CASES = [
    # (arch, encoder, lr (h, w), out (h, w), bsize)
    ("liif", "rdn-tiny", (6, 7), (12, 14), None),       # x2: ties
    ("liif", "edsr-baseline-tiny", (7, 9), (22, 28), None),   # x3.14
    ("liif", "rdn-tiny", (5, 6), (20, 24), 60),         # x4, chunks
    ("metasr", "rdn-tiny", (6, 7), (12, 14), None),
    ("metasr", "edsr-baseline-tiny", (7, 9), (22, 28), None),
    ("metasr", "rdn-tiny", (5, 6), (20, 24), 60),
]


@pytest.mark.parametrize("arch,encoder,lr_hw,out_hw,bsize", FAMILY_CASES)
@pytest.mark.parametrize("part", ["decode", "full"])
def test_family_matches_jax(arch, encoder, lr_hw, out_hw, bsize, part):
    """``decode`` (input: the feature grid) at module tolerance, the full
    model (input: the LR image) at model tolerance; forward and input
    gradient."""
    jnet, params, tnet = _family_pair(arch, encoder)
    cls = JLIIF if arch == "liif" else JMetaSR
    g = _rand((2, *out_hw, 3), 7)
    if part == "decode":
        x = _rand((2, *lr_hw, tnet.encoder.out_dim), sum(lr_hw))
        fwd_grad_pair(lambda xx: jnet.apply(params, xx, out_hw, bsize,
                                            method=cls.decode),
                      lambda xx: tnet.decode(xx, out_hw, bsize), x, g,
                      MODULE_TOL)
    else:
        x = _rand((2, *lr_hw, 3), sum(lr_hw) + 1)
        fwd_grad_pair(lambda xx: jnet.apply(params, xx, out_hw, bsize),
                      lambda xx: tnet(xx, out_hw, bsize), x, g, MODEL_TOL)


@pytest.mark.parametrize("arch", ["liif", "metasr"])
@pytest.mark.parametrize("bsize", [1, 45, 100])
def test_family_chunked_decode_equals_whole(arch, bsize):
    """Column chunks of bsize // H_out queries (down to one column) give
    the whole-grid decode."""
    _, _, tnet = _family_pair(arch, "rdn-tiny")
    feat = torch.from_numpy(_rand((1, 7, 9, 16), 2))
    with torch.no_grad():
        whole = tnet.decode(feat, (22, 28))
        chunked = tnet.decode(feat, (22, 28), bsize)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["liif", "metasr"])
@pytest.mark.parametrize("out_hw", [(12, 14), (22, 28)])
def test_family_decode_bf16_matches_jax(arch, out_hw):
    """The bf16 decode (bf16 features, every dense layer in bf16 over the
    fp32 params) against JAX bf16. Tolerance: 4 bf16 ulps of the output's
    largest magnitude (the per-query products sum in another fp32 order,
    and a rounded intermediate may land on the other bf16 neighbour)."""
    lr_hw = (7, 9) if out_hw == (22, 28) else (6, 7)
    jnet16, params, tnet = _family_pair(arch, "rdn-tiny",
                                        dtype=jnp.bfloat16)
    jnet32, _, _ = _family_pair(arch, "rdn-tiny")
    cls = JLIIF if arch == "liif" else JMetaSR
    x = _rand((1, *lr_hw, 16), 13)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want16 = jnet16.apply(params, x16, out_hw, method=cls.decode)
    want32 = jnet32.apply(params, x16.astype(jnp.float32), out_hw,
                          method=cls.decode)
    assert want16.dtype == jnp.bfloat16
    with torch.no_grad():
        got = tnet.decode(torch.from_numpy(
            np.array(x16.astype(jnp.float32))).to(torch.bfloat16), out_hw)
    assert got.dtype == torch.bfloat16
    check(got, want16, want32, 4 * _ulp(want16), f"{arch} bf16 decode")


# ---------------------------------------------------------------------------
# DIINN init_q
# ---------------------------------------------------------------------------

INIT_Q_CASES = [
    # (mode, encoder, lr, out, bsize)
    (1, "rdn-tiny", (6, 7), (12, 14), None),
    (2, "rdn-tiny", (7, 9), (22, 28), 60),
    (3, "rdn-tiny", (6, 7), (12, 14), None),
    (3, "edsr-baseline-tiny", (7, 9), (22, 28), None),
    (3, "rdn-tiny", (5, 6), (20, 24), 60),     # x4: column chunks
    (4, "rdn-tiny", (7, 9), (22, 28), None),
    (4, "rdn-tiny", (7, 9), (22, 28), 60),     # chunk-local reflect conv
]


@pytest.mark.parametrize("mode,encoder,lr_hw,out_hw,bsize", INIT_Q_CASES)
def test_init_q_diinn_matches_jax(mode, encoder, lr_hw, out_hw, bsize):
    """The whole model with ``init_q``, forward and input gradient, at
    model tolerance. The fused gate refuses init_q on both sides."""
    kw = dict(mode=mode, init_q=True, encoder_spec=encoder,
              hidden_dims=(32,) * 3)
    jnet = JDIINN(**kw)
    params = jnet.init(jax.random.PRNGKey(mode), jnp.zeros(
        (1, *lr_hw, 3), jnp.float32), out_hw)
    tnet = _port(DIINN(**kw), params)
    feat = torch.zeros((1, *lr_hw, tnet.encoder.out_dim))
    assert not tnet.decoder._fused_ok(feat)
    x = _rand((2, *lr_hw, 3), mode + 20)
    g = _rand((2, *out_hw, 3), mode + 21)
    fwd_grad_pair(lambda xx: jnet.apply(params, xx, out_hw, bsize),
                  lambda xx: tnet(xx, out_hw, bsize), x, g, MODEL_TOL)


# ---------------------------------------------------------------------------
# registry, seeded weights, the benchmark CLI
# ---------------------------------------------------------------------------

PAIRS = list(itertools.product(("diinn", "liif", "metasr", "bicubic"),
                               jreg.ENCODERS))


@pytest.mark.parametrize("arch,encoder", PAIRS)
def test_registry_builds_every_jax_pair(arch, encoder):
    """Every (arch, encoder) pair of the JAX registry builds in the port
    and decodes; the parameter paths are the JAX model's."""
    assert set(treg.ENCODERS) == set(jreg.ENCODERS)
    assert treg.encoder_out_dim(encoder) == jreg.encoder_out_dim(encoder)
    hid = [16, 16] if arch in ("diinn", "liif") else None
    tnet = treg.make_net(arch, encoder_spec=encoder, hidden_dims=hid)
    jnet = jreg.make_net(arch, encoder_spec=encoder, hidden_dims=hid)
    x = jnp.zeros((1, 4, 5, 3), jnp.float32)
    want = _flatten(jnet.init(jax.random.PRNGKey(0), x, (9, 11))) \
        if arch != "bicubic" else {}
    got = {k: v.shape for k, v in seeded_params(tnet, 0).items()}
    assert got == {k: v.shape for k, v in want.items()}
    with torch.no_grad():
        out = tnet(torch.zeros((1, 4, 5, 3)), (9, 11), 30)
    assert out.shape == (1, 9, 11, 3)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_registry_builds_init_q(mode):
    net = treg.make_net("diinn", mode=mode, init_q=True,
                        encoder_spec="rdn-tiny", hidden_dims=[16] * 3)
    assert net.decoder.init_q and hasattr(net.decoder, "k0_dense")
    assert not hasattr(net.decoder, "k0_conv")


def test_seeded_params_are_seeded_and_bounded():
    net = treg.make_net("liif", encoder_spec="rdn-tiny",
                        hidden_dims=[16, 16])
    a, b, c = (seeded_params(net, s) for s in (3, 3, 4))
    assert list(a) == sorted(a)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["params/imnet_fc1/dense/kernel"],
                              c["params/imnet_fc1/dense/kernel"])
    w = a["params/imnet_feat/conv/kernel"]       # HWIO (3, 3, 16, 16)
    assert w.dtype == np.float32 and np.abs(w).max() <= 1 / np.sqrt(144)
    net.load_state_dict(state_dict_from_jax(a), strict=True)


def test_bicubic_cli_matches_jax(monkeypatch):
    """``--bicubic_test`` of the port's CLI on the CPU against the JAX
    CLI: every metric within 1e-4 dB (PSNR, LR-PSNR) and 1e-5 (SSIM)."""
    from tpu_diinn.cli import benchmarks as jcli
    monkeypatch.setenv("TPU_DIINN_COMPILE_CACHE", "0")
    args = ["--bicubic_test", "--testsets", "Set5", "--max_images", "1",
            "--scales", "3.14", "4"]
    want = jcli.main(args)
    got = tcli.main(args + ["--device", "cpu"])
    assert set(got["Set5"]) == set(want["Set5"]) and len(got["Set5"]) == 6
    for key, w in want["Set5"].items():
        tol = 1e-5 if "ssim" in key else 1e-4
        assert abs(got["Set5"][key] - w) <= tol, (key, got["Set5"][key], w)


def test_cli_needs_weights_or_bicubic():
    with pytest.raises(SystemExit):
        tcli.main(["--device", "cpu"])


# ---------------------------------------------------------------------------
# oracle generators (python -m tests.test_torch_families ...)
# ---------------------------------------------------------------------------

def benchmarks_oracle(family: str) -> dict:
    """The JAX CLI's benchmark metrics (4 sets x {3.14, 4, 8}, exact-shape
    eval) of ``results/<family>_weights.npz``, or of the bicubic baseline
    (``--bicubic_test``)."""
    from tpu_diinn.cli import benchmarks as jbench
    args = (["--bicubic_test"] if family == "bicubic" else
            ["--ckpt_path", str(REPO / "results" / f"{family}_weights.npz")])
    return jbench.main(args + ["--root", str(REPO / "data"),
                               "--eval_buckets", "0"])


def _jax_net(overrides):
    from tpu_diinn.config.config import load_config as jload_config
    from tpu_diinn.train import loop as jloop
    cfg = jload_config(None, list(overrides))
    return jloop.build_task(cfg).net, cfg


def jax_edsr_eval_inputs():
    """``chip_smoke.edsr_eval_inputs`` through the JAX package's own test
    sets and eval pipeline: (key, LR image, HR size) of Set5 at
    EDSR_SCALES."""
    import chip_smoke as cs
    from tpu_diinn.config.config import load_config as jload_config
    from tpu_diinn.data import pipeline as jpipeline
    from tpu_diinn.train import loop as jloop
    cfg = jload_config(None, list(cs.EDSR_OVERRIDES))
    cfg.data.test_scales = list(cs.EDSR_SCALES)
    cfg.data.testsets = [("benchmark", "Set5")]
    dset = jloop.make_test_datasets(cfg)["Set5"]
    for i, batch in jpipeline.eval_batches(dset):
        for s, (lr, hr, _name) in batch.items():
            yield f"{i}/x{s:g}", lr, (hr.shape[1], hr.shape[2])


def jax_init_q_batch() -> dict:
    """``chip_smoke.init_q_batch`` with the JAX package's ``resize_np``."""
    import chip_smoke as cs
    from tpu_diinn.core.resize import resize_np as jresize_np
    rng = np.random.default_rng(cs.SEED)
    hr = rng.uniform(0, 1, (cs.INIT_Q_BATCH, cs.INIT_Q_HR, cs.INIT_Q_HR,
                            3)).astype(np.float32)
    lr = np.clip(jresize_np(hr, (48, 48)), 0.0, 1.0).astype(np.float32)
    return {cs.INIT_Q_SCALE: (lr, hr)}


def test_smoke_inputs_match_jax_loaders():
    """Phases 6b and 6c build their inputs with the port's loader and
    resize; their oracles build them with the JAX package's. Both give the
    same arrays bit for bit, so the oracles do not lean on the port."""
    import chip_smoke as cs
    got = list(cs.edsr_eval_inputs())
    want = list(jax_edsr_eval_inputs())
    assert [(k, size) for k, _, size in got] == [(k, size)
                                                 for k, _, size in want]
    assert len(got) == 10
    for (key, lr, _), (_, jlr, _) in zip(got, want):
        assert lr.dtype == jlr.dtype and np.array_equal(lr, jlr), key
    (lr, hr), = cs.init_q_batch().values()
    (jlr, jhr), = jax_init_q_batch().values()
    assert np.array_equal(hr, jhr) and np.array_equal(lr, jlr)


def diinn_edsr_oracle() -> dict:
    """``chip_smoke.py`` phase 6b's oracle: DIINN + EDSR-baseline (mode 3,
    hidden 4 x 256) on ``seeded_params`` weights, JAX's exact-shape apply
    with bsize eval_bsize, per-image ``summarize`` of the un-clamped
    prediction of Set5 at x2 and x3.14, loaded by the JAX package."""
    import chip_smoke as cs
    from tpu_diinn.train.task import normalize as jnormalize
    jnet, cfg = _jax_net(cs.EDSR_OVERRIDES)
    flat = seeded_params(treg.make_net("diinn", encoder_spec="edsr-baseline"),
                         cs.SEED)
    params = _unflatten(flat)
    apply = jax.jit(jnet.apply, static_argnums=(2, 3))
    images = {key: cs.summarize(apply(params, jnormalize(jnp.asarray(lr)),
                                      size, cfg.model.eval_bsize))
              for key, lr, size in jax_edsr_eval_inputs()}
    return {"config": cs.EDSR_OVERRIDES, "seed": cs.SEED,
            "platform": "JAX on the CPU", "images": images}


def init_q_oracle() -> dict:
    """``chip_smoke.py`` phase 6c's oracle: DIINN mode 3 with init_q
    (RDN-B, hidden 4 x 256) on ``seeded_params`` weights: the summary of
    the un-clamped output of ``init_q_batch`` and one JAX train step's
    loss and grad norm on it."""
    import chip_smoke as cs
    from tests.test_torch_train import jax_train_oracle
    from tpu_diinn.train.task import normalize as jnormalize
    flat = seeded_params(treg.make_net("diinn", init_q=True), cs.SEED)
    batch = jax_init_q_batch()
    (lr, hr), = batch.values()
    jnet, _ = _jax_net(cs.INIT_Q_OVERRIDES)
    pred = jax.jit(jnet.apply, static_argnums=2)(
        _unflatten(flat), jnormalize(jnp.asarray(lr)), hr.shape[1:3])
    _, steps, _ = jax_train_oracle(cs.INIT_Q_OVERRIDES, [batch], 1,
                                   params=flat)
    return {"config": cs.INIT_Q_OVERRIDES, "seed": cs.SEED,
            "platform": "JAX on the CPU", "step": steps[0],
            "output": cs.summarize(pred)}


def families_train_oracle() -> dict:
    """``chip_smoke.py`` phase 6d's oracle: three JAX steps each of LIIF
    and MetaSR from their committed weights on the flagship's first three
    training batches."""
    from tests.test_torch_train import flagship_oracle
    return {fam: flagship_oracle(3, [f"model.arch={fam}"],
                                 weights=REPO / "results" /
                                 f"{fam}_weights.npz")
            for fam in ("liif", "metasr")}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    flag, *rest = sys.argv[1:]
    if flag == "--benchmarks-oracle":
        out = benchmarks_oracle(rest.pop(0))
    else:
        out = {"--diinn-edsr-oracle": diinn_edsr_oracle,
               "--init-q-oracle": init_q_oracle,
               "--families-train-oracle": families_train_oracle}[flag]()
    Path(rest[0]).write_text(json.dumps(out, indent=1) + "\n")
