"""The port's compact weights export (``export_params_npz``) against the
JAX package's: the same parameters and meta, saved by each package's
``CheckpointManager`` and exported by each, give files with the same keys,
bit-equal uint16 arrays and equal meta, and JAX's ``load_params`` reads
the port's file. The port's bf16 rounding equals ``ml_dtypes.bfloat16``
bit for bit; re-exporting ``results/flagship_weights.npz`` through the
port gives its arrays back bit for bit. All exact."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_diinn.nn import registry as jreg
from tpu_diinn.train import checkpoint as jckpt
from tpu_diinn_torch.nn.diinn import DIINN
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.train import checkpoint as ckpt

FLAGSHIP = "results/flagship_weights.npz"
META = dict(step=5, val_loss=0.5, config={"a": 1, "b": [2, 2.5]}, epoch=2)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _files(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_export(got_path, want_path):
    got, want = _files(got_path), _files(want_path)
    assert sorted(got) == sorted(want)
    assert json.loads(str(got.pop("__meta__"))) == json.loads(
        str(want.pop("__meta__")))
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_export_matches_jax(tmp_path):
    jnet = jreg.make_net("diinn", encoder_spec="rdn-tiny",
                         hidden_dims=[32, 32])
    variables = jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 6, 6, 3), jnp.float32), (12, 12))
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax_ck"))
    jmgr.save({"params": variables}, **META)
    jmeta = jckpt.export_params_npz(str(tmp_path / "jax_ck"),
                                    str(tmp_path / "jax.npz"))

    net = make_net("diinn", encoder_spec="rdn-tiny", hidden_dims=[32, 32])
    net.load_state_dict(ckpt.state_dict_from_jax(_flatten(variables)),
                        strict=True)
    ckpt.CheckpointManager(str(tmp_path / "port_ck")).save(net, **META)
    meta = ckpt.export_params_npz(str(tmp_path / "port_ck"),
                                  str(tmp_path / "port.npz"))
    assert meta == jmeta == {"step": 5, "epoch": 2, "val_loss": 0.5,
                             "config": META["config"]}
    _assert_same_export(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert all(k == "__meta__" or k.startswith("bf16:params/")
               for k in _files(tmp_path / "port.npz"))

    # JAX's loader reads the port's file as its own
    got, got_meta = jckpt.load_params(str(tmp_path / "port.npz"))
    want, want_meta = jckpt.load_params(str(tmp_path / "jax.npz"))
    assert got_meta == want_meta
    g, w = _flatten(got["params"]), _flatten(want["params"])
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])


def test_export_keeps_non_float_arrays_raw(tmp_path):
    """An array that is not a float (a counter) is stored raw, as JAX
    stores it; here from an export that carries one."""
    rng = np.random.default_rng(0)
    tree = {"params": {"a": {"kernel": rng.standard_normal((3, 4)).astype(
        np.float32)}}, "count": np.arange(5, dtype=np.int32)}
    jckpt.CheckpointManager(str(tmp_path / "jax_ck")).save(
        {"params": tree}, **META)
    jckpt.export_params_npz(str(tmp_path / "jax_ck"),
                            str(tmp_path / "jax.npz"))
    np.savez(tmp_path / "src.npz", __meta__=np.str_(json.dumps(
        {"step": 5, "epoch": 2, "val_loss": 0.5, "config": META["config"],
         "extra": 1})), **_flatten(tree))
    meta = ckpt.export_params_npz(str(tmp_path / "src.npz"),
                                  str(tmp_path / "port.npz"))
    assert "extra" not in meta
    _assert_same_export(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert _files(tmp_path / "port.npz")["count"].dtype == np.int32


def _bits(*words):
    return np.array(words, np.uint32).view(np.float32)


ROUNDING_CASES = {
    "signed_zeros": np.array([0.0, -0.0], np.float32),
    "subnormals": np.concatenate([
        _bits(0x00000001, 0x80000001, 0x00008000, 0x00018000, 0x007fffff,
              0x807fffff, 0x00010000, 0x0000ffff),
        np.float32(1e-40) * np.arange(-20, 21, dtype=np.float32)]),
    # dropped half exactly 0x8000: to even (down from even, up from odd),
    # and one ulp either side of the tie
    "ties": _bits(0x3f808000, 0x3f818000, 0xbf808000, 0xbf818000,
                  0x3f807fff, 0x3f808001, 0x7f7f8000, 0x7f7e8000),
    "infinities": np.concatenate([
        np.array([np.inf, -np.inf], np.float32),
        _bits(0x7f7fffff, 0xff7fffff, 0x7f7f7fff)]),   # past bf16's max
    "nans": _bits(0x7fc00000, 0xffc00000, 0x7f800001, 0xff800001,
                  0x7fbfffff, 0x7fffffff, 0xffffffff, 0x7f810000),
    "seeded": np.concatenate([
        np.random.default_rng(0).standard_normal(100_000).astype(np.float32),
        np.random.default_rng(1).integers(0, 2 ** 32, 100_000,
                                          dtype=np.uint64).astype(
            np.uint32).view(np.float32)]),
}


@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
def test_bf16_rounding_matches_ml_dtypes(case):
    x = ROUNDING_CASES[case]
    with np.errstate(invalid="ignore"):     # ml_dtypes' cast of a NaN
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        wide = x.astype(np.float64)
        want_wide = wide.astype(ml_dtypes.bfloat16).view(np.uint16)
        got_wide = ckpt.f32_to_bf16_bits(wide)
    got = ckpt.f32_to_bf16_bits(x)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    # float64 input narrows to float32 first, as ml_dtypes does
    np.testing.assert_array_equal(got_wide, want_wide)


def test_reexport_flagship_bit_for_bit(tmp_path):
    """The flagship export, loaded into the port, saved by its trainer's
    ``CheckpointManager`` (fp32) and exported: the same file contents,
    as bf16 values round to themselves."""
    flat, meta = ckpt.load_params_npz(FLAGSHIP)
    net = DIINN(mode=meta["config"]["model"]["mode"],
                encoder_spec=meta["config"]["model"]["encoder"])
    net.load_state_dict(ckpt.state_dict_from_jax(flat), strict=True)
    ckpt.CheckpointManager(str(tmp_path / "ck")).save(
        net, step=meta["step"], val_loss=meta["val_loss"],
        config=meta["config"], epoch=meta["epoch"])
    out = ckpt.export_params_npz(str(tmp_path / "ck"),
                                 str(tmp_path / "re.npz"))
    assert out == meta
    _assert_same_export(tmp_path / "re.npz", FLAGSHIP)


def test_load_params_and_export_read_last(tmp_path):
    net = make_net("diinn", encoder_spec="rdn-tiny", hidden_dims=[32, 32])
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(net, step=1, val_loss=0.5, config={}, epoch=0)
    with torch.no_grad():
        net.decoder.q1.dense.bias.add_(1.0)
    mgr.save(net, step=2, val_loss=0.7, config={}, epoch=1)  # last only
    best, best_meta = ckpt.load_params(str(tmp_path / "ck"))
    last, last_meta = ckpt.load_params(str(tmp_path / "ck"), "last")
    assert (best_meta["step"], last_meta["step"]) == (1, 2)
    key = "params/decoder/q1/dense/bias"
    np.testing.assert_array_equal(last[key], best[key] + 1.0)
    meta = ckpt.export_params_npz(str(tmp_path / "ck"),
                                  str(tmp_path / "last.npz"), tag="last")
    assert meta["step"] == 2
    flat, _ = ckpt.load_params(str(tmp_path / "last.npz"))
    np.testing.assert_array_equal(
        ckpt.f32_to_bf16_bits(flat[key]), ckpt.f32_to_bf16_bits(last[key]))
