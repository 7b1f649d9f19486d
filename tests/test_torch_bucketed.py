"""Port parity for the bucketed static-shape eval (``train/bucketed.py``,
``nn/masking.py``, the masked metrics, every family's ``decode_traced``).

Each case holds the port against the JAX package on the same seeded numpy
inputs and the same weights (flax ``init``, carried across by
``state_dict_from_jax``), at tiny sizes (``rdn-tiny``, hidden 32,
``eval_bsize=997``, quantum 32):

(a) the masked metrics of a 37x29 image on a 64x64 canvas against JAX's
    masked metrics and the port's exact ones: PSNR rtol 1e-6, SSIM and
    LR-PSNR 1e-5 (fp32 summation order);
(b) the masked encoders against JAX's under ``valid_extent`` and against
    the port's unpadded run, atol 1e-6, the pad region exactly 0;
    ``MeanShift`` alone (only the full ``EDSR`` has one);
(c) the synthesis grid computed from the true sizes against JAX's
    ``_syn_traced``, to 1 ulp;
(d) the bucket table against JAX's, the widening case included;
(e) ``BucketedEval`` against JAX's ``BucketedEval``, each metric within
    1e-4 (PSNR in dB): DIINN's traced route (eager and fused), its kernel
    route in fp32 and bf16 (JAX's Pallas kernels in interpret mode), LIIF
    and MetaSR; a second image of the same bucket adds no program. The
    traced route in bf16 on the fused configuration is held to
    ``JaxWindowBucketedEval``: JAX's traced programs decode with XLA, the
    port's with the window kernel, and in bf16 the two round at other
    points. The bf16 traced predictions themselves, on both routes, are
    held to JAX's at ``tests/test_torch_bf16.py``'s bounds (its tolerance
    and its ratio bound): XLA keeps excess precision between fused
    elementwise ops on the CPU, so the eager route's metrics differ from
    JAX's by about 1e-4 dB;
(f) the benchmark CLI: ``--eval_buckets 32`` against JAX's, and the
    port's bucketed route against its own exact route (``--eval_buckets
    0``) within the same 1e-4.

Oracle for ``chip_smoke.py`` phase 10b (JAX on the CPU, the fused route in
interpret mode, Set5 at {3.14, 4, 8} in bf16: bucketed, bucketed with the
traced programs on the window kernel, and exact; a few minutes):

    TPU_DIINN_PLATFORM=cpu TPU_DIINN_COMPILE_CACHE=0 \\
        python -m tests.test_torch_bucketed --oracle-bf16 \\
        tpu_diinn_torch/testdata/flagship_bf16_bucketed_jax_cpu.json
"""

import json
import re
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.cli import benchmarks as jcli
from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.core import grids as jgrids
from tpu_diinn.core.resize import resize_matrix
from tpu_diinn.kernels import decoder_fused as jk
from tpu_diinn.nn import layers as jlayers
from tpu_diinn.nn.diinn import ImplicitDecoder as JImplicitDecoder
from tpu_diinn.nn.masking import valid_extent as jvalid_extent
from tpu_diinn.nn.registry import make_encoder as jmake_encoder
from tpu_diinn.train import bucketed as jb
from tpu_diinn.train import loop as jloop
from tpu_diinn.train import metrics as JM
from tpu_diinn_torch.cli import benchmarks as tcli
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.core.resize import resize_by_scale_size
from tpu_diinn_torch.nn import layers as tlayers
from tpu_diinn_torch.nn.masking import valid_extent
from tpu_diinn_torch.nn.registry import make_encoder
from tpu_diinn_torch.train import bucketed as tb
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train import metrics as M
from tpu_diinn_torch.train.checkpoint import state_dict_from_jax
from tests.test_torch_benchmarks import _write_tiny_npz

REPO = Path(__file__).resolve().parents[1]
TINY = ["model.encoder=rdn-tiny", "model.eval_bsize=997"]
METRIC_TOL = 1e-4


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _img(rng, h, w, b=1):
    return rng.random((b, h, w, 3)).astype(np.float32)


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


# ---------------------------------------------------------------------------
# (a) masked metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["psnr", "ssim", "lr_psnr"])
def test_masked_metrics_match_jax_and_exact(metric):
    rng = np.random.default_rng(0)
    sr, hr = _img(rng, 37, 29), _img(rng, 37, 29)
    srp, hrp = tb._pad_to(sr, (1, 64, 64, 3)), tb._pad_to(hr, (1, 64, 64, 3))
    hv, wv = np.int32(37), np.int32(29)
    t = torch.from_numpy
    if metric == "lr_psnr":
        scale = 2.0
        hl, wl = resize_by_scale_size((37, 29), scale)
        mh = tb._pad_to(resize_matrix(37, hl).astype(np.float32), (32, 64))
        mw = tb._pad_to(resize_matrix(29, wl).astype(np.float32), (32, 64))
        want = JM.lr_psnr_masked(srp, hrp, mh, mw, np.int32(hl),
                                 np.int32(wl))
        got = M.lr_psnr_masked(t(srp), t(hrp), t(mh), t(mw), _i32(hl),
                               _i32(wl))
        exact = M.lr_psnr(t(sr), t(hr), scale)
    else:
        want = getattr(JM, f"{metric}_masked")(srp, hrp, hv, wv)
        got = getattr(M, f"{metric}_masked")(t(srp), t(hrp), _i32(37),
                                             _i32(29))
        exact = getattr(M, metric)(t(sr), t(hr))
    rtol = 1e-6 if metric == "psnr" else 1e-5
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    np.testing.assert_allclose(float(got), float(exact), rtol=rtol)


# ---------------------------------------------------------------------------
# (b) masked encoders and MeanShift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["rdn-tiny", "edsr-baseline-tiny"])
def test_masked_encoder_matches_jax_and_unpadded(spec):
    rng = np.random.default_rng(1)
    x = _img(rng, 24, 20)
    xp = tb._pad_to(x, (1, 32, 32, 3))
    jenc = jmake_encoder(spec)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with jvalid_extent((32, 32), jnp.int32(24), jnp.int32(20)):
        want = np.asarray(jenc.apply(params, jnp.asarray(xp)))
    enc = make_encoder(spec)
    enc.load_state_dict(state_dict_from_jax(_flatten(params["params"])),
                        strict=True)
    with torch.no_grad():
        ref = enc(torch.from_numpy(x)).numpy()
        with valid_extent((32, 32), _i32(24), _i32(20)):
            got = enc(torch.from_numpy(xp)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[:, :24, :20], ref, atol=1e-6, rtol=0)
    assert np.abs(got[:, 24:]).max() == 0.0
    assert np.abs(got[:, :, 20:]).max() == 0.0


def test_masked_mean_shift_matches_jax():
    rng = np.random.default_rng(2)
    xp = tb._pad_to(_img(rng, 13, 9), (1, 16, 16, 3))
    jm = jlayers.MeanShift(sign=-1)
    with jvalid_extent((16, 16), jnp.int32(13), jnp.int32(9)):
        want = np.asarray(jm.apply({}, jnp.asarray(xp)))
    m = tlayers.MeanShift(sign=-1)
    assert dict(m.state_dict()) == {}
    with valid_extent((16, 16), _i32(13), _i32(9)):
        got = m(torch.from_numpy(xp).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[:, 13:]).max() == 0.0 and np.abs(got[:, :, 9:]).max() == 0


def test_valid_extent_takes_device_tensors_and_refuses_halo():
    with pytest.raises(TypeError, match="0-d int32 tensor"):
        with valid_extent((8, 8), 5, 6):
            pass
    conv = tlayers.Conv(3, 4, 3, halo=object())
    with valid_extent((8, 8), _i32(5), _i32(6)):
        with pytest.raises(RuntimeError, match="halo"):
            conv(torch.zeros(1, 3, 8, 8))


# ---------------------------------------------------------------------------
# (c) the synthesis grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr_hw,hr_hw,pad", [
    ((21, 17), (53, 43), (32, 32, 64, 64)),
    ((82, 82), (256, 256), (128, 128, 256, 256)),
    ((130, 130), (408, 408), (192, 192, 512, 512)),
])
def test_syn_traced_matches_jax(lr_hw, hr_hw, pad):
    from tpu_diinn_torch.core import grids
    h, w = lr_hw
    hh, ww = hr_hw
    h_pad, w_pad, hh_pad, ww_pad = pad
    rows = grids.nearest_exact_indices(h, hh)
    cols = grids.nearest_exact_indices(w, ww)
    rows = tb._pad_to(rows, (hh_pad,), rows[-1])
    cols = tb._pad_to(cols, (ww_pad,), cols[-1])
    want = np.asarray(jb._syn_traced(
        (hh_pad, ww_pad), (h_pad, w_pad), jnp.int32(h), jnp.int32(w),
        jnp.int32(hh), jnp.int32(ww), jnp.asarray(rows), jnp.asarray(cols)))
    got = tb._syn_traced((hh_pad, ww_pad), (h_pad, w_pad), _i32(h), _i32(w),
                         _i32(hh), _i32(ww), torch.from_numpy(rows),
                         torch.from_numpy(cols)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# (d) buckets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_evals():
    cfg = jload_config(None, TINY + ["model.hidden_dims=[32,32,32]"])
    jev = jb.BucketedEval(jloop.build_task(cfg), quantum=32)
    tcfg = load_config(None, TINY + ["model.hidden_dims=[32,32,32]"])
    tev = tb.BucketedEval(loop.build_task(tcfg, device="cpu"), quantum=32)
    return jev, tev


@pytest.mark.parametrize("lr_hw,hr_hw,scale", [
    ((21, 17), (42, 34), 2.0),
    ((21, 17), (53, 43), 2.5),
    ((64, 32), (258, 128), 4.0),       # round(258/4) = 64: widen once
    ((82, 82), (256, 256), 3.14),
    ((51, 51), (408, 408), 8.0),
    ((130, 96), (408, 301), 3.14),
])
def test_buckets_match_jax(tiny_evals, lr_hw, hr_hw, scale):
    jev, tev = tiny_evals
    assert tev._buckets(lr_hw, hr_hw, scale) == jev._buckets(lr_hw, hr_hw,
                                                             scale)


# ---------------------------------------------------------------------------
# (e) BucketedEval against JAX's
# ---------------------------------------------------------------------------

def _jax_traced_pred(jev, p, key, lr, hv, wv, hhv, wwv, rows, cols,
                     window):
    """The prediction of JAX's "traced" bucketed program (as
    ``jb.BucketedEval._program`` computes it) on the padded canvas. With
    ``window`` its decode is JAX's fused window kernel (interpret mode on
    the CPU) over one-hot gathers of the padded index vectors, rounded to
    the decoder's dtype as JAX's fused exact route rounds it: what the
    port's traced route runs on the fused configuration."""
    _, h_pad, w_pad, hh_pad, ww_pad = key
    syn = jb._syn_traced((hh_pad, ww_pad), (h_pad, w_pad), hv, wv, hhv, wwv,
                         rows, cols)
    dp = {"params": p["decoder"]}
    with jvalid_extent((h_pad, w_pad), hv, wv):
        feat = jev._encode(p, lr, h_pad, w_pad, hv, wv)
        if window:
            z, kp = jev.dec.apply(dp, feat, method=lambda m, f: (
                m.lr_features_stacked(f), m._fused_params()))
        else:
            pred = jev.dec.apply(dp, feat, syn, rows, cols,
                                 jev.task.eval_bsize,
                                 method=JImplicitDecoder.decode_traced)
    if window:
        onehot = lambda idx, n: jax.nn.one_hot(idx, n, dtype=jnp.bfloat16)
        pred = jk.decode_fused_window(z, syn, kp, onehot(rows, h_pad),
                                      onehot(cols, w_pad)).astype(z.dtype)
    return jnp.clip(jb.denormalize(pred), 0.0, 1.0)


class JaxWindowBucketedEval(jb.BucketedEval):
    """JAX's ``BucketedEval`` with its "traced" DIINN programs on the fused
    configuration decoded by JAX's window kernel (``_jax_traced_pred``):
    the port's bucketed route written with the JAX package's code alone.
    Its "kernel" programs are JAX's own."""

    def _program(self, key):
        if key[0] != "traced" or not self.dec._fused_config_ok():
            return super()._program(key)
        if key not in self._jit:
            def f(params, lr, hr, hv, wv, hhv, wwv, rows, cols, mh, mw,
                  hlv, wlv):
                p = params["params"] if "params" in params else params
                pred = _jax_traced_pred(self, p, key, lr, hv, wv, hhv, wwv,
                                        rows, cols, window=True)
                return (JM.psnr_masked(pred, hr, hhv, wwv),
                        JM.ssim_masked(pred, hr, hhv, wwv),
                        JM.lr_psnr_masked(pred, hr, mh, mw, hlv, wlv))
            self._jit[key] = jax.jit(f)
        return self._jit[key]


def _pair(arch, overrides, scale, lr_hw, seed):
    ov = TINY + [f"model.arch={arch}"] + overrides
    jtask = jloop.build_task(jload_config(None, ov))
    rng = np.random.default_rng(seed)
    lr = _img(rng, *lr_hw)
    hr_hw = tuple(int(round(n * scale)) for n in lr_hw)
    hr = _img(rng, *hr_hw)
    params = jtask.net.init(jax.random.PRNGKey(seed), jnp.asarray(lr), hr_hw)
    task = loop.build_task(load_config(None, ov), device="cpu")
    task.net.load_state_dict(state_dict_from_jax(_flatten(params["params"])),
                             strict=True)
    return jtask, params, task, lr, hr


@pytest.mark.parametrize("arch,overrides,scale,kind", [
    ("diinn", ["model.use_fused=false"], 2.5, "traced"),
    ("diinn", ["model.use_fused=true"], 2.5, "traced"),
    ("diinn", ["model.use_fused=true", "model.dtype=bfloat16"], 2.5,
     "traced"),
    ("diinn", ["model.use_fused=true"], 2.0, "kernel"),
    ("diinn", ["model.use_fused=true", "model.dtype=bfloat16"], 2.0,
     "kernel"),
    ("liif", [], 2.0, "liif"),
    ("liif", [], 2.5, "liif"),
    ("metasr", [], 2.0, "metasr"),
    ("metasr", [], 2.5, "metasr"),
])
def test_bucketed_eval_matches_jax(arch, overrides, scale, kind):
    hid = "[32,32,32]" if arch != "metasr" else "[32,32]"
    jtask, params, task, lr, hr = _pair(
        arch, overrides + [f"model.hidden_dims={hid}"], scale, (21, 17), 3)
    # in bf16 the port's fused traced route is JAX's window kernel's
    window = kind == "traced" and "model.dtype=bfloat16" in overrides
    jcls = JaxWindowBucketedEval if window else jb.BucketedEval
    want = jcls(jtask, quantum=32).metrics(params, lr, hr, scale)
    ev = tb.BucketedEval(task, quantum=32)
    got = ev.test_fn(scale, lr.shape, hr.shape)(lr, hr)
    assert [k[0] for k in ev._programs] == [kind]
    for g, w, name in zip(got, want, ("psnr", "ssim", "lr_psnr")):
        assert abs(g - float(w)) <= METRIC_TOL, (name, g, float(w))
    # a second, smaller image of the same bucket: the same program
    rng = np.random.default_rng(5)
    lr2 = _img(rng, 19, 16)
    hr2 = _img(rng, *(int(round(n * scale)) for n in (19, 16)))
    got2 = ev.metrics(lr2, hr2, scale)
    want2 = jcls(jtask, quantum=32).metrics(params, lr2, hr2, scale)
    assert ev.n_programs == 1
    for g, w in zip(got2, want2):
        assert abs(g - float(w)) <= METRIC_TOL


@pytest.mark.parametrize("route", ["eager", "fused"])
def test_bucketed_traced_bf16_prediction_matches_jax(route):
    """The bf16 traced program's prediction inside the true extent against
    JAX's (eager: JAX's ``decode_traced``; fused: its window kernel) at
    ``tests/test_torch_bf16.py``'s bounds for the route: the tolerance, and
    the port's gap at most 1/5 of JAX's own bf16-against-fp32 gap."""
    from tests.test_torch_bf16 import BF16, DIINN_ATOL, check
    ov = [f"model.use_fused={str(route == 'fused').lower()}",
          "model.hidden_dims=[32,32,32]"]
    scale, (h, w) = 2.5, (21, 17)
    jtasks = {None: _pair("diinn", ov, scale, (h, w), 3)[0]}
    jtasks[BF16], params, task, lr, hr = _pair(
        "diinn", ov + ["model.dtype=bfloat16"], scale, (h, w), 3)
    hh, ww = hr.shape[1:3]
    ev = tb.BucketedEval(task, quantum=32)
    key, x = ev._inputs(lr, hr, scale)
    assert key[0] == "traced"
    with torch.inference_mode():
        got = ev._predict(key, {k: torch.from_numpy(a) for k, a in x.items()})
    assert got.dtype == torch.bfloat16
    _, h_pad, w_pad, hh_pad, ww_pad = key
    # JAX's inputs, its index vectors padded with 0
    rows = tb._pad_to(jgrids.nearest_exact_indices(h, hh), (hh_pad,))
    cols = tb._pad_to(jgrids.nearest_exact_indices(w, ww), (ww_pad,))
    want = {}
    for dt, jt in jtasks.items():
        jev = jb.BucketedEval(jt, quantum=32)
        fn = jax.jit(lambda p, lr_, r, c: _jax_traced_pred(
            jev, p, key, lr_, jnp.int32(h), jnp.int32(w), jnp.int32(hh),
            jnp.int32(ww), r, c, window=route == "fused"))
        want[dt] = np.asarray(fn(params["params"], x["lr"], rows, cols)
                              .astype(jnp.float32))[:, :hh, :ww]
    check(got[:, :hh, :ww], want[BF16], want[None], DIINN_ATOL[route],
          f"bucketed {route} bf16 prediction")


def test_bucketed_mode4_is_unsupported():
    task = loop.build_task(load_config(
        None, TINY + ["model.mode=4", "model.hidden_dims=[32,32]"]),
        device="cpu")
    with pytest.raises(tb.BucketedUnsupported, match="mode 4"):
        tb.BucketedEval(task)


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

ARGS = ["--testsets", "Set5", "--max_images", "2", "--scales", "3.14", "4"]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bucketed") / "tiny.npz")
    _write_tiny_npz(path)
    return path


@pytest.fixture(scope="module")
def port_exact(tiny_ckpt):
    return tcli.main(["--ckpt_path", tiny_ckpt, "--eval_buckets", "0",
                      "--device", "cpu"] + ARGS)["Set5"]


@pytest.mark.parametrize("quantum", ["32", "0"])
def test_benchmarks_cli_buckets_match_jax(tiny_ckpt, port_exact, quantum,
                                          monkeypatch, capsys):
    monkeypatch.setenv("TPU_DIINN_COMPILE_CACHE", "0")
    want = jcli.main(["--ckpt_path", tiny_ckpt, "--eval_buckets",
                      quantum] + ARGS)["Set5"]
    jout = capsys.readouterr().out
    got = tcli.main(["--ckpt_path", tiny_ckpt, "--eval_buckets", quantum,
                     "--device", "cpu"] + ARGS)["Set5"]
    out = capsys.readouterr().out
    # the same programs as JAX's: x3.14 traced, x4 on the kernel route
    n_jax = re.findall(r"\[bucketed eval: (\d+) compiled programs", jout)
    n_port = re.findall(r"\[bucketed eval: (\d+) programs", out)
    assert n_port == n_jax == ([] if quantum == "0" else ["2"])
    assert set(got) == set(want) and len(got) == 6
    for key, w in want.items():
        assert abs(got[key] - w) <= METRIC_TOL, (key, got[key], w)
        assert abs(got[key] - port_exact[key]) <= METRIC_TOL, key
    if quantum == "0":
        assert got == port_exact


# ---------------------------------------------------------------------------
# oracle generator (python -m tests.test_torch_bucketed --oracle-bf16 PATH)
# ---------------------------------------------------------------------------

def bf16_bucketed_oracle(out_path: Path) -> dict:
    """``chip_smoke.py`` phase 10b's oracle: Set5 at {3.14, 4, 8} of the
    flagship weights in ``model.dtype=bfloat16`` through JAX's benchmark
    CLI on its fused route (``model.use_fused=true``, the Pallas kernels
    in interpret mode), bucketed (the CLI's default, quantum 64) and per
    exact shape (``--eval_buckets 0``); written after each route."""
    ov = ["model.dtype=bfloat16", "model.use_fused=true"]
    out = {"weights": "results/flagship_weights.npz", "dtype": "bfloat16",
           "platform": "JAX on the CPU", "overrides": ov,
           "routes": {"bucketed": "--eval_buckets 64 (the default)",
                      "bucketed_window": "--eval_buckets 64 with the traced "
                      "programs decoded by the window kernel "
                      "(JaxWindowBucketedEval): the port's route",
                      "exact": "--eval_buckets 0"}, "set5": {},
           "seconds": {}}
    base = jb.BucketedEval
    for route, q in (("bucketed", "64"), ("bucketed_window", "64"),
                     ("exact", "0")):
        t0 = time.time()
        jb.BucketedEval = (JaxWindowBucketedEval
                           if route == "bucketed_window" else base)
        try:
            m = jcli.main([*ov, "--ckpt_path", str(REPO / out["weights"]),
                           "--root", str(REPO / "data"), "--eval_buckets",
                           q, "--testsets", "Set5"])
        finally:
            jb.BucketedEval = base
        out["set5"][route] = m["Set5"]
        out["seconds"][route] = time.time() - t0
        out_path.write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--oracle-bf16"] and len(sys.argv) == 3:
        print(json.dumps(bf16_bucketed_oracle(Path(sys.argv[2])), indent=1))
    else:
        sys.exit("usage: python -m tests.test_torch_bucketed --oracle-bf16 "
                 "PATH")
