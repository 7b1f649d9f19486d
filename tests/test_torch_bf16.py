"""Port parity in the bf16 mode (``model.dtype=bfloat16``): the port
against the JAX package's bf16 mode on the same seeded numpy inputs.

JAX's bf16 mode computes every conv and dense layer in bf16 over float32
parameters (flax ``promote_dtype``), builds the synthesis grid in bf16,
and runs its Pallas decoder kernels with bf16 weights and fp32 biases
(here in interpret mode, as the JAX package's own tests run them). The
port names each rounding point (``nn/layers.py``, ``core/grids.py``,
``kernels/decoder_fused.py``'s plain versions).

Every case holds two bounds:

- a tolerance on the port's gap to JAX bf16, stated per case: where both
  sides round at the same points the gap is what a different fp32 sum
  order moves, across a bf16 rounding of an intermediate now and then;
- the ratio bound: the port's gap (RMS) is at most 1/5 of JAX's own
  bf16-against-fp32 gap (RMS) on the same inputs (the fp32 side takes the
  bf16 inputs widened, so its gap is the bf16 mode's rounding alone). A
  port that computed in fp32, or rounded at other points, fails it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.core import grids as jgrids
from tpu_diinn.kernels import decoder_fused as jk
from tpu_diinn.nn import layers as jlayers
from tpu_diinn.nn.diinn import DIINN as JDIINN
from tpu_diinn_torch.core import grids as tgrids
from tpu_diinn_torch.kernels import decoder_fused as tk
from tpu_diinn_torch.nn import layers as tlayers
from tpu_diinn_torch.nn.diinn import DIINN
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import state_dict_from_jax
from tests.test_torch_train import (TINY, _flatten, _tiny_batches,
                                    jax_train_oracle, port_train)

BF16 = jnp.bfloat16
RATIO = 0.2


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if not isinstance(
        x, np.ndarray) else x, dtype=np.float64)


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((_f64(a) - _f64(b)) ** 2)))


def check(got, want16, want32, atol, what):
    """``got`` (the port, bf16 mode) against JAX bf16 ``want16`` within
    ``atol``, and the ratio bound against JAX fp32 ``want32``."""
    got, want16, want32 = _f64(got), _f64(want16), _f64(want32)
    assert got.shape == want16.shape == want32.shape, what
    port_gap, jax_gap = _rms(got, want16), _rms(want16, want32)
    # (a quantity that no bf16 rounding reaches, the bias gradient dbl =
    # sum(g), has no gap to compare with: the tolerance alone holds it)
    assert jax_gap > 0 or what.endswith("dbl"), f"{what}: no bf16 gap"
    assert port_gap <= RATIO * jax_gap or jax_gap == 0, (
        f"{what}: port gap {port_gap} > {RATIO} x JAX bf16-fp32 gap "
        f"{jax_gap}")
    err = np.abs(got - want16).max()
    assert err <= atol, f"{what}: max abs error {err} > {atol}"


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as float32."""
    return np.asarray(jnp.asarray(a, BF16).astype(jnp.float32))


def _ulp(x) -> float:
    """One bf16 ulp at the largest magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(np.abs(_f64(x)).max())) - 7)


# ---------------------------------------------------------------------------
# (a) layers and the synthesis grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,cin,cout", [(3, 5, 16), (1, 24, 8)])
def test_conv_bf16_matches_flax(k, cin, cout):
    """Tolerance: one bf16 ulp of the output's largest magnitude (the two
    sides sum the conv in different fp32 orders and round the sum)."""
    rng = np.random.default_rng(k * 100 + cin)
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    mods = {dt: jlayers.Conv(cout, k, dtype=dt) for dt in (BF16, None)}
    params = mods[None].init(jax.random.PRNGKey(k), jnp.asarray(x))
    want = {dt: m.apply(params, jnp.asarray(x)) for dt, m in mods.items()}
    assert want[BF16].dtype == BF16
    conv = tlayers.Conv(cin, cout, k, dtype=torch.bfloat16)
    p = params["params"]["conv"]
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()))
        conv.conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16 and conv.conv.weight.dtype == \
        torch.float32
    check(got.permute(0, 2, 3, 1), want[BF16], want[None],
          _ulp(want[BF16]), f"conv k{k}")


def test_dense_bf16_matches_flax():
    """Tolerance: one bf16 ulp of the output's largest magnitude."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    mods = {dt: jlayers.Dense(24, dtype=dt) for dt in (BF16, None)}
    params = mods[None].init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = {dt: m.apply(params, jnp.asarray(x)) for dt, m in mods.items()}
    dense = tlayers.Dense(40, 24, dtype=torch.bfloat16)
    p = params["params"]["dense"]
    with torch.no_grad():
        dense.dense.weight.copy_(torch.from_numpy(
            np.asarray(p["kernel"]).T.copy()))
        dense.dense.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
        got = dense(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    check(got, want[BF16], want[None], _ulp(want[BF16]), "dense")


@pytest.mark.parametrize("in_size,out_size", [
    ((48, 48), (120, 120)), ((48, 48), (192, 192)), ((82, 82), (256, 256)),
    ((102, 153), (408, 612)), ((6, 7), (19, 23))])
def test_syn_grid_bf16_matches_jax(in_size, out_size):
    """Tolerance: 0 (the same bf16 operations in the same order)."""
    want = {dt: jgrids.syn_input_grid(in_size, out_size, dtype=dt)
            for dt in (BF16, jnp.float32)}
    got = tgrids.syn_input_grid(in_size, out_size, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    check(got, want[BF16], want[jnp.float32], 0.0, "syn grid")


# ---------------------------------------------------------------------------
# (b) the plain bf16 dispatchers against the Pallas kernels
# ---------------------------------------------------------------------------

HIDDEN, LAYERS = 32, 4
WEIGHTS = ("w0", "wkq", "wq", "wl")


def _inputs(b, h_in, w_in, seed):
    """bf16-valued z and weights (float32 arrays), fp32 biases."""
    rng = np.random.default_rng(seed)
    h, n = HIDDEN, LAYERS
    p = {"w0": rng.uniform(-1, 1, (3, h)),
         "b0": rng.uniform(-1, 1, (h,)),
         "wkq": rng.uniform(-1, 1, (n - 1, h, h)) / np.sqrt(h),
         "bkq": rng.uniform(-1, 1, (n - 1, h)) / np.sqrt(h),
         "wq": rng.uniform(-1, 1, (n - 1, h, h)) / np.sqrt(h),
         "bq": rng.uniform(-1, 1, (n - 1, h)) / np.sqrt(h),
         "wl": rng.uniform(-1, 1, (h, 3)) / np.sqrt(h),
         "bl": rng.uniform(-1, 1, (3,))}
    p = {k: (_bf16(v) if k in WEIGHTS else v.astype(np.float32))
         for k, v in p.items()}
    z = _bf16(rng.standard_normal((b, h_in, w_in, n * h)))
    return z, p


def _jax_params(p, dtype):
    return {k: jnp.asarray(v, dtype if k in WEIGHTS else jnp.float32)
            for k, v in p.items()}


def _port_params(p, dtype):
    t = {"w0": p["w0"], "b0": p["b0"],
         "wcat": np.concatenate([p["wkq"], p["wq"]], axis=2),
         "bcat": np.concatenate([p["bkq"], p["bq"]], axis=1),
         "wl": p["wl"], "bl": p["bl"]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        dtype if k in tk.WEIGHT_KEYS else torch.float32)
        for k, v in t.items()}


def _jax_decode(z, syn, out_size, p, g, dtype):
    """JAX decode_fused (interpret mode) and its VJP in ``dtype``."""
    zj = jnp.asarray(z, dtype)
    synj = jnp.asarray(syn)

    def f(zz, pp):
        return jk.decode_fused(zz, synj, out_size, pp, interpret=True)

    out, vjp = jax.vjp(f, zj, _jax_params(p, dtype))
    dz, dp = vjp(jnp.asarray(g))
    return out, dz, dp


# forward and dz: the outputs are O(1) and a q element that rounds to the
# other bf16 neighbour moves them by up to a few 1e-3; weight gradients
# (sums over every query) by up to a few 1e-2 of their O(1..10) magnitude
FWD_ATOL, DZ_ATOL, GRAD_RTOL = 2e-2, 2e-2, 1e-2


@pytest.mark.parametrize("route", ["int2", "int3", "window2.5", "window3.14"])
def test_plain_bf16_dispatchers_match_pallas(route):
    b, h_in, w_in = 2, 5, 6
    z, p = _inputs(b, h_in, w_in, seed=len(route) * 7 + int(route[-1]))
    ratio = float(route[3:] if route.startswith("int") else route[6:])
    out_size = (round(h_in * ratio), round(w_in * ratio))
    syn = np.asarray(jgrids.syn_input_grid((h_in, w_in), out_size,
                                           dtype=BF16).astype(jnp.float32))
    g = np.random.default_rng(3).standard_normal(
        (b, *out_size, 3)).astype(np.float32)
    want16 = _jax_decode(z, syn, out_size, p, g, BF16)
    want32 = _jax_decode(z, syn, out_size, p, g, jnp.float32)

    zt = torch.from_numpy(z).to(torch.bfloat16)
    synt, gt = torch.from_numpy(syn), torch.from_numpy(g)
    tp = _port_params(p, torch.bfloat16)
    if route.startswith("int"):
        s = int(ratio)
        out = tk.decode_int_fwd_ref(zt, synt, s, s, tp)
        dz, grads = tk.decode_int_bwd_ref(zt, synt, s, s, tp, gt)
        disp = tk.decode_int_fwd(zt, synt, s, s, tp)
        kw = dict(ratio=(s, s))
    else:
        rows = tk.index_vector(jgrids.nearest_exact_indices(h_in, out_size[0]),
                               h_in, "cpu")
        cols = tk.index_vector(jgrids.nearest_exact_indices(w_in, out_size[1]),
                               w_in, "cpu")
        out = tk.decode_window_fwd_ref(zt, synt, rows, cols, tp)
        dz, grads = tk.decode_window_bwd_ref(zt, synt, rows, cols, tp, gt)
        disp = tk.decode_window_fwd(zt, synt, rows, cols, tp)
        kw = dict(rows=rows, cols=cols)
    assert out.dtype == torch.float32 and dz.dtype == torch.bfloat16
    assert torch.equal(disp, out)       # the CPU branch is the plain one
    check(out, want16[0], want32[0], FWD_ATOL, f"{route} out")
    check(dz, want16[1], want32[1], DZ_ATOL, f"{route} dz")
    h = HIDDEN
    port_grads = {"w0": grads["w0"], "b0": grads["b0"],
                  "wkq": grads["wcat"][:, :, :h], "wq": grads["wcat"][:, :, h:],
                  "bq": grads["bcat"][:, h:], "wl": grads["wl"],
                  "bl": grads["bl"]}
    assert not grads["bcat"][:, :h].any()
    for k, got in port_grads.items():
        assert got.dtype == torch.float32, k
        scale = float(np.abs(_f64(want16[2][k])).max())
        check(got, want16[2][k], want32[2][k], GRAD_RTOL * scale,
              f"{route} d{k}")

    # the autograd node: float32 parameters in, cast inside, float32
    # gradients out (unrounded), bf16 dz
    p32 = {k: v.float().requires_grad_() for k, v in tp.items()}
    z_in = zt.clone().requires_grad_()
    y = tk.decode(z_in, synt, p32, **kw)
    torch.testing.assert_close(y, out, rtol=0, atol=0)
    y.backward(gt)
    assert z_in.grad.dtype == torch.bfloat16
    torch.testing.assert_close(z_in.grad, dz, rtol=0, atol=0)
    for k in tk.PARAM_KEYS:
        assert p32[k].grad.dtype == torch.float32
        torch.testing.assert_close(p32[k].grad, grads[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (c) the tiny DIINN forward, fused and eager routes
# ---------------------------------------------------------------------------

def _tiny(dtype_j, use_fused):
    return JDIINN(mode=3, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                  use_fused=use_fused, dtype=dtype_j)


# the eager route: XLA keeps excess precision between fused elementwise ops
# on the CPU, so its bf16 roundings are not all the port's; held at the
# ratio bound and a looser tolerance
DIINN_ATOL = {"fused": 3e-2, "eager": 6e-2}


@pytest.mark.parametrize("route,lr_hw,out_hw,bsize", [
    ("fused", (6, 7), (12, 14), None),         # x2, whole grid
    ("fused", (5, 6), (20, 24), 60),           # x4, the int-eval route
    ("fused", (7, 9), (22, 28), 60),           # x3.14, chunked windows
    ("eager", (6, 7), (12, 14), None),
    ("eager", (7, 9), (22, 28), 60),
])
def test_tiny_diinn_bf16_forward(route, lr_hw, out_hw, bsize):
    jax_fused = True if route == "fused" else False
    jnets = {dt: _tiny(dt, jax_fused) for dt in (BF16, None)}
    x0 = jnp.zeros((1, *lr_hw, 3), jnp.float32)
    params = jnets[None].init(jax.random.PRNGKey(0), x0, out_hw)
    x = np.random.default_rng(11).uniform(
        -1, 1, (2, *lr_hw, 3)).astype(np.float32)
    want = {dt: n.apply(params, jnp.asarray(x), out_hw, bsize)
            for dt, n in jnets.items()}
    assert want[BF16].dtype == BF16
    net = DIINN(mode=3, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4,
                use_fused=None if route == "fused" else False,
                dtype=torch.bfloat16)
    net.load_state_dict(state_dict_from_jax(_flatten(params)), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), out_hw, bsize)
    assert got.dtype == torch.bfloat16
    check(got, want[BF16], want[None], DIINN_ATOL[route],
          f"{route} {out_hw}")


# ---------------------------------------------------------------------------
# (d) three tiny bf16 train steps
# ---------------------------------------------------------------------------

# loss and grad norm relative to JAX bf16; params after three Adam steps
# (each moves a parameter by about lr = 1e-4) absolute. On the eager route
# JAX differentiates each bf16 bias add into a bf16 reduce_sum, which XLA
# on the CPU accumulates in bf16: its bias gradients are off by up to 18%
# of their norm at step 1 (last_dense's; 7e-2 to 1e-1 for the decoder's
# others), the port's (autograd sums in fp32) by under 1.5%, and the grad
# norm reads JAX's own error at every step (0.0893 against fp32's 0.1041 at
# step 1; the port 0.1044), as do the params Adam moves with it (the
# port's gap 3.4e-6, 0.23 of JAX's 1.45e-5). That case holds the grad norm
# and the params to the tolerance alone, the loss to both bounds.
# (three Adam steps that all take the other sign move a parameter by 6e-4)
STEP_RTOL = {"fused": 2e-2, "eager": 2e-1}
PARAM_ATOL = {"fused": 1e-4, "eager": 3e-4}


@pytest.mark.parametrize("route", ["fused", "eager"])
def test_tiny_train_steps_bf16(route):
    ov = TINY + ["data.train_scales=[2,3]"]
    batches = _tiny_batches((2, 3))
    flag = "true" if route == "fused" else "false"
    start, want16, params16 = jax_train_oracle(
        ov + ["model.dtype=bfloat16", f"model.use_fused={flag}"], batches, 3)
    _, want32, params32 = jax_train_oracle(
        ov + [f"model.use_fused={flag}"], batches, 3, params=start)
    got, got_params = port_train(
        ov + ["model.dtype=bfloat16", f"model.use_fused="
              f"{json.dumps(None if route == 'fused' else False)}"],
        batches, 3, start)
    for key in ("loss", "grad_norm"):
        g = [m[key] for m in got]
        w16, w32 = [m[key] for m in want16], [m[key] for m in want32]
        tol = STEP_RTOL[route] * max(map(abs, w16))
        if route == "eager" and key == "grad_norm":
            assert np.abs(np.subtract(g, w16)).max() <= tol, (g, w16)
            continue
        check(g, w16, w32, tol, f"{route} {key}")
    flat = lambda d: np.concatenate([np.ravel(d[k]) for k in sorted(d)])
    assert set(got_params) == set(params16)
    if route == "eager":
        err = np.abs(flat(got_params) - flat(params16)).max()
        assert err <= PARAM_ATOL[route], err
        return
    check(flat(got_params), flat(params16), flat(params32),
          PARAM_ATOL[route], f"{route} params")


def test_build_task_bf16_keeps_fp32_params_and_grads():
    from tpu_diinn_torch.config.config import load_config
    cfg = load_config(None, TINY + ["model.dtype=bfloat16"])
    state = loop.init_state(cfg, 10, device="cpu")
    net = state.task.net
    assert net.decoder.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    batch = loop.to_device(_tiny_batches((2, 3))[0], "cpu")
    m = loop.make_train_step(state)(batch)
    assert np.isfinite(float(m["loss"]))
    assert all(p.grad.dtype == torch.float32 for p in net.parameters())
    assert all(v.dtype == torch.float32
               for s in state.optimizer.state.values() for v in s.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0)


# ---------------------------------------------------------------------------
# (e) the CLIs with model.dtype=bfloat16, on the CPU
# ---------------------------------------------------------------------------

def test_cli_train_bf16_writes_a_checkpoint(tmp_path):
    from tpu_diinn_torch.cli import train as tcli
    from tpu_diinn_torch.train.checkpoint import load_params_npz
    state = tcli.main(["--device", "cpu", "--max-steps", "2",
                       "model.dtype=bfloat16", *TINY,
                       "data.num_workers=2", f"trainer.ckpt_dir={tmp_path}",
                       f"trainer.log_dir={tmp_path}"])
    assert state.step == 2
    assert state.task.net.decoder.dtype == torch.bfloat16
    flat, meta = load_params_npz(str(tmp_path / "last.npz"))
    assert meta["config"]["model"]["dtype"] == "bfloat16"
    assert np.isfinite(meta["val_loss"])
    assert all(v.dtype == np.float32 for v in flat.values())


# Set5 metrics (PSNR and LR-PSNR in dB, SSIM) of the bf16 benchmark CLI:
# the decoder's fused route on both sides (JAX: model.use_fused=true, the
# Pallas kernels in interpret mode; per exact shape, --eval_buckets 0)
BENCH_ATOL = {"psnr": 2e-2, "ssim": 2e-4}


def test_benchmarks_cli_bf16_matches_jax(tmp_path, monkeypatch):
    from tpu_diinn.cli import benchmarks as jcli
    from tpu_diinn_torch.cli import benchmarks as tcli
    from tests.test_torch_benchmarks import ARGS, _write_tiny_npz
    monkeypatch.setenv("TPU_DIINN_COMPILE_CACHE", "0")
    ckpt = str(tmp_path / "tiny.npz")
    _write_tiny_npz(ckpt)
    jargs = ["model.use_fused=true", "--ckpt_path", ckpt, "--eval_buckets",
             "0"] + ARGS
    want16 = jcli.main(["model.dtype=bfloat16"] + jargs)["Set5"]
    want32 = jcli.main(jargs)["Set5"]
    got = tcli.main(["model.dtype=bfloat16", "--ckpt_path", ckpt,
                     "--eval_buckets", "0", "--device", "cpu"] + ARGS)["Set5"]
    assert set(got) == set(want16) and len(got) == 6
    for kind in ("psnr", "ssim"):
        keys = [k for k in got if ("ssim" in k) == (kind == "ssim")]
        check([got[k] for k in keys], [want16[k] for k in keys],
              [want32[k] for k in keys], BENCH_ATOL[kind], f"Set5 {kind}")
