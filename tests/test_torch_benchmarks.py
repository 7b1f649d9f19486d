"""Port parity for the slice as a whole: the benchmark CLI.

A tiny DIINN's JAX-initialised params are written in the compact npz
format (``__meta__`` JSON + ``bf16:`` keys); the JAX CLI and the port's CLI
(``--device cpu``) then evaluate two Set5 images at x3.14 and x4, both on
their default route (bucketed static-shape eval, quantum 64). Every
metric must agree: PSNR and LR-PSNR within 1e-4 dB, SSIM within 1e-5
(fp32 summation order in the encoder, decoder and metric reductions).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_diinn.cli import benchmarks as jcli
from tpu_diinn.config.config import load_config, to_dict
from tpu_diinn.nn.diinn import DIINN as JDIINN
from tpu_diinn_torch.cli import benchmarks as tcli

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--testsets", "Set5", "--max_images", "2", "--scales", "3.14", "4"]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _write_tiny_npz(path):
    overrides = ["model.encoder=rdn-tiny", "model.hidden_dims=[32,32,32,32]"]
    cfg = load_config(None, overrides)
    net = JDIINN(mode=3, encoder_spec="rdn-tiny", hidden_dims=(32,) * 4)
    params = net.init(jax.random.PRNGKey(4),
                      jnp.zeros((1, 8, 8, 3), jnp.float32), (16, 16))
    payload = {"bf16:" + k: v.astype(ml_dtypes.bfloat16).view(np.uint16)
               for k, v in _flatten(params).items()}
    meta = {"step": 0, "epoch": 0, "val_loss": 0.0, "config": to_dict(cfg)}
    np.savez_compressed(path, __meta__=np.str_(json.dumps(meta)), **payload)


def test_benchmarks_cli_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DIINN_COMPILE_CACHE", "0")
    ckpt = str(tmp_path / "tiny.npz")
    _write_tiny_npz(ckpt)
    want = jcli.main(["--ckpt_path", ckpt] + ARGS)
    got = tcli.main(["--ckpt_path", ckpt, "--device", "cpu"] + ARGS)
    assert set(got) == set(want) == {"Set5"}
    assert set(got["Set5"]) == set(want["Set5"])
    assert len(got["Set5"]) == 6
    for key, w in want["Set5"].items():
        g = got["Set5"][key]
        tol = 1e-5 if "ssim" in key else 1e-4
        assert np.isfinite(g) and abs(g - w) <= tol, (key, g, w)


def test_port_imports_no_jax_pil_yaml():
    modules = [
        "tpu_diinn_torch.cli.benchmarks", "tpu_diinn_torch.kernels.build",
        "tpu_diinn_torch.kernels.decoder_fused", "tpu_diinn_torch.nn.diinn",
        "tpu_diinn_torch.data.datasets", "tpu_diinn_torch.train.loop",
        "tpu_diinn_torch.cli.train", "tpu_diinn_torch.train.optim",
        "tpu_diinn_torch.train.task", "tpu_diinn_torch.train.logging",
        "tpu_diinn_torch.train.checkpoint", "tpu_diinn_torch.data.pipeline",
        "tpu_diinn_torch.train.flops", "tpu_diinn_torch.bench",
        "tpu_diinn_torch.nn.registry", "tpu_diinn_torch.nn.edsr",
        "tpu_diinn_torch.nn.mlp", "tpu_diinn_torch.nn.liif",
        "tpu_diinn_torch.nn.metasr", "tpu_diinn_torch.nn.bicubic",
        "tpu_diinn_torch.compat.torch_loader", "tpu_diinn_torch.cli.demo",
        "tpu_diinn_torch.cli.runtime_bench", "tpu_diinn_torch.train.streaming",
        "tpu_diinn_torch.train.profiling", "tpu_diinn_torch.data.png",
        "tpu_diinn_torch.native.loader", "tpu_diinn_torch.parallel.mesh",
        "tpu_diinn_torch.parallel.sharding", "tpu_diinn_torch.parallel.launch",
        "tpu_diinn_torch.nn.masking", "tpu_diinn_torch.train.bucketed",
        "tpu_diinn_torch.tools.fwd_compare",
        "tpu_diinn_torch.tools.chain_split",
        "tests.torch_parallel_ranks", "chip_smoke"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules) +
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_dtypes', "
            "'yaml', 'PIL', 'tpu_diinn'))\n"
            "print(repr(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_cli_defaults_to_cuda_and_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--ckpt_path", str(tmp_path / "unused.npz")] + ARGS)
