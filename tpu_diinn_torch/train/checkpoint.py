"""Weights: the compact ``.npz`` export, the JAX <-> PyTorch bridge, and
the trainer's best/last checkpoints.

Counterpart of ``load_params_npz`` and ``CheckpointManager`` in
``tpu_diinn/train/checkpoint.py``. The export holds flat ``a/b/c``
parameter paths, float arrays either raw or stored as the uint16 bit
patterns of bf16 under a ``bf16:`` prefix, and a ``__meta__`` JSON string
with step, epoch, val_loss and the training config. bf16 widens to fp32
exactly by shifting its bits into the high half of a float32, so no bf16
dtype package is needed. The trainer writes its checkpoints in this
format, fp32 and raw (params only); orbax directories, and so resuming
with the optimizer state, are not ported yet (ROADMAP).

``state_dict_from_jax`` maps the flax parameter paths onto the port's
module names: ``params/<module path>/conv/kernel`` (HWIO) becomes
``<module.path>.conv.weight`` (OIHW), ``.../dense/kernel`` (in, out)
becomes ``.../dense.weight`` (out, in), biases are copied;
``jax_from_state_dict`` is its inverse.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

_BF16 = "bf16:"


def bf16_bits_to_f32(u: np.ndarray) -> np.ndarray:
    """Widen bf16 bit patterns (uint16) to float32, exactly."""
    u = np.ascontiguousarray(u, dtype=np.uint16)
    return (u.astype(np.uint32) << 16).view(np.float32)


def load_params_npz(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load a compact export as (flat {path: array}, meta). Float params
    come back float32 (bf16-rounded values); paths keep their ``params/``
    prefix."""
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {}
        for key in z.files:
            if key == "__meta__":
                continue
            if key.startswith(_BF16):
                flat[key[len(_BF16):]] = bf16_bits_to_f32(z[key])
            else:
                flat[key] = z[key]
    return flat, meta


def state_dict_from_jax(flat: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Flax parameter paths -> PyTorch state-dict entries (CPU tensors)."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        *mods, leaf = parts
        a = np.asarray(arr)
        if leaf == "kernel" and a.ndim == 4:        # conv HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:      # dense (in,out)->(out,in)
            a = a.T
        elif leaf != "bias":
            raise KeyError(f"unexpected parameter {key!r}")
        name = ".".join(mods + ["weight" if leaf == "kernel" else "bias"])
        out[name] = torch.from_numpy(np.array(a, order="C", copy=True))
    return out


def jax_from_state_dict(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """PyTorch state-dict entries -> flax parameter paths (``params/...``,
    fp32 numpy): the inverse of ``state_dict_from_jax``."""
    out = {}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and a.ndim == 4:        # conv OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 2:      # dense (out,in)->(in,out)
            a = a.T
        elif leaf != "bias":
            raise KeyError(f"unexpected parameter {name!r}")
        key = "/".join(["params", *mods,
                        "kernel" if leaf == "weight" else "bias"])
        out[key] = np.ascontiguousarray(a)
    return out


def save_params_npz(path, net: torch.nn.Module, meta: dict) -> None:
    """Write ``net``'s parameters (fp32, raw) and ``meta`` as a compact
    export, atomically (a temporary file, then a rename)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, __meta__=np.str_(json.dumps(meta)),
             **jax_from_state_dict(net.state_dict()))
    os.replace(tmp, path)


class CheckpointManager:
    """``last.npz`` after every validation, ``best.npz`` when val_loss
    improves (the reference's ModelCheckpoint: monitor val/loss,
    save_top_k=1, save_last)."""

    def __init__(self, directory: str):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.best_loss = np.inf
        best = self.dir / "best.npz"
        if best.exists():
            self.best_loss = load_params_npz(str(best))[1]["val_loss"]

    def save(self, net: torch.nn.Module, *, step: int, val_loss: float,
             config: dict, epoch: int = -1) -> None:
        meta = {"step": int(step), "epoch": int(epoch),
                "val_loss": float(val_loss), "config": config}
        save_params_npz(self.dir / "last.npz", net, meta)
        if val_loss < self.best_loss:
            self.best_loss = float(val_loss)
            save_params_npz(self.dir / "best.npz", net, meta)
