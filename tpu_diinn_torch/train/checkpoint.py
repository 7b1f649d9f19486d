"""Weights: the compact ``.npz`` export, the JAX <-> PyTorch bridge, and
the trainer's best/last checkpoints.

Counterpart of ``load_params_npz`` and ``CheckpointManager`` in
``tpu_diinn/train/checkpoint.py``. The export holds flat ``a/b/c``
parameter paths, float arrays either raw or stored as the uint16 bit
patterns of bf16 under a ``bf16:`` prefix, and a ``__meta__`` JSON string
with step, epoch, val_loss and the training config. bf16 widens to fp32
exactly by shifting its bits into the high half of a float32, so no bf16
dtype package is needed. The trainer writes its checkpoints in this
format, fp32 and raw: ``best.npz`` and ``last.npz`` hold the parameters
alone (the JAX package's ``load_params_npz`` reads every key of an export
as a parameter), and ``last.train_state.npz`` beside ``last`` what
resuming needs besides them: Adam's ``exp_avg``, ``exp_avg_sq`` and
``step`` per parameter under ``<name>:<flax path>`` keys (the moments in
the flax layout, as the parameters), and in its ``__meta__`` the global
step, the epoch and the schedule's position. Resume reads ``last`` only,
so ``best`` has no training state. Both files of ``last`` are written
atomically, and the step in the two metas must agree (a pair from two
saves is refused).
The JAX package's orbax directories have no counterpart.
``export_params_npz`` turns a checkpoint of the trainer into the compact,
committable export (``results/*_weights.npz``): every float array stored
as bf16 bits, rounded in numpy as ``ml_dtypes`` rounds, and the file
compressed.

``state_dict_from_jax`` maps the flax parameter paths onto the port's
module names: ``params/<module path>/conv/kernel`` (HWIO) becomes
``<module.path>.conv.weight`` (OIHW), ``.../dense/kernel`` (in, out)
becomes ``.../dense.weight`` (out, in), biases are copied;
``jax_from_state_dict`` is its inverse. ``seeded_params`` draws a
net's weights from a numpy seed, so that the JAX package and the port can
compute on the same weights without committing them.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_BF16 = "bf16:"


def f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """Round float values to bf16, to nearest with ties to even, as their
    uint16 bit patterns: ``a.astype(ml_dtypes.bfloat16).view(np.uint16)``
    bit for bit (wider floats are narrowed to float32 first, as there;
    subnormals round like any other value, +-0 and +-inf stay as they
    are, values past the largest bf16 round to inf, and every NaN becomes
    the quiet NaN of its sign, 0x7fc0 or 0xffc0)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    u = a.view(np.uint32)
    # adding 0x7fff, plus the kept half's lowest bit, carries into the kept
    # half exactly when the dropped half is above the tie, or at it with
    # the kept half odd
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    out = ((u + bias) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(a)
    out[nan] = np.where(np.signbit(a[nan]), 0xFFC0, 0x7FC0)
    return out


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
        if not (leaf == "bias" or (leaf == "kernel" and a.ndim in (2, 4))):
            raise KeyError(f"unexpected parameter {key!r}")
        name = ".".join(mods + ["weight" if leaf == "kernel" else "bias"])
        if leaf == "kernel":
            a = _from_flax(a)
        out[name] = torch.from_numpy(np.array(a, order="C", copy=True))
    return out


def _flax_key(name: str) -> str:
    """The flax parameter path (``params/...``) of a state-dict name."""
    *mods, leaf = name.split(".")
    if leaf not in ("weight", "bias"):
        raise KeyError(f"unexpected parameter {name!r}")
    return "/".join(["params", *mods,
                     "kernel" if leaf == "weight" else "bias"])


def _to_flax(a: np.ndarray) -> np.ndarray:
    """A parameter-shaped array from the PyTorch layout to flax's."""
    if a.ndim == 4:                                 # conv OIHW -> HWIO
        a = a.transpose(2, 3, 1, 0)
    elif a.ndim == 2:                               # dense (out,in)->(in,out)
        a = a.T
    return np.ascontiguousarray(a)


def _from_flax(a: np.ndarray) -> np.ndarray:
    """The inverse of ``_to_flax``."""
    if a.ndim == 4:                                 # conv HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:                                 # dense (in,out)->(out,in)
        return a.T
    return a


def jax_from_state_dict(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """PyTorch state-dict entries -> flax parameter paths (``params/...``,
    fp32 numpy): the inverse of ``state_dict_from_jax``."""
    return {_flax_key(name): _to_flax(t.detach().to("cpu",
                                                    torch.float32).numpy())
            for name, t in state.items()}


def seeded_params(net: torch.nn.Module, seed: int
                  ) -> Dict[str, np.ndarray]:
    """Flat ``params/...`` float32 weights for ``net``'s parameters, drawn
    from ``np.random.default_rng(seed)`` in sorted flax-path order, each
    kernel and bias uniform in +-1/sqrt(fan_in) of its layer (the torch
    default's range; fan_in = kh*kw*cin of an HWIO kernel, cin of a dense
    one)."""
    shapes = {k: v.shape for k, v in
              jax_from_state_dict(net.state_dict()).items()}
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        kernel = shapes[key.rsplit("/", 1)[0] + "/kernel"]
        bound = 1.0 / np.sqrt(np.prod(kernel[:-1]))
        out[key] = rng.uniform(-bound, bound, shapes[key]).astype(
            np.float32)
    return out


def _save_npz(path: Path, meta: dict, arrays: dict) -> None:
    """``arrays`` and ``meta`` as an npz, atomically (a temporary file,
    then a rename)."""
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, __meta__=np.str_(json.dumps(meta)), **arrays)
    os.replace(tmp, path)


def save_params_npz(path, net: torch.nn.Module, meta: dict) -> None:
    """Write ``net``'s parameters (fp32, raw) and ``meta`` as a compact
    export, atomically."""
    _save_npz(Path(path), meta, jax_from_state_dict(net.state_dict()))


ADAM_KEYS = ("exp_avg", "exp_avg_sq", "step")
TRAIN_STATE = ".train_state.npz"


def optimizer_arrays(net: torch.nn.Module, optimizer: torch.optim.Adam
                     ) -> Dict[str, np.ndarray]:
    """Adam's state of each of ``net``'s parameters as float32 arrays
    under ``<exp_avg|exp_avg_sq|step>:<flax path>`` (a parameter Adam has
    not updated yet has none)."""
    out = {}
    for name, p in net.named_parameters():
        st = optimizer.state.get(p)
        if not st:
            continue
        key = _flax_key(name)
        for k in ADAM_KEYS:
            a = st[k].detach().to("cpu", torch.float32).numpy()
            out[f"{k}:{key}"] = _to_flax(a) if k != "step" else a
    return out


def load_optimizer_arrays(net: torch.nn.Module, optimizer: torch.optim.Adam,
                          arrays: Dict[str, np.ndarray]) -> None:
    """Put ``optimizer_arrays``' output back into ``optimizer`` (built over
    ``net.parameters()``), through ``Adam.load_state_dict``."""
    names = {_flax_key(n): p for n, p in net.named_parameters()}
    stray = {k.split(":", 1)[1] for k in arrays} - set(names)
    if stray:
        raise KeyError(f"optimizer state for unknown parameters "
                       f"{sorted(stray)}")
    sd = optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    state = {}
    for key, p in names.items():
        if f"step:{key}" not in arrays:
            continue
        st = {}
        for k in ADAM_KEYS:
            a = np.asarray(arrays[f"{k}:{key}"], np.float32)
            st[k] = (torch.tensor(float(a), dtype=torch.float32)
                     if k == "step" else
                     torch.from_numpy(np.ascontiguousarray(_from_flax(a))))
        state[index[id(p)]] = st
    sd["state"] = state
    optimizer.load_state_dict(sd)


class CheckpointManager:
    """``last`` after every validation, ``best`` when val_loss improves
    (the reference's ModelCheckpoint: monitor val/loss, save_top_k=1,
    save_last), each as ``<tag>.npz`` (parameters); when the trainer
    passes its optimizer, ``last.train_state.npz`` beside ``last``."""

    def __init__(self, directory: str):
        self.dir = Path(directory).absolute()
        self.best_loss = np.inf
        best = self.dir / "best.npz"
        if best.exists():
            self.best_loss = load_params_npz(str(best))[1]["val_loss"]

    def save(self, net: torch.nn.Module, *, step: int, val_loss: float,
             config: dict, epoch: int = -1,
             optimizer: Optional[torch.optim.Adam] = None,
             scheduler=None) -> None:
        """Write ``last`` (and ``best`` if ``val_loss`` improved); with
        ``optimizer`` (and its ``scheduler``) also their training state
        beside ``last``."""
        self.dir.mkdir(parents=True, exist_ok=True)
        meta = {"step": int(step), "epoch": int(epoch),
                "val_loss": float(val_loss), "config": config}
        save_params_npz(self.dir / "last.npz", net, meta)
        if optimizer is not None:
            _save_npz(self.dir / f"last{TRAIN_STATE}",
                      {"step": int(step), "epoch": int(epoch),
                       "scheduler_last_epoch": int(scheduler.last_epoch)},
                      optimizer_arrays(net, optimizer))
        if val_loss < self.best_loss:
            self.best_loss = float(val_loss)
            save_params_npz(self.dir / "best.npz", net, meta)

    def restore(self) -> Tuple[Dict[str, np.ndarray], dict, dict, dict]:
        """(flat params, their meta, Adam's arrays, the training state's
        meta) of ``last``. Raises ``FileNotFoundError`` naming the path if
        either file is missing, and ``ValueError`` if their steps
        differ."""
        path = self.dir / f"last{TRAIN_STATE}"
        if not path.exists():
            raise FileNotFoundError(
                f"{path}: no training state to resume from (a checkpoint "
                f"directory of the port's trainer holds last.npz and "
                f"last{TRAIN_STATE})")
        flat, meta = load_params_npz(str(self.dir / "last.npz"))
        arrays, state_meta = load_params_npz(str(path))
        if state_meta["step"] != meta["step"]:
            raise ValueError(f"{self.dir}: last.npz is at step "
                             f"{meta['step']}, last{TRAIN_STATE} at step "
                             f"{state_meta['step']}")
        return flat, meta, arrays, state_meta


def load_params(ckpt_path: str, tag: str = "best"
                ) -> Tuple[Dict[str, np.ndarray], dict]:
    """(flat params, meta) from a ``.npz`` export, a checkpoint directory
    (its ``<tag>.npz``: ``best`` or ``last``), or a checkpoint's
    ``best``/``last`` named without its suffix; as
    ``tpu_diinn/train/checkpoint.load_params``."""
    p = Path(ckpt_path)
    if p.suffix == ".npz":
        return load_params_npz(str(p))
    if p.is_dir():
        return load_params_npz(str(p / f"{tag}.npz"))
    return load_params_npz(str(p.with_name(p.name + ".npz")))


def export_params_npz(ckpt_path: str, out_path: str,
                      tag: str = "best") -> dict:
    """Write the parameters of checkpoint ``ckpt_path`` (anything
    ``load_params`` reads; ``tag`` picks ``best`` or ``last`` of a
    directory) to ``out_path`` as the compact export: each float array as
    the uint16 bits of its bf16 rounding under ``bf16:<path>``, any other
    array raw, and ``__meta__`` with the checkpoint's step, epoch,
    val_loss and config, by ``np.savez_compressed``. Returns that meta.
    ``tpu_diinn.train.checkpoint.load_params`` reads the file."""
    flat, meta = load_params(ckpt_path, tag)
    payload = {}
    for key, arr in flat.items():
        if np.issubdtype(arr.dtype, np.floating):
            payload[_BF16 + key] = f32_to_bf16_bits(arr)
        else:
            payload[key] = arr
    slim = {k: meta[k] for k in ("step", "epoch", "val_loss", "config")
            if k in meta}
    np.savez_compressed(out_path, __meta__=np.str_(json.dumps(slim)),
                        **payload)
    return slim
