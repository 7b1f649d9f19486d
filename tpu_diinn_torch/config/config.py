"""Configuration: dataclass tree + dotted ``key=value`` overrides.

Counterpart of ``tpu_diinn/config/config.py`` with the same defaults, minus
YAML: the flagship's configuration travels as JSON inside the weights
export (``__meta__`` of the ``.npz``), so a config is built from defaults,
an optional nested dict and ``a.b.c=value`` overrides. Override values for
list/None fields are read as the JAX package's ``yaml.safe_load`` reads a
plain scalar or a flow list (YAML 1.1 booleans and nulls, integers, floats,
``[a, b]``), without PyYAML; any other string stays as it is.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class ModelConfig:
    arch: str = "diinn"             # diinn | liif | metasr | bicubic
    mode: int = 3                   # DIINN interaction mode
    init_q: bool = False
    encoder: str = "rdn"            # encoder spec (nn/registry.py)
    hidden_dims: Optional[List[int]] = None
    lr: float = 1e-4
    lr_gamma: float = 0.5
    lr_step: int = 10
    eval_bsize: int = 30000         # eval-time decode chunk bound (queries)
    dtype: str = "float32"          # compute dtype: float32 | bfloat16
    use_fused: Optional[bool] = None  # CUDA decoder kernels (None = auto)
    lane_pack: Optional[bool] = None  # TPU-only knob, ignored by the port


@dataclass
class DataConfig:
    root: str = "./data/"
    trainsets: List[Tuple[str, str]] = field(
        default_factory=lambda: [("DIV2K", "train")])
    trainsets_repeat: int = 20
    testsets: List[Tuple[str, str]] = field(default_factory=lambda: [
        ("DIV2K", "train"), ("benchmark", "B100"), ("benchmark", "Set5"),
        ("benchmark", "Set14"), ("benchmark", "Urban100")])
    batch_size: int = 4
    train_scales: List[float] = field(default_factory=lambda: [2, 3, 4])
    test_scales: List[float] = field(
        default_factory=lambda: [2, 2.5, 3, 3.5, 4, 6, 8, 10, 15, 20])
    patch_size: int = 48
    num_workers: int = 8            # sample worker processes (0: in-process)
    synthetic: bool = False


@dataclass
class TrainerConfig:
    max_epochs: int = 50
    check_val_every_n_epoch: int = 1
    log_every_n_steps: int = 50
    ckpt_dir: str = "./checkpoints"
    log_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    debug_nans: bool = False
    resume: Optional[str] = None
    limit_val_images: Optional[int] = None
    mesh_data: int = -1
    mesh_space: int = 1
    donate: bool = True


@dataclass
class Config:
    seed: int = 123
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


def _set_dotted(obj: Any, dotted: str, value: str) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    current = getattr(obj, name)
    setattr(obj, name, _coerce(value, current))


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (list, tuple)) or current is None:
        return _yaml_value(value)
    return value


# PyYAML's implicit resolvers (YAML 1.1) for the scalars an override holds.
_BOOL = {v: v.lower() in ("yes", "true", "on") for w in
         ("yes", "no", "true", "false", "on", "off")
         for v in (w, w.title(), w.upper())}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)"
                  r"|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")


def _yaml_value(text: str) -> Any:
    """``yaml.safe_load(text)`` for a plain scalar or a flow list of them;
    the text itself for anything else."""
    s = text.strip()
    if s.startswith("[") and s.endswith("]"):
        items = _split_flow(s[1:-1])
        if items is not None:
            return [_yaml_value(v) for v in items]
        return text
    return _yaml_scalar(s)


def _split_flow(body: str):
    """The top-level comma-separated items of a flow list's body (one
    trailing comma allowed), or None where YAML would refuse it."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
            if depth < 0:
                return None
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    if body[start:].strip():
        items.append(body[start:])
    if depth or quote or not all(v.strip() for v in items):
        return None
    return items


def _yaml_scalar(s: str) -> Any:
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.fullmatch(s):
        v = s.replace("_", "").lower()
        if v.endswith((".inf", ".nan")):
            return float(v.replace(".", ""))
        return float(v)
    return s


def _merge(dc: Any, tree: dict) -> None:
    for k, v in tree.items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key: {k}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge(cur, v)
        else:
            setattr(dc, k, v)


def load_config(tree: Optional[dict] = None,
                overrides: Optional[List[str]] = None) -> Config:
    """Build a Config from defaults + an optional nested dict (e.g. a
    checkpoint's embedded config) + ``a.b=c`` overrides, in that order."""
    cfg = Config()
    if tree:
        _merge(cfg, tree)
    for ov in overrides or []:
        ov = ov.lstrip("-")
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, _, val = ov.partition("=")
        _set_dotted(cfg, key, val)
    return cfg


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
