"""Port parity for ``key=value`` overrides: the port's ``load_config``
against the JAX package's, which reads list and None-default fields with
``yaml.safe_load``. The port has no PyYAML and keeps its own reader; the
two must give the same value, of the same type, for what users type."""

import math

import pytest
import torch

from tpu_diinn.config import config as jconfig
from tpu_diinn_torch.config import config as tconfig
from tpu_diinn_torch.train import loop

OVERRIDES = [
    "model.use_fused=False", "model.use_fused=no", "model.use_fused=false",
    "model.use_fused=true", "model.use_fused=True", "model.use_fused=ON",
    "model.use_fused=off", "model.use_fused=tRuE",
    "trainer.limit_val_images=~", "trainer.limit_val_images=null",
    "trainer.limit_val_images=", "trainer.limit_val_images=3",
    "trainer.limit_val_images=0x10", "trainer.limit_val_images=1_000",
    "trainer.profile_dir=runs/prof", "trainer.resume=last",
    "data.train_scales=[2,2.5]", "data.train_scales=[2, 3, 4]",
    "data.train_scales=[]", "data.test_scales=[1.5, .5, 1e5]",
    "model.hidden_dims=[32,32,32]", "model.hidden_dims=[32,",
    "data.testsets=[[benchmark, Set5], ['DIV2K', 'train']]",
    "model.lane_pack=1.0e+5", "model.lane_pack=.inf",
    "data.root=./elsewhere/", "model.encoder=rdn-tiny",
    "trainer.log_dir='quoted'",
]


def _get(cfg, dotted):
    obj = cfg
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _same(a, b) -> bool:
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("override", OVERRIDES)
def test_override_matches_jax(override):
    key = override.partition("=")[0]
    want = _get(jconfig.load_config(None, [override]), key)
    got = _get(tconfig.load_config(None, [override]), key)
    assert _same(got, want), (override, got, want)


@pytest.mark.parametrize("value,fused", [("False", False), ("no", False),
                                         ("off", False), ("~", True)])
def test_use_fused_false_takes_the_eager_route(value, fused):
    cfg = tconfig.load_config(None, [f"model.use_fused={value}",
                                     "model.encoder=rdn-tiny",
                                     "model.hidden_dims=[32,32,32]"])
    assert cfg.model.use_fused is (None if fused else False)
    net = loop.build_task(cfg, device="cpu").net
    feat = torch.zeros((1, 4, 4, 8))
    assert net.decoder._fused_ok(feat) is fused
