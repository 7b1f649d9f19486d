"""The benchmark's LIIF configuration on the CPU: the port's LIIF against
the plain reference (``perfbench/reference/liif.py``), the reference
against the published code's goldens, its parameter names, the port's
decode counters and spans, and the LIIF counts (``perfbench/
counts_liif.py``) against a hand count.

- ``SRTask.predict`` of a seeded LIIF over RDN-tiny (hidden 32, 32) against
  the reference's ``predict`` from the same weights (the driver's seeded
  draw), within 1e-6 absolute (the cell's limit; the two differ in layer
  0's sum order: a 3x3 conv at LR and two small dense layers against one
  580-wide product): x2 and x4 (the ties of integer scales), x3.14,
  10x13 -> 26x33, and a small ``bsize`` so that several chunks run.
- The reference's output and input gradient on ``tests/golden/
  liif_full.npz`` and ``liif_decode.npz`` at the tolerances that
  ``tests/test_torch_families_golden.py`` holds the port to.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import counts, counts_liif
from perfbench.drivers.upscale_family import make_weights
from perfbench.reference import liif as R
from perfbench.reference.precision import Rounding
from tests.test_model_parity import load_fixture
from tests.test_torch_families_golden import _load, check_golden
from tpu_diinn_torch.compat import torch_loader as tl
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.nn import liif
from tpu_diinn_torch.nn.liif import LIIF
from tpu_diinn_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "liif-rdn.json")
                    .read_text())


def tiny_config() -> dict:
    cfg = json.loads(json.dumps(CONFIG))
    cfg["encoder"].update(blocks=2, convs=2, growth=16, growth0=16)
    cfg["imnet"]["hidden_dims"] = [32, 32]
    cfg["program"]["model"].update(encoder="rdn-tiny", hidden_dims=[32, 32])
    return cfg


def tiny_task(cfg: dict, seed: int, bsize: int = 30000):
    task = loop.build_task(load_config(
        {"model": dict(cfg["program"]["model"], eval_bsize=bsize)}),
        device="cpu")
    weights = make_weights(cfg, seed, torch.device("cpu"))
    task.net.load_state_dict(weights, strict=True)
    return task, weights


@pytest.mark.parametrize("lr_hw,hr_hw,bsize", [
    ((12, 16), (24, 32), 30000),      # x2
    ((12, 16), (48, 64), 30000),      # x4
    ((12, 16), (38, 50), 30000),      # x3.14
    ((10, 13), (26, 33), 30000),
    ((12, 16), (38, 50), 200),        # 10 chunks of 5 columns
])
def test_port_predict_matches_the_plain_reference(lr_hw, hr_hw, bsize):
    cfg = tiny_config()
    task, weights = tiny_task(cfg, 2**31 + 11, bsize)
    x = torch.rand((1, *lr_hw, 3), generator=torch.Generator().manual_seed(
        sum(hr_hw)))
    with torch.inference_mode():
        got = task.predict(x, hr_hw)
    want = R.predict(weights, cfg, x, hr_hw, Rounding("fp32"), block=500)
    assert got.shape == want.shape == (1, *hr_hw, 3)
    assert (got - want).abs().max().item() <= 1e-6


def test_the_reference_block_does_not_change_the_output():
    cfg = tiny_config()
    weights = make_weights(cfg, 7, torch.device("cpu"))
    x = torch.rand((2, 9, 11, 3), generator=torch.Generator().manual_seed(1))
    whole = R.predict(weights, cfg, x, (31, 35), Rounding("fp32"))
    rows = R.predict(weights, cfg, x, (31, 35), Rounding("fp32"), block=100)
    assert torch.equal(whole, rows)


@pytest.mark.parametrize("tag,tol", [
    ("liif_full", dict(rtol=5e-4, atol=1e-4, grad_atol=2e-3)),
    ("liif_decode", {})])
def test_reference_matches_the_published_goldens(tag, tol):
    sd, d = load_fixture(tag)
    p = dict(_load(LIIF(), tl.convert_liif(sd)).state_dict())
    size = tuple(int(v) for v in d["size"])
    fn = R.forward if tag == "liif_full" else R.decode
    check_golden(lambda x: fn(p, CONFIG, x.permute(0, 3, 1, 2), size,
                              Rounding("fp32")), d, **tol)


@pytest.mark.parametrize("which", ["published", "tiny"])
def test_param_spec_names_the_port_state_dict(which):
    cfg = CONFIG if which == "published" else tiny_config()
    m = cfg["program"]["model"]
    net = LIIF(encoder_spec=m["encoder"], hidden=tuple(m["hidden_dims"]))
    spec = R.param_spec(cfg)
    assert [(n, tuple(s)) for n, s, _ in spec] == [
        (k, tuple(v.shape)) for k, v in net.state_dict().items()]
    fan = {n: f for n, _, f in spec}
    assert fan["imnet_rel.dense.weight"] == fan["imnet_feat.conv.weight"] \
        == cfg["encoder"]["growth0"] * 9 + 4


def test_corner_indices_follow_grid_sample_nearest():
    """The reference's corner lookup is ``grid_sample``'s nearest cell of
    the shifted, clamped coordinate."""
    import torch.nn.functional as F
    for n_in, n_out in ((12, 24), (12, 48), (10, 26), (7, 19)):
        for v in (-1, 1):
            idx, _ = R.corner_axis(n_in, n_out, v, "cpu")
            c = -1 + (2 * torch.arange(n_out, dtype=torch.float64) + 1) / n_out
            q = (c + v / n_in + R.EPS_SHIFT).clamp(-R.CLAMP, R.CLAMP)
            grid = torch.stack([torch.zeros_like(q), q], -1)[None, :, None]
            src = torch.arange(n_in, dtype=torch.float64)[None, None, :, None]
            got = F.grid_sample(src.expand(1, 1, n_in, 1).double(),
                                grid.double(), mode="nearest",
                                align_corners=False)
            assert torch.equal(got.flatten().long(), idx)


@pytest.mark.parametrize("hr_hw,bsize", [((38, 50), 200), ((24, 32), 30000),
                                         ((26, 33), 60)])
def test_decode_counters_follow_the_shapes(hr_hw, bsize):
    cfg = tiny_config()
    task, _ = tiny_task(cfg, 3, bsize)
    x = torch.rand((2, 12, 16, 3))
    liif.reset_counters()
    with torch.inference_mode():
        task.predict(x, hr_hw)
        task.predict(x[:1], hr_hw)
    chunks = -(-hr_hw[1] // max(1, bsize // hr_hw[0]))
    assert liif.chunks == 2 * chunks
    assert liif.corner_queries == 4 * 3 * hr_hw[0] * hr_hw[1]
    liif.reset_counters()
    assert liif.chunks == liif.corner_queries == 0


def test_decode_spans_reach_a_profiler_that_records_the_host():
    from torch.profiler import ProfilerActivity, profile
    cfg = tiny_config()
    task, _ = tiny_task(cfg, 3, 200)
    x = torch.rand((1, 12, 16, 3))
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        task.predict(x, (38, 50))
    names = [e.name for e in prof.events()]
    assert {"predict", "encoder", "decoder", "lr_conv",
            "decoder.prepare"} <= set(names)
    assert names.count("decoder.window") == 10


def test_counts_by_hand():
    assert counts_liif.query_macs([256] * 4, 3) == 198400
    lr, hr = (192, 256), (384, 512)
    rdn = counts.rdn_macs_per_px()
    want = 2.0 * (rdn * 192 * 256 + 9 * 64 * 256 * 192 * 256
                  + 4 * 198400 * 384 * 512)
    assert counts_liif.predict_flops(CONFIG, lr, hr) == want
    call = counts_liif.decoder_call(CONFIG, 1, lr, hr)
    assert call["flops"] == 2.0 * 4 * 198400 * 384 * 512
    weights = 4 * (580 * 256 + 256 + 3 * (256 * 256 + 256) + 256 * 3 + 3)
    assert call["bytes"] == 192 * 256 * 256 * 4 + weights + 384 * 512 * 3 * 4
    # x8 of 192x256: 3.1M queries, 5.0 TFLOP of query MLP
    assert counts_liif.decoder_call(CONFIG, 1, lr, (1536, 2048))[
        "flops"] == pytest.approx(4.99e12, rel=1e-3)
    assert counts.least_seconds(call, "NVIDIA H100 80GB HBM3", "float32") \
        == call["flops"] / 495e12


def test_per_query_work_is_twice_diinn():
    """1.587 MFLOP a query, 2.0x DIINN-RDN's decoder (789,504)."""
    liif_q = 2 * 4 * counts_liif.query_macs([256] * 4, 3)
    diinn_q = 2 * counts.decoder_hr_macs_per_query()
    assert diinn_q == 789504 and liif_q == 1587200
    assert np.isclose(liif_q / diinn_q, 2.0, atol=0.02)


@pytest.mark.parametrize("names,want", [
    # a program whose LIIF opens no span of its own: only predict's
    (("predict", "encoder"), (None, None)),
    # idle 10-40: the encoder 10-20, predict alone 20-25, the decoder 25-40
    (("predict", "encoder", "decoder", "decoder.prepare"), (15.0, 0.01)),
])
def test_span_readers_read_nothing_without_the_decoders_spans(names, want):
    """``idle_in_decoder.upscale.liif`` and ``decoder_host_ms.upscale.liif``
    on a hand-built trace of one request: device busy 0-10 and 40-100 us,
    the decoder's spans 25-65 (prepare 25-35)."""
    from perfbench import harness, trace
    from perfbench.drivers.common import Record
    spans = {"predict": (0, 100), "encoder": (0, 20), "decoder": (25, 65),
             "decoder.prepare": (25, 35)}
    t = trace.Trace(span=(0.0, 100.0), device=[("k", 0, 10), ("k", 40, 100)],
                    host=[(n, *spans[n]) for n in names], iterations=1,
                    layers=trace.load_layers())
    run = Record(setup_s=1.0, window_s=1.0, items=[], attempted=1, failed=0,
                 memory_peak_bytes=0, checks={}, trace=t)
    got = tuple(harness.load_reader(m)(run) for m in (
        "idle_in_decoder.upscale.liif", "decoder_host_ms.upscale.liif"))
    assert got == tuple(None if w is None else pytest.approx(w) for w in want)
