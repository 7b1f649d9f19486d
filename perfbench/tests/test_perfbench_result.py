"""A whole run on the CPU at a tiny size: the result line's schema, with
and without a traced stretch, and the traced stretch's arithmetic."""

import json

import pytest

from conftest import tiny_config, tiny_traffic
from perfbench import harness, trace
from perfbench.drivers.common import Record
from perfbench.harness import Cell

LAYERS = trace.load_layers()


def cell(kind: str, bench: dict) -> Cell:
    config = tiny_config("rdn" if kind == "train" else "edsr")
    traffic = tiny_traffic("train-b16-x234" if kind == "train"
                           else "upscale-192x256", dtype="float32")
    name = "diinn-rdn.train" if kind == "train" else "diinn-edsr.upscale"
    real = harness.load_cell(bench, name)
    return Cell(name, 1, config, traffic, real.limits, real.end_to_end,
                real.per_layer)


@pytest.mark.parametrize("kind", ["train", "upscale"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(kind, traced, cpu):
    c = cell(kind, harness.load_benchmark())
    out = harness.run_cell(c, 2**31 + 5, 0.5, traced, cpu, 0.0)
    json.loads(json.dumps(out))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}
        assert check["value"] <= check["limit"]
    if traced:
        # no device on the CPU: the per-layer readers find nothing
        assert out["metrics"] == {}
        assert out["device"]["busy_s"] == 0.0
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
        for m in out["metrics"].values():
            assert m["value"] > 0 and set(m) == {"value", "unit"}


def fake_trace():
    device = [("void decoder_fused::decode_fwd_bf16_kernel<256>", 0, 10),
              ("sm90_xmma_fprop_implicit_gemm_bf16bf16", 10, 40),
              ("sm90_xmma_dgrad_implicit_gemm", 35, 50),
              ("direct_copy_kernel_cuda", 60, 70),
              ("multi_tensor_apply_kernel<AdamFunctor>", 80, 90),
              ("Memcpy HtoD (Pinned -> Device)", 90, 95)]
    host = [("cudaLaunchKernel", 45, 49), ("cudaMemcpyAsync", 50, 58),
            ("cudaLaunchKernel", 55, 57), ("cudaStreamSynchronize", 95, 100)]
    return trace.Trace(span=(0.0, 100.0), device=device, host=host,
                       iterations=2, layers=LAYERS)


def test_trace_arithmetic():
    t = fake_trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(75e-6)        # 0-50, 60-70, 80-95
    assert t.group_seconds("decoder") == pytest.approx(10e-6)
    assert t.group_seconds("conv") == pytest.approx(40e-6)
    assert t.group_seconds("cast_copy") == pytest.approx(10e-6)
    assert t.group_seconds("optimizer") == pytest.approx(10e-6)
    assert t.group_seconds("nothing") is None
    assert t.idle_gaps() == [["cudaMemcpyAsync", pytest.approx(10e-6)],
                             [trace.NO_CALL, pytest.approx(10e-6)],
                             ["cudaStreamSynchronize", pytest.approx(5e-6)]]
    assert t.top_ops(1) == [["sm90_xmma_fprop_implicit_gemm_bf16bf16",
                             pytest.approx(30e-6)]]


def test_per_layer_readers():
    view = Record(setup_s=1.0, window_s=2.0,
                  items=[{"pixels": 10, "latency_s": x / 100}
                         for x in range(1, 101)],
                  attempted=100, failed=0, memory_peak_bytes=0, checks={},
                  trace=fake_trace(), stretch_flops=989e12 * 50e-6,
                  stretch_decoder_least_s=5e-6, peak_flops=989e12)
    read = {n: harness.load_reader(n)(view) for n in (
        "idle_share.train", "mfu.train", "decoder_roofline.train",
        "conv_ms.train", "cast_copy_ms.train", "optimizer_ms.train",
        "upscale_pixels_per_s", "upscale_p95_ms", "setup_s")}
    assert read["idle_share.train"] == pytest.approx(25.0)
    assert read["mfu.train"] == pytest.approx(50.0)
    assert read["decoder_roofline.train"] == pytest.approx(50.0)
    assert read["conv_ms.train"] == pytest.approx(20e-3)
    assert read["cast_copy_ms.train"] == pytest.approx(5e-3)
    assert read["optimizer_ms.train"] == pytest.approx(5e-3)
    assert read["upscale_pixels_per_s"] == pytest.approx(500.0)
    assert read["upscale_p95_ms"] == pytest.approx(950.5)
    assert read["setup_s"] == 1.0
    one = Record(1.0, 2.0, [{"pixels": 1, "latency_s": 0.25}], 1, 0, 0, {})
    assert harness.load_reader("upscale_p95_ms")(one) == 250.0
    empty = Record(1.0, 2.0, [], 0, 0, 0, {})
    for n in ("idle_share.upscale", "mfu.upscale", "decoder_roofline.upscale",
              "conv_ms.upscale", "upscale_p95_ms"):
        assert harness.load_reader(n)(empty) is None
    # each metric of the cells over EDSR-baseline reads as its twin
    bench = harness.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].endswith(".edsr"):
            twin = m["name"][:-len(".edsr")]
            for run in (view, empty):
                assert (harness.load_reader(m["name"])(run)
                        == harness.load_reader(twin)(run)), m["name"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "tpu_diinn_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.forbidden_modules() == ["flax"]
