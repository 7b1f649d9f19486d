"""The program-span readers (``spans.py``) on hand-built traces: the idle
time of a traced window put down to the innermost program span, the host
time of a set of spans, and the metric readers reading the same with the
spans added."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, readers, spans, trace
from perfbench.drivers.common import Record

LAYERS = trace.load_layers()

DEVICE = [("sm90_xmma_fprop_implicit_gemm_bf16bf16", 0, 10),
          ("void decoder_fused::decode_fwd_bf16_kernel<256>", 30, 40),
          ("void decoder_bwd::decode_bwd_chain_bf16_kernel<8>", 55, 70),
          ("multi_tensor_apply_kernel<AdamFunctor>", 85, 90),
          ("Memcpy HtoD (Pinned -> Device)", 96, 100)]
CALLS = [("cudaLaunchKernel", 12, 14), ("cudaStreamSynchronize", 90, 96),
         ("Optimizer.step#Adam.step", 80, 92)]
# the main thread's spans, and the decoder's backward on autograd's
# thread (it overlaps step.backward in time)
SPANS = [("train_step 4", 0, 95), ("step.forward", 0, 42),
         ("encoder", 0, 20), ("lr_conv", 20, 24), ("decoder", 24, 42),
         ("decoder.prepare", 24, 28), ("step.backward", 42, 78),
         ("decoder.backward", 44, 72), ("decoder.backward.prepare", 46, 52),
         ("step.update", 78, 95), ("to_device", 95, 99)]
# idle: 10-30, 40-55, 70-85, 90-96
WANT = {"encoder": 14.0,          # encoder 10-20, lr_conv 20-24
        "decoder": 21.0,          # prepare 24-28, decoder 28-30 and
        #                           40-42, backward 44-46 and 52-55, its
        #                           prepare 46-52, backward 70-72
        "update": 7 + 5,          # 78-85, 90-95
        "feed": 1.0,              # 95-96
        "other": 2 + 6}           # step.backward alone 42-44, 72-78


def make(host, device=DEVICE, iterations=2):
    return trace.Trace(span=(0.0, 100.0), device=list(device),
                       host=list(host), iterations=iterations,
                       layers=LAYERS)


def record(t) -> Record:
    return Record(setup_s=1.0, window_s=1.0, items=[], attempted=1,
                  failed=0, memory_peak_bytes=0, checks={}, trace=t,
                  stretch_flops=1e9, stretch_decoder_least_s=1e-6,
                  peak_flops=989e12)


def _split_us(t):
    return {k: v * 1e6 for k, v in spans.idle_by_layer(t).items()}


def test_idle_goes_to_the_innermost_span_across_threads():
    t = make(CALLS + SPANS)
    got = _split_us(t)
    assert got == {k: pytest.approx(v) for k, v in WANT.items()}
    assert sum(got.values()) * 1e-6 == pytest.approx(
        readers.idle_share(record(t)) / 100 * t.window_s, rel=1e-9)


def test_a_gap_that_straddles_two_spans_is_split_between_them():
    t = make([("step.update", 0, 35), ("to_device", 35, 50)],
             device=[("k", 0, 20), ("k", 60, 100)])
    assert _split_us(t) == {"update": pytest.approx(15.0),
                            "feed": pytest.approx(15.0),
                            "encoder": 0.0, "decoder": 0.0,
                            "other": pytest.approx(10.0)}


def test_a_gap_under_no_span_or_a_parent_alone_is_other():
    t = make([("predict", 0, 25), ("encoder", 0, 5)],
             device=[("k", 0, 10), ("k", 40, 100)])
    assert _split_us(t) == {"other": pytest.approx(30.0), "feed": 0.0,
                            "encoder": 0.0, "decoder": 0.0, "update": 0.0}


def _readings(rec):
    out = {f"idle_in_{layer}": spans.idle_share(rec, layer)
           for layer in spans.LAYERS}
    out["decoder_host_ms"] = spans.host_ms(
        rec, ("decoder.prepare", "decoder.backward.prepare"))
    return out


def test_without_program_spans_or_device_the_readers_read_none():
    for rec in (record(make(CALLS)), record(make(SPANS, device=[])),
                record(None)):
        assert set(_readings(rec).values()) == {None}


def test_the_layers_and_other_sum_to_the_idle_share():
    rec = record(make(CALLS + SPANS))
    got = _readings(rec)
    assert [got[f"idle_in_{layer}"] for layer in spans.LAYERS] == \
        pytest.approx([1.0, 14.0, 21.0, 12.0])
    other = 100.0 * spans.idle_by_layer(rec.trace)["other"] / 100e-6
    assert sum(got[f"idle_in_{layer}"] for layer in spans.LAYERS) + other \
        == pytest.approx(readers.idle_share(rec), rel=1e-9)
    # decoder.prepare 24-28 and decoder.backward.prepare 46-52, over two
    # iterations; the forward's alone 24-28
    assert got["decoder_host_ms"] == pytest.approx(5e-3)
    assert spans.host_ms(rec, ("decoder.prepare",)) == pytest.approx(2e-3)
    assert spans.host_ms(rec, ("no such span",)) == 0.0


def test_the_readers_that_were_there_read_the_same_with_spans():
    bench = harness.load_benchmark()
    before, after = record(make(CALLS)), record(make(CALLS + SPANS))
    for m in bench["per_layer"]:
        read = harness.load_reader(m["name"])
        assert read(before) == read(after), m["name"]
    b, a = before.trace, after.trace
    assert b.top_ops() == a.top_ops() and b.busy_s == a.busy_s
    assert [g[1] for g in b.idle_gaps()] == [g[1] for g in a.idle_gaps()]


def test_span_echoes_on_the_device_are_dropped():
    kind = torch.autograd.DeviceType

    def event(name, start, end, device):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    # the profiler echoes each host range on the device's timeline
    prof = SimpleNamespace(events=lambda: (
        [event(n, s, e, kind.CPU) for n, s, e in SPANS]
        + [event(n, s, e, kind.CUDA) for n, s, e in DEVICE]
        + [event(n, s + 1, e + 1, kind.CUDA) for n, s, e in SPANS]))
    t = trace.build_trace(prof, 2, 1.0, layers=LAYERS)
    assert [d[0] for d in t.device] == [d[0] for d in DEVICE]
    assert len(spans.program_spans(t)) == len(SPANS)
