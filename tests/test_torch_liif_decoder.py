"""LIIF's query-MLP kernel (``kernels/liif_decoder``) on the CPU.

- The kernel's device code (``csrc/liif_decoder.cuh``) through its host
  harness (``csrc/liif_decoder_host.cpp``: g++, one thread per CUDA thread,
  wgmma, mbarriers, TMA bulk copies and named barriers emulated) against
  ``LIIF._blend``'s torch path, within 2e-6 of the torch path's largest
  magnitude (3xTF32 keeps fp32-level error; the two sum W_4 and the
  products in different orders): ragged last tiles, a persistent grid of
  fewer CTAs than tiles, batch 2, a chunk written into a column range of a
  wider output (the columns outside it untouched), int64 and int32 index
  vectors. Skips without g++.
- The dispatch (``LIIF._fused``): the kernel is taken for a card input in
  fp32 inference at the compiled widths, and not for a CPU input, bf16,
  autograd on or other widths; ``fused_chunks`` counts the chunks it took,
  beside ``chunks`` and ``corner_queries``, which count as before. A CPU
  tensor that says it is on the card (``_CardTensor``) drives the decision
  here, and a stand-in records the launches.
- The torch path of a chunked ``decode`` written into one output: the
  one-chunk decode's values and gradients.
- The bucketed eval's launch counts, which carry LIIF's kernel's launches
  from a graph's capture to its replays beside the decoder's.
- The wrapper's argument checks, the weight slabs' layout and their cache.
- ``perfbench/layers/liif_decoder.fused.json``: the kernel's trace name
  falls in the ``liif_decoder`` group, and every kernel name of the
  benchmark's traced breakdowns of every cell before the kernel existed
  (``PERF_LEDGER.jsonl``'s truncated spelling) keeps the group it had
  without the file.

The kernel itself runs only on a card: ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py`` phase 3d.
"""

import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import trace
from tpu_diinn_torch.kernels import liif_decoder as ld
from tpu_diinn_torch.nn import liif
from tpu_diinn_torch.nn.liif import LIIF

CSRC = Path(ld.__file__).resolve().parents[1] / "csrc"
TOL = 2e-6


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    exe = tmp_path_factory.mktemp("host") / "liif_decoder_host"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(CSRC),
                    str(CSRC / "liif_decoder_host.cpp"), "-o", str(exe)],
                   check=True, capture_output=True)
    return exe


def _net(seed=1, **kw):
    return LIIF(encoder_spec="rdn-tiny",
                generator=torch.Generator().manual_seed(seed), **kw)


def _chunk(net, b, lr, size, c0, wc, seed=2, idx=torch.int64):
    """z, the chunk's per-corner vectors (columns c0 .. c0 + wc - 1 of a
    ``size`` decode of an ``lr`` map) and the cell."""
    z = torch.randn((b, *lr, 256), generator=torch.Generator()
                    .manual_seed(seed)) * 0.5
    maps, cell = net._lookups(torch.zeros((b, *lr, 1)), size)
    per_corner = [(iy.to(idx), ry, ix[c0:c0 + wc].to(idx).contiguous(),
                   rx[c0:c0 + wc].contiguous()) for iy, ry, ix, rx in maps]
    return z, per_corner, cell


# (B, LR, HR, first column, columns, most CTAs, int64 indices)
HOST_CASES = [
    (1, (5, 6), (11, 13), 2, 5, 1, True),     # two tiles, one CTA
    (2, (7, 5), (19, 17), 0, 17, 2, True),    # batch 2, ragged last tile
    (1, (4, 4), (9, 9), 8, 1, 3, False),      # one column, int32 indices
    (1, (6, 9), (24, 36), 30, 6, 4, False),   # x4, the last columns
]


@pytest.mark.parametrize("case", HOST_CASES, ids=str)
def test_host_emulation_matches_the_torch_path(harness, tmp_path, case):
    b, lr, size, c0, wc, ctas, idx64 = case
    net = _net()
    z, per_corner, cell = _chunk(
        net, b, lr, size, c0, wc,
        idx=torch.int64 if idx64 else torch.int32)
    with torch.no_grad():
        want = net._blend(z, per_corner, cell,
                          liif._new_output(z, size[0], wc))
    small, slabs = ld.operands(net)
    out = torch.full((b, size[0], size[1], 3), float("nan"))
    files = {"z": z, "cell": cell, "small": small, "wslab": slabs,
             "out": out}
    for k, (iy, ry, ix, rx) in enumerate(per_corner):
        files.update({f"iy{k}": iy, f"ry{k}": ry, f"ix{k}": ix,
                      f"rx{k}": rx})
    for name, t in files.items():
        t.contiguous().numpy().tofile(tmp_path / name)
    subprocess.run([str(harness), str(tmp_path)] + [str(v) for v in (
        b, *lr, size[0], wc, size[1], c0, ctas, int(idx64))],
        check=True, capture_output=True, timeout=300)
    got = torch.from_numpy(np.fromfile(
        tmp_path / "out_out", dtype=np.float32)).reshape(out.shape)
    inside = got[:, :, c0:c0 + wc]
    assert torch.isnan(got[:, :, :c0]).all()
    assert torch.isnan(got[:, :, c0 + wc:]).all()
    err = (inside - want).abs().max().item()
    assert err <= TOL * want.abs().max().item()


class _CardTensor(torch.Tensor):
    """A CPU tensor that says it is on the card, so that ``engaged``
    decides as it would there."""

    @property
    def is_cuda(self):
        return True


def _card(x: torch.Tensor) -> torch.Tensor:
    return x.as_subclass(_CardTensor)


@pytest.fixture
def launches(monkeypatch):
    """The stand-in for the kernel, which records each call's z and out
    (and writes zeros); the feature conv of a card input computed on the
    CPU and handed on as a card tensor (the slab conv's output is a plain
    CPU tensor here)."""
    calls = []

    def stand_in(z, per_corner, cell, small, slabs, out=None):
        calls.append((z, out))
        if out is None:
            out = z.new_empty((z.shape[0], len(per_corner[0][0]),
                               len(per_corner[0][2]), 3))
        out.zero_()
        return out
    monkeypatch.setattr(ld, "decode_chunk", stand_in)
    feat_conv = LIIF.feat_conv

    def card_feat_conv(self, feat):
        if isinstance(feat, _CardTensor):
            return _card(feat_conv(self, feat.as_subclass(torch.Tensor)))
        return feat_conv(self, feat)
    monkeypatch.setattr(LIIF, "feat_conv", card_feat_conv)
    return calls


# (what, LIIF kwargs, card input, grad on)
DISPATCH = [
    ("fp32 on the card", {}, True, False),
    ("cpu input", {}, False, False),
    ("bf16", {"dtype": torch.bfloat16}, True, False),
    ("grad", {}, True, True),
    ("hidden 32", {"hidden": (32, 32, 32, 32)}, True, False),
    ("three hidden layers", {"hidden": (256, 256, 256)}, True, False),
]


@pytest.mark.parametrize("case", DISPATCH, ids=lambda c: c[0])
def test_dispatch_takes_the_kernel_only_in_fp32_inference(launches, case):
    """``decode`` of a 7x9 map to 15x20 in chunks of 4 columns (5
    chunks): on the kernel, one call a chunk into its columns of one
    output, every chunk counted in ``fused_chunks``; else none, and
    ``chunks`` and ``corner_queries`` count as before."""
    what, kw, card, grad = case
    net = _net(**kw)
    c = net.imnet_feat.conv.weight.shape[1]
    feat = torch.randn((1, 7, 9, c), generator=torch.Generator()
                       .manual_seed(3))
    liif.reset_counters()
    with torch.set_grad_enabled(grad):
        out = net.decode(_card(feat) if card else feat, (15, 20), bsize=60)
    fused = what == "fp32 on the card"
    assert liif.chunks == 5
    assert liif.corner_queries == 4 * 15 * 20
    assert liif.fused_chunks == (5 if fused else 0)
    assert len(launches) == liif.fused_chunks
    assert out.shape == (1, 15, 20, 3)
    if fused:
        base = launches[0][1]._base
        assert all(o._base is base for _, o in launches)
        assert [o.storage_offset() for _, o in launches] == [
            3 * lo for lo in range(0, 20, 4)]
        assert all(z.is_contiguous() for z, _ in launches)
    liif.reset_counters()
    assert liif.chunks == liif.corner_queries == liif.fused_chunks == 0


def test_dispatch_serves_stripes_and_the_bucketed_decode(launches):
    """``decode_stripe`` (one call) and ``decode_traced`` (row bands, int32
    vectors, a z made contiguous once) take the kernel where ``decode``
    does, with the same counters."""
    net = _net()
    c = net.imnet_feat.conv.weight.shape[1]
    feat = _card(torch.randn((1, 5, 6, c), generator=torch.Generator()
                             .manual_seed(2)))
    liif.reset_counters()
    with torch.no_grad():
        net.decode_stripe(feat, (11, 13), 4, 5)
        maps, cell = net._lookups(feat, (11, 13))
        per_corner = [(iy.to(torch.int32), ry, ix.to(torch.int32), rx)
                      for iy, ry, ix, rx in maps]
        out = net.decode_traced(feat, per_corner, cell, (11, 13), 40)
    assert liif.chunks == liif.fused_chunks == 1 + 4
    assert len(launches) == 5
    assert out.shape == (1, 11, 13, 3)
    assert all(z.is_contiguous() for z, _ in launches)


@pytest.mark.parametrize("hidden", [(256, 256, 256, 256), (32, 32, 32, 32)],
                         ids=str)
def test_torch_path_decodes_chunks_into_one_output_with_gradients(hidden):
    """The torch path of ``decode`` in 4-column chunks, each written into
    its columns of one output, gives the one-chunk decode's values and the
    same gradients of the features and of every parameter."""
    net = _net(hidden=hidden)
    c = net.imnet_feat.conv.weight.shape[1]
    feat = torch.randn((1, 7, 9, c), generator=torch.Generator()
                       .manual_seed(4))
    grads = []
    for bsize in (None, 60):
        f = feat.clone().requires_grad_(True)
        net.zero_grad()
        out = net.decode(f, (15, 20), bsize)
        out.square().sum().backward()
        grads.append((out.detach(), f.grad,
                      [p.grad.clone() for p in net.parameters()
                       if p.grad is not None]))
    (a, fa, pa), (b, fb, pb) = grads
    assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    assert torch.allclose(fa, fb, rtol=1e-5, atol=1e-6)
    assert len(pa) == len(pb) > 0
    assert all(torch.allclose(x, y, rtol=1e-5, atol=1e-6)
               for x, y in zip(pa, pb))


def test_bucketed_launch_counts_move_liif_launches_too(monkeypatch):
    """The bucketed eval's counts (``_launch_counts``, ``_add_launches``)
    hold LIIF's kernel launches beside the decoder's, so a graph's
    launches booked at capture move to each replay for both."""
    from tpu_diinn_torch.kernels import decoder_fused as kern
    from tpu_diinn_torch.train import bucketed
    monkeypatch.setattr(kern, "launches", dict.fromkeys(kern.launches, 0))
    monkeypatch.setattr(ld, "launches", 0)
    before = bucketed._launch_counts()
    assert before[ld.KEY] == 0 and ld.KEY not in kern.launches
    key = next(iter(kern.launches))
    ld.launches += 3
    kern.launches[key] += 2
    after = bucketed._launch_counts()
    booked = {k: n - before[k] for k, n in after.items() if n != before[k]}
    assert booked == {ld.KEY: 3, key: 2}
    bucketed._add_launches({k: -n for k, n in booked.items()})
    assert bucketed._launch_counts() == before
    bucketed._add_launches(booked)
    bucketed._add_launches(booked)
    assert ld.launches == 6 and kern.launches[key] == 4


def _vectors(h=3, w=4, idx=torch.int64):
    return [(torch.zeros(h, dtype=idx), torch.zeros(h),
             torch.zeros(w, dtype=idx), torch.zeros(w))] * 4


# (what, z, per-corner vectors, the error's words)
REFUSED = [
    ("non-contiguous z", lambda: torch.zeros((1, 4, 5, 256)).transpose(1, 2),
     _vectors, "contiguous"),
    ("float64 z", lambda: torch.zeros((1, 4, 5, 256), dtype=torch.float64),
     _vectors, "float32"),
    ("128 channels", lambda: torch.zeros((1, 4, 5, 128)), _vectors,
     "256 channels"),
    ("short row rel", lambda: torch.zeros((1, 4, 5, 256)),
     lambda: [(torch.zeros(3, dtype=torch.int64), torch.zeros(2),
               torch.zeros(4, dtype=torch.int64), torch.zeros(4))] * 4,
     "row rel"),
    ("long column rel", lambda: torch.zeros((1, 4, 5, 256)),
     lambda: [(torch.zeros(3, dtype=torch.int64), torch.zeros(3),
               torch.zeros(4, dtype=torch.int64), torch.zeros(5))] * 4,
     "column rel"),
    ("mixed index types", lambda: torch.zeros((1, 4, 5, 256)),
     lambda: [(torch.zeros(3, dtype=torch.int64), torch.zeros(3),
               torch.zeros(4, dtype=torch.int32), torch.zeros(4))] * 4,
     "column index"),
    ("three corners", lambda: torch.zeros((1, 4, 5, 256)),
     lambda: _vectors()[:3], "4 corners"),
    ("a CPU z", lambda: torch.zeros((1, 4, 5, 256)), _vectors,
     "CUDA device"),
]


@pytest.mark.parametrize("case", REFUSED, ids=lambda c: c[0])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    _, make_z, make_vectors, words = case
    small, slabs = ld.operands(_net())
    with pytest.raises(ValueError, match=words):
        ld.decode_chunk(make_z(), make_vectors(), torch.ones(2), small,
                        slabs)


def test_weight_slabs_layout():
    """The weight of input k = 8 s + 4 kh + c and output n = 128 h + 8 g + r
    of layer l sits at slab (l, 0, s, h), [hi/lo][g, kh, r, c], hi + lo the
    weight, hi a TF32 value."""
    ws = [torch.randn((256, 256), generator=torch.Generator()
                      .manual_seed(i)) for i in range(3)]
    s = ld.weight_slabs(ws)
    assert s.shape == (3, 1, 32, 2, 2, 16, 2, 8, 4) and s.is_contiguous()
    assert s.numel() == 3 * 64 * ld.SLAB_FLOATS
    rng = np.random.default_rng(0)
    for _ in range(300):
        layer, n, k = (int(rng.integers(m)) for m in (3, 256, 256))
        k8, kc = divmod(k, 8)
        kh, c = divmod(kc, 4)
        h, n8 = divmod(n, 128)
        g, r = divmod(n8, 8)
        sv = s[layer, 0, k8, h, :, g, kh, r, c]
        assert (sv[0] + sv[1]).item() == ws[layer][n, k].item()
        assert (sv[0].view(torch.int32).item() & 0x1fff) == 0


def test_small_operands_layout():
    net = _net()
    small, _ = ld.operands(net)
    assert small.shape == (ld.SMALL_FLOATS,)
    h = 256
    rel, cell = net.imnet_rel.dense, net.imnet_cell.dense
    fc4 = net.imnet_fc4.dense
    assert torch.equal(small[:h], rel.weight[:, 0])
    assert torch.equal(small[h:2 * h], rel.weight[:, 1])
    assert torch.equal(small[2 * h:3 * h], rel.bias)
    assert torch.equal(small[3 * h:4 * h], cell.weight[:, 0])
    assert torch.equal(small[4 * h:5 * h], cell.weight[:, 1])
    for i in range(3):
        b = getattr(net, f"imnet_fc{i + 1}").dense.bias
        assert torch.equal(small[(5 + i) * h:(6 + i) * h], b)
    assert torch.equal(small[8 * h:11 * h], fc4.weight.reshape(-1))
    assert torch.equal(small[11 * h:11 * h + 3], fc4.bias)


def test_operands_are_made_again_after_the_weights_change():
    net = _net()
    first = ld.operands(net)
    assert ld.operands(net)[1] is first[1]
    fc2 = net.imnet_fc2.dense
    with torch.no_grad():
        fc2.weight.add_(1)          # the version moves, not the storage
    again = ld.operands(net)
    assert again[1] is not first[1]
    assert torch.equal(again[1], ld.weight_slabs(
        [getattr(net, f"imnet_fc{i}").dense.weight for i in (1, 2, 3)]))
    with torch.no_grad():
        net.imnet_fc4.dense.bias.add_(1)
    assert torch.equal(ld.operands(net)[0][-4:-1], net.imnet_fc4.dense.bias)
    net.load_state_dict({k: v + 1 for k, v in net.state_dict().items()})
    assert ld.operands(net)[1] is not again[1]


# the kernel names of the benchmark's traced breakdowns of every cell
# before the kernel existed, as PERF_LEDGER.jsonl spells them
LEDGER_NAMES = [
    "Memcpy_DtoH__Device_-__Pageable_",
    "Memcpy_HtoD__Pageable_-__Device_",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL_ncclDevKernelArgsStorage",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_w",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8_stage3_wa",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_wa",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwck",
    "void_at::native::_anonymous_namespace_::CatArrayBatchedCopy_alig",
    "void_at::native::_anonymous_namespace_::CatArrayBatchedCopy_at::",
    "void_at::native::_scatter_gather_elementwise_kernel_128__8__at::",
    "void_at::native::elementwise_kernel_128__2__at::native::gpu_kern",
    "void_at::native::elementwise_kernel_128__4__at::native::gpu_kern",
    "void_at::native::reduce_kernel_128__4__at::native::ReduceOp_c10:",
    "void_at::native::reduce_kernel_512__1__at::native::ReduceOp_floa",
    "void_at::native::unrolled_elementwise_kernel_at::native::direct_",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::CU",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::_a",
    "void_at::native::vectorized_elementwise_kernel_8__at::native::CU",
    "void_at::native::vectorized_gather_kernel_16__long__char___char_",
    "void_cutlass__5x_cudnn::Kernel_cutlass_tensorop_bf16_s16816dgrad",
    "void_decoder_bwd::decode_bwd_chain_bf16_kernel_8__false__true__u",
    "void_decoder_bwd::wgrad_bf16_kernel_256__unsigned_short_const___",
    "void_decoder_fused::decode_fwd_kernel_8__false__hopper_chain::Tf",
    "void_decoder_fused::decode_fwd_kernel_8__true__hopper_chain::Tf3",
    "void_decoder_fwd_bf16::decode_fwd_bf16_kernel_8__false__unsigned",
    "void_encoder_conv::conv_implicit_gemm_3xtf32_kernel_1__CUtensorM",
    "void_encoder_conv::conv_implicit_gemm_3xtf32_kernel_3__CUtensorM",
]
FUSED_FILE = "liif_decoder.fused.json"


def _layers_without_the_fused_file():
    with tempfile.TemporaryDirectory() as d:
        for f in trace.LAYERS_DIR.glob("*.json"):
            if f.name != FUSED_FILE:
                shutil.copy(f, d)
        return trace.load_layers(Path(d))


@pytest.mark.parametrize("name", [
    "void liif_decoder::query_mlp_3xtf32_kernel(liif_decoder::Params)",
    "void_liif_decoder::query_mlp_3xtf32_kernel_liif_decoder::Params_"])
def test_the_kernel_falls_in_the_liif_decoder_group(name):
    assert (trace.LAYERS_DIR / FUSED_FILE).exists()
    assert trace.group_of(name, trace.load_layers()) == "liif_decoder"
    assert trace.group_of(name, _layers_without_the_fused_file()) is None


@pytest.mark.parametrize("name", LEDGER_NAMES)
def test_the_fused_file_moves_no_kernel_of_the_traced_breakdowns(name):
    before = trace.group_of(name, _layers_without_the_fused_file())
    assert trace.group_of(name, trace.load_layers()) == before
