"""The fp32 inference encoder's conv (``kernels/encoder_conv``) on the CPU.

- The kernel's device code (``csrc/encoder_conv.cuh``) through its host
  harness (``csrc/encoder_conv_host.cpp``: g++, one thread per CUDA
  thread, wgmma, mbarriers and the TMA box loads with their zero fill and
  swizzle emulated) against the plain version, within 4e-6 of the plain
  version's largest magnitude (3xTF32 keeps fp32-level error; the two sum
  in different orders): ragged tiles, channel chunks and N tiles, the
  3-channel image, a 1x1 conv, ReLU and a residual, an output slice of a
  wider slab, a persistent grid of fewer CTAs than tiles, a 1x1 conv that
  writes over its own input's channels with them as its residual and a
  second output (a residual dense block's local fusion). Skips without
  g++.
- The dispatch: the slab path (``engaged``) is taken by RDN without a
  head, EDSR-baseline, the stacked LR conv and LIIF's feature conv
  (``imnet_feat``, with a zero bias) for a CUDA input in fp32 inference,
  and not for a CPU input, a bf16 module, autograd on, a halo,
  valid-extent masking, RDN's head or LIIF's bucketed decode. A CPU
  tensor that says it is on the card (``_CardTensor``) drives the decision
  here; the convs then run the plain version.
- The plain slab path equals the NCHW path bit for bit here (within 1e-6
  is asked), and the weight slabs' layout and their cache.

The kernel itself runs only on a card: ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py`` phase 3c.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_diinn_torch.kernels import encoder_conv as ec
from tpu_diinn_torch.nn.diinn import ImplicitDecoder
from tpu_diinn_torch.nn.edsr import EDSRBaseline
from tpu_diinn_torch.nn.liif import LIIF
from tpu_diinn_torch.nn.masking import valid_extent
from tpu_diinn_torch.nn.rdn import RDN

CSRC = Path(ec.__file__).resolve().parents[1] / "csrc"
TOL = 4e-6


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    exe = tmp_path_factory.mktemp("host") / "encoder_conv_host"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(CSRC),
                    str(CSRC / "encoder_conv_host.cpp"), "-o", str(exe)],
                   check=True, capture_output=True)
    return exe


# (B, H, W, Cin, input slab's channels, k, Cout, output slab's channels,
# residual, ReLU, most CTAs, in place: the output and the residual are the
# input slab's first Cout channels and the output slab is the second output,
# as in a residual dense block's local fusion)
HOST_CASES = [
    (1, 3, 64, 32, 32, 3, 64, 64, False, False, 1, False),  # one whole tile
    (1, 4, 70, 40, 44, 3, 70, 80, True, True, 3, False),    # ragged
    (2, 5, 9, 3, 4, 3, 64, 64, False, True, 2, False),      # the RGB image
    (1, 7, 20, 72, 76, 1, 64, 68, True, False, 2, False),   # 1x1, 3 chunks
    (1, 4, 10, 64, 64, 3, 130, 130, False, False, 2, False),  # 3 N tiles
    (1, 47, 53, 72, 76, 1, 64, 68, True, False, 4, True),   # in place
]


@pytest.mark.parametrize("case", HOST_CASES, ids=str)
def test_host_emulation_matches_plain(harness, tmp_path, case):
    b, h, w, cin, x_cs, k, cout, out_cs, res, relu, ctas, in_place = case
    gen = torch.Generator().manual_seed(sum(case[:8]))
    x = torch.randn((b, h, w, x_cs), generator=gen)
    wt = torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** .5
    bias = torch.randn((cout,), generator=gen)
    out = torch.randn((b, h, w, out_cs), generator=gen)
    res_cs = cout + 3 if res and not in_place else 0
    r = torch.randn((b, h, w, res_cs), generator=gen) if res_cs else None
    files = [("x", x), ("wslab", ec.weight_slabs(wt)), ("bias", bias),
             ("out", out)] + ([("res", r)] if res_cs else [])
    for name, t in files:
        t.contiguous().numpy().astype(np.float32).tofile(tmp_path / name)
    subprocess.run([str(harness), str(tmp_path)] + [str(v) for v in (
        b, h, w, cin, x_cs, k, cout, out_cs, res_cs, int(relu), ctas,
        int(in_place))], check=True, capture_output=True, timeout=300)

    def read(name, like):
        return torch.from_numpy(np.fromfile(
            tmp_path / name, dtype=np.float32)).reshape(like.shape)
    got, got_x = read("out_out", out), read("x_out", x)
    want, want_x = out.clone(), x.clone()
    if in_place:
        ec.conv_ref(want_x[..., :cin], wt, bias, want_x[..., :cout],
                    relu=relu, residual=want_x[..., :cout],
                    out2=want[..., :cout])
    else:
        ec.conv_ref(x[..., :cin], wt, bias, want[..., :cout], relu=relu,
                    residual=None if r is None else r[..., :cout])
    assert torch.equal(got[..., cout:], want[..., cout:])
    assert torch.equal(got_x[..., cout:], want_x[..., cout:])
    for g, wv in ((got, want), (got_x, want_x)):
        err = (g - wv).abs().max().item()
        assert err <= TOL * wv.abs().max().item()


class _CardTensor(torch.Tensor):
    """A CPU tensor that says it is on the card, so that ``engaged``
    decides as it would there."""

    @property
    def is_cuda(self):
        return True


def _card(x: torch.Tensor) -> torch.Tensor:
    return x.as_subclass(_CardTensor)


@pytest.fixture
def conv_calls(monkeypatch):
    calls = []
    real = ec.conv

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(ec, "conv", counting)
    return calls


def _tiny(kind, **kw):
    gen = torch.Generator().manual_seed(0)
    if kind == "edsr":
        return EDSRBaseline(n_resblocks=2, n_feats=16, generator=gen, **kw)
    return RDN(growth0=16, config="tiny", generator=gen, **kw)


def _x(seed=1):
    return torch.rand((2, 6, 7, 3), generator=torch.Generator()
                      .manual_seed(seed))


# (what, module kind, module kwargs, card input, grad, masking, slab convs)
DISPATCH = [
    ("rdn", "rdn", {}, True, False, False, 10),
    ("edsr", "edsr", {}, True, False, False, 6),
    ("cpu input", "rdn", {}, False, False, False, 0),
    ("bf16", "rdn", {"dtype": torch.bfloat16}, True, False, False, 0),
    ("bf16 edsr", "edsr", {"dtype": torch.bfloat16}, True, False, False, 0),
    ("grad", "rdn", {}, True, True, False, 0),
    ("grad edsr", "edsr", {}, True, True, False, 0),
    ("masking", "rdn", {}, True, False, True, 0),
    ("masking edsr", "edsr", {}, True, False, True, 0),
    ("head", "rdn", {"upsampling": 2}, True, False, False, 0),
]


@pytest.mark.parametrize("case", DISPATCH, ids=lambda c: c[0])
def test_dispatch_takes_the_slab_path_only_in_fp32_inference(conv_calls,
                                                             case):
    _, kind, kw, card, grad, masked, n = case
    net = _tiny(kind, **kw)
    x = _card(_x()) if card else _x()
    scope = (valid_extent((6, 7), torch.tensor(5, dtype=torch.int32),
                          torch.tensor(6, dtype=torch.int32))
             if masked else torch.enable_grad() if grad else torch.no_grad())
    with torch.no_grad(), scope:
        y = net(x)
    assert len(conv_calls) == n
    assert torch.isfinite(y).all()


def test_dispatch_keeps_a_halo_encoder_off_the_slab_path():
    """A halo-sharded encoder (the mesh axis on every conv) is not
    engaged; its forward needs a process group, so the decision alone."""
    x = _card(_x())
    with torch.no_grad():
        assert ec.engaged(x, torch.float32)
        assert not ec.engaged(x, torch.float32, halo=object())
        assert not ec.engaged(x, torch.bfloat16)
        assert not ec.engaged(x.double(), torch.float32)


def _decoder(seed=0):
    return ImplicitDecoder(in_channels=16, hidden_dims=(32, 32, 32),
                           generator=torch.Generator().manual_seed(seed))


def test_dispatch_runs_the_stacked_lr_conv_once_on_the_slab_path(
        conv_calls):
    dec = _decoder()
    feat = torch.randn((2, 5, 6, 16), generator=torch.Generator()
                       .manual_seed(2))
    with torch.no_grad():
        want = dec.lr_features_stacked(feat)
        assert not conv_calls
        got = dec.lr_features_stacked(_card(feat))
    assert len(conv_calls) == 1
    assert got.shape == (2, 5, 6, 96) and got.is_contiguous()
    assert (got - want).abs().max().item() <= 1e-6


# (what, LIIF kwargs, card input, grad, masking, slab convs)
LIIF_DISPATCH = [
    ("fp32", {}, True, False, False, 1),
    ("cpu input", {}, False, False, False, 0),
    ("bf16", {"dtype": torch.bfloat16}, True, False, False, 0),
    ("grad", {}, True, True, False, 0),
    ("masking", {}, True, False, True, 0),
]


@pytest.mark.parametrize("case", LIIF_DISPATCH, ids=lambda c: c[0])
def test_dispatch_runs_liif_feature_conv_on_the_slab_path_in_fp32_inference(
        conv_calls, case):
    """``LIIF.feat_conv`` (its ``imnet_feat``, 16 -> 32, no bias) takes the
    slab path with a zero bias where ``engaged``; the result equals the
    module's own conv."""
    _, kw, card, grad, masked, n = case
    net = LIIF(encoder_spec="rdn-tiny", hidden=(32, 32),
               generator=torch.Generator().manual_seed(0), **kw)
    feat = torch.randn((2, 5, 6, 16), generator=torch.Generator()
                       .manual_seed(2))
    scope = (valid_extent((5, 6), torch.tensor(4, dtype=torch.int32),
                          torch.tensor(5, dtype=torch.int32))
             if masked else torch.enable_grad() if grad else torch.no_grad())
    with torch.no_grad(), scope:
        got = net.feat_conv(_card(feat) if card else feat)
        want = net.imnet_feat(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert len(conv_calls) == n
    assert got.shape == (2, 5, 6, 32)
    assert (got.float() - want.float()).abs().max().item() <= 1e-6


def test_dispatch_liif_decodes_take_the_feature_conv_where_engaged(
        conv_calls):
    """A LIIF decode and a stripe each run the feature conv once on the
    slab path for a card input; the bucketed decode (``decode_traced``)
    keeps ``imnet_feat``."""
    net = LIIF(encoder_spec="rdn-tiny", hidden=(32, 32),
               generator=torch.Generator().manual_seed(0))
    feat = _card(torch.randn((1, 5, 6, 16), generator=torch.Generator()
                             .manual_seed(2)))
    with torch.no_grad():
        out = net.decode(feat, (11, 13), bsize=40)
        assert len(conv_calls) == 1
        net.decode_stripe(feat, (11, 13), 4, 5)
        assert len(conv_calls) == 2
        dev = torch.device("cpu")
        per_corner = [tuple(torch.zeros(k, dtype=dt, device=dev)
                            for k, dt in ((11, torch.long),
                                          (11, torch.float32),
                                          (13, torch.long),
                                          (13, torch.float32)))] * 4
        net.decode_traced(feat, per_corner, torch.ones(2), (11, 13), 40)
    assert len(conv_calls) == 2
    assert out.shape == (1, 11, 13, 3)


# the slab path's plain version against the NCHW path (the reference
# counts of B blocks and convs, a small image, batch 2)
EQUAL = [
    ("rdn-tiny", lambda g: RDN(growth0=16, config="tiny", generator=g)),
    ("rdn-b", lambda g: RDN(generator=g)),
    ("edsr-tiny", lambda g: EDSRBaseline(n_resblocks=2, n_feats=16,
                                         generator=g)),
    ("edsr-baseline", lambda g: EDSRBaseline(generator=g)),
]


@pytest.mark.parametrize("name,make", EQUAL, ids=[e[0] for e in EQUAL])
def test_plain_slab_path_equals_the_nchw_path(name, make):
    net = make(torch.Generator().manual_seed(4))
    x = torch.rand((2, 9, 11, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = net(x)
        got = net.forward_slabs(x)
        card = net(_card(x))
    assert got.shape == want.shape and got.is_contiguous()
    assert (got - want).abs().max().item() <= 1e-6
    assert torch.equal(card.as_subclass(torch.Tensor), got)


def test_weight_slabs_layout():
    """The weight of input channel 32 q + 16 j + 4 c + 2 u + h and output
    channel 64 nt + 8 g + r at tap t sits at slab (nt, q, t), k8 step
    2 j + u, [hi/lo][g, h, r, c], hi + lo the weight, hi a TF32 value,
    zero past Cout and Cin."""
    w = torch.randn((70, 40, 3, 3), generator=torch.Generator()
                    .manual_seed(6))
    s = ec.weight_slabs(w)
    assert s.shape == (2, 2, 9, 4, 2, 8, 2, 8, 4)
    rng = np.random.default_rng(0)
    for _ in range(200):
        o, i, dy, dx = (int(rng.integers(n)) for n in (128, 64, 3, 3))
        nt, col = divmod(o, 64)
        q, k = divmod(i, 32)
        j, k = divmod(k, 16)
        c, k = divmod(k, 4)
        u, h = divmod(k, 2)
        sv = s[nt, q, 3 * dy + dx, 2 * j + u, :, col // 8, h, col % 8, c]
        want = w[o, i, dy, dx].item() if o < 70 and i < 40 else 0.0
        assert (sv[0] + sv[1]).item() == want
        assert (sv[0].view(torch.int32).item() & 0x1fff) == 0


def test_operands_are_made_again_after_the_weights_change():
    net = _tiny("rdn")
    c = net.sfe1.conv

    def ops():
        return ec.operands(net.sfe1, [c.weight], [c.bias])
    first = ops()
    assert ops()[0] is first[0] and first[2] is None
    # a plain conv's operands are its parameters, not a copy
    assert first[0].data_ptr() == c.weight.data_ptr()
    assert first[1].data_ptr() == c.bias.data_ptr()
    net.load_state_dict({k: v + 1 for k, v in net.state_dict().items()})
    again = ops()
    assert again[0] is not first[0]
    assert torch.equal(again[0], c.weight.detach())
    with torch.no_grad():
        c.bias.add_(1)
    assert torch.equal(ops()[1], c.bias.detach())
