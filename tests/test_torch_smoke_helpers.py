"""``chip_smoke.py``'s name parsing, on the CPU: the build phase finds each
kernel's instances by ``kernel_name`` (from ``cuobjdump``'s and ptxas's
mangled names) and phase 10d counts the forward kernels' launches in
``torch.profiler``'s names. A name it fails to parse would make the smoke
miss a kernel on the card."""

import pytest

import chip_smoke as cs


@pytest.mark.parametrize("mangled,name", [
    ("_ZN16decoder_fwd_bf1622decode_fwd_bf16_kernelILi8ELb0EEEvPKtPKfPKiS6_"
     "S2_S4_S2_S4_S2_S4_Pfiiiiiiii", "decode_fwd_bf16_kernel<8,0>"),
    ("_ZN13decoder_fused17decode_fwd_kernelILi8ELb1EN12hopper_chain4Tf32EEEv"
     "PKNT1_1ZEP", "decode_fwd_kernel<8,1,Tf32>"),
    ("_ZN11decoder_bwd28decode_bwd_chain_bf16_kernelILi8ELb0ELb1EEEvPK",
     "decode_bwd_chain_bf16_kernel<8,0,1>"),
])
def test_kernel_name(mangled, name):
    assert cs.kernel_name(mangled) == name


def test_device_launches_reads_both_forward_kernels(monkeypatch):
    """Phase 10d's count by profiler name: the fp32 kernel and the bf16
    mode's own kernel, on both routes."""
    class Event:
        def __init__(self, key, count):
            self.key, self.count = key, count

    class Prof:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def key_averages(self):
            return [Event("void decoder_fused::decode_fwd_kernel<8, false, "
                          "hopper_chain::Tf32>(float const*)", 2),
                    Event("void decoder_fwd_bf16::decode_fwd_bf16_kernel<8, "
                          "true>(unsigned short const*)", 3),
                    Event("void decoder_fwd_bf16::decode_fwd_bf16_kernel<2, "
                          "false>(unsigned short const*)", 1),
                    Event("void at::native::elementwise_kernel<128>()", 5)]

    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(cs.torch.cuda, "synchronize", lambda *a: None)
    assert cs.device_launches(lambda: None) == {
        "decode_int_fwd": 2, "decode_window_fwd_bf16": 3,
        "decode_int_fwd_bf16": 1}
