"""The frozen counts equal the program's ``train/flops.py`` at the cells'
shapes, and the decoder's least time follows from them."""

import pytest

from perfbench import counts
from perfbench.harness import load_named
from tpu_diinn_torch.train import flops


def test_peaks_equal_the_programs():
    assert counts.PEAK_FLOPS == flops.PEAK_FLOPS
    assert counts.sku("NVIDIA H100 80GB HBM3") == flops.sku(
        "NVIDIA H100 80GB HBM3") == "H100 SXM"
    assert counts.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 495e12
    assert counts.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12


@pytest.mark.parametrize("config,encoder", [("diinn-rdn", "rdn"),
                                            ("diinn-edsr", "edsr-baseline")])
def test_train_step_flops_equal_the_programs(config, encoder):
    cfg = load_named("configs", config)
    t = load_named("traffic", "train-b16-x234")
    want = flops.train_step_flops(t["batch"], t["patch"], t["scales"],
                                  encoder=encoder,
                                  hidden_dims=cfg["decoder"]["hidden_dims"])
    got = counts.train_step_flops(cfg, t["batch"], t["patch"], t["scales"])
    assert got == pytest.approx(want["total"], rel=1e-12)


def test_macs_equal_the_programs():
    assert counts.rdn_macs_per_px() == flops.rdn_macs_per_px() == 21_964_480
    assert counts.edsr_baseline_macs_per_px() == \
        flops.edsr_baseline_macs_per_px() == 1_218_240
    assert counts.decoder_hr_macs_per_query() == \
        flops.decoder_hr_macs_per_query() == 394_752


def test_decoder_least_time_is_compute_bound_at_the_cells_shapes():
    cfg = load_named("configs", "diinn-rdn")
    name = "NVIDIA H100 80GB HBM3"
    fwd = counts.decoder_call(cfg, "float32", 1, (192, 256), (1536, 2048),
                              False)
    assert fwd["flops"] == 2 * 394_752 * 1536 * 2048
    assert counts.least_seconds(fwd, name, "float32") == \
        fwd["flops"] / 495e12
    bwd = counts.decoder_call(cfg, "bfloat16", 16, (48, 48), (192, 192),
                              True)
    assert bwd["flops"] == 4 * 394_752 * 16 * 192 * 192
    assert counts.least_seconds(bwd, name, "bfloat16") == \
        bwd["flops"] / 989e12
