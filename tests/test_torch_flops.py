"""The port's FLOP accounting and bench.

- ``tpu_diinn_torch/train/flops.py`` counts exactly what
  ``tpu_diinn/train/flops.py`` counts (integers, compared with ==) over
  encoders, batches, patches, scales and hidden widths;
- ``mfu`` divides by the H100 data-sheet peak of the card's SKU;
- ``python -m tpu_diinn_torch.bench``, run on the CPU at a tiny size
  (``key=value`` overrides after its own configuration), prints one JSON
  line with every field of the JAX bench's line (less its TPU baseline)
  plus the dtype and the device.
"""

import json

import pytest

from tpu_diinn.train import flops as JF
from tpu_diinn_torch import bench
from tpu_diinn_torch.train import flops as TF


@pytest.mark.parametrize("encoder", ["rdn", "edsr-baseline"])
@pytest.mark.parametrize("batch,patch,scales", [
    (4, 48, (2, 3, 4)), (16, 48, (4,)), (1, 12, (2.5, 3.14)),
    (8, 64, (1.5,))])
@pytest.mark.parametrize("hidden", [(256,) * 4, (32,) * 3, (64, 128, 64)])
def test_train_step_flops_equal_jax(encoder, batch, patch, scales, hidden):
    want = JF.train_step_flops(batch, patch, scales, encoder=encoder,
                               hidden_dims=hidden)
    got = TF.train_step_flops(batch, patch, scales, encoder=encoder,
                              hidden_dims=hidden)
    assert got == want


@pytest.mark.parametrize("fn,args", [
    ("rdn_macs_per_px", ()), ("rdn_macs_per_px", (20, 6, 32, 64)),
    ("edsr_baseline_macs_per_px", ()), ("edsr_baseline_macs_per_px", (8, 32)),
    ("decoder_lr_macs_per_px", (64, (256,) * 4)),
    ("decoder_hr_macs_per_query", ((256,) * 4,)),
    ("decoder_hr_macs_per_query", ((32, 64), 3))])
def test_macs_equal_jax(fn, args):
    assert getattr(TF, fn)(*args) == getattr(JF, fn)(*args)


def test_flagship_step_flops():
    """4.375 TFLOP for the flagship training step (batch 4, 48-px
    patches, scales {2, 3, 4})."""
    total = TF.train_step_flops(4, 48, [2, 3, 4])["total"]
    assert total == JF.train_step_flops(4, 48, [2, 3, 4])["total"]
    assert abs(total - 4.3745e12) < 1e8


@pytest.mark.parametrize("name,sku,peak", [
    ("NVIDIA H100 80GB HBM3", "H100 SXM", 989e12),
    ("NVIDIA H100 PCIe", "H100 PCIe", 756e12)])
def test_mfu_uses_the_sku_peak(name, sku, peak):
    assert TF.sku(name) == sku
    assert TF.mfu(peak / 2, 1.0, chip=TF.sku(name)) == 0.5
    assert TF.PEAK_FLOPS[(sku, "bfloat16")] == peak
    assert not any("v5" in k[0] for k in TF.PEAK_FLOPS)   # no TPU entry


def test_sku_refuses_other_cards():
    with pytest.raises(ValueError):
        TF.sku("NVIDIA A100-SXM4-80GB")


FIELDS = {"metric", "value", "unit", "batch", "steps_per_s",
          "model_tflops_per_s", "mfu_bf16", "flops_split",
          "ref_config_ms_per_step", "ref_config_pix_s", "dtype", "device"}


def test_bench_cpu_prints_one_json_line(capsys):
    out = bench.main(["--device", "cpu", "data.batch_size=1",
                      "data.patch_size=8", "model.encoder=rdn-tiny",
                      "model.hidden_dims=[32,32,32]"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec == json.loads(json.dumps(out))
    assert set(rec) == FIELDS
    assert "vs_baseline" not in rec
    assert rec["metric"] == "decoded_pixels_per_s_per_chip_fwd_bwd_x4"
    assert rec["dtype"] == "bfloat16" and rec["batch"] == 1
    assert rec["value"] > 0 and rec["steps_per_s"] > 0
    # pixels of the run's own configuration: 1 patch of 8 px, decoded x4
    assert rec["value"] == pytest.approx(32 * 32 * rec["steps_per_s"])
    assert rec["device"] == {"name": "cpu", "power_limit": None}
    assert rec["mfu_bf16"] is None       # no card, no peak
    assert set(rec["flops_split"]) == {"encoder", "decoder_lr",
                                       "decoder_hr"}
