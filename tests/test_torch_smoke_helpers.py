"""``chip_smoke.py``'s helpers, on the CPU: the build phase finds each
kernel's instances by ``kernel_name`` (from ``cuobjdump``'s and ptxas's
mangled names) and phase 10d counts the forward kernels' launches in
``torch.profiler``'s names (a name it fails to parse would make the smoke
miss a kernel on the card); phase 8d's cut epoch (``resume_root``,
``resume_args``) keeps the rate's halving at the first step of epoch 2;
phase 4's eval samples are replayed by 6a and 11b, and only Set5's are
kept after 6a."""

from pathlib import Path

import pytest

import chip_smoke as cs
from tpu_diinn_torch.cli import train as train_cli
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.train import loop

REPO = Path(__file__).resolve().parents[1]


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


def test_resume_root_has_the_images_phase_8d_expects(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    root = cs.resume_root(tmp_path)
    assert root == tmp_path / "resume_data"
    links = sorted((root / "DIV2K" / "DIV2K_train_HR").iterdir())
    assert len(links) == cs.RESUME_IMAGES == 45
    assert all(p.is_symlink() and p.resolve().parent
               == (REPO / cs.DIV2K_HR).resolve() for p in links)
    cfg = load_config(None, cs.resume_args(root))
    train, val = loop.make_datasets(cfg, use_native=False)
    assert (len(train), len(val)) == (cs.RESUME_TRAIN_IMAGES, 5) == (40, 5)
    assert (len(train) * cfg.data.trainsets_repeat // cfg.data.batch_size
            == cs.RESUME_STEPS_PER_EPOCH == 10)


def test_resume_epoch_halves_the_rate_at_epoch_2(tmp_path, monkeypatch):
    """Two epochs of ``cli.train`` on phase 8d's data and overrides (a tiny
    model at one scale on the CPU, samples made in-process, no
    validation): 20 steps, the rate of steps 1-10 the configured one and
    of steps 11-20 half of it."""
    monkeypatch.chdir(REPO)
    root = cs.resume_root(tmp_path)
    lrs = []

    def recording(fn):
        def call(state):
            lrs.append(state.optimizer.param_groups[0]["lr"])
            return fn(state)
        return call
    with cs.patched(loop, "apply_update", recording):
        state = train_cli.main([
            "--device", "cpu", *cs.resume_args(root), "trainer.max_epochs=2",
            "model.encoder=rdn-tiny", "model.hidden_dims=[16,16]",
            "data.patch_size=12", "data.train_scales=[2]",
            "data.num_workers=0", "trainer.check_val_every_n_epoch=1000",
            f"trainer.ckpt_dir={tmp_path / 'ck'}",
            f"trainer.log_dir={tmp_path / 'ck'}"])
    spe = cs.RESUME_STEPS_PER_EPOCH
    assert state.step == len(lrs) == 2 * spe
    lr = lrs[0]
    assert lrs == [lr] * spe + [0.5 * lr] * spe


class _Set:
    """The attributes of a test set that ``cs.eval_key`` reads."""

    def __init__(self, name: str, n: int):
        self.names_hr = [f"data/benchmark/{name}/HR/img{i:04d}.png"
                         for i in range(n)]
        self.scales, self.patch_size = [3.14, 4], 0

    def __len__(self) -> int:
        return len(self.names_hr)


def test_eval_samples_replay_and_only_set5_stays(monkeypatch):
    monkeypatch.setattr(cs, "EVAL_SAMPLES", {})
    sets = {name: _Set(name, 2) for name in ("Set5", "Urban100")}
    read = lambda ds, indices: ((ds.names_hr[i], i) for i in indices)  # noqa: E731
    for ds in sets.values():
        assert list(cs.recording_samples(read)(ds)) == list(read(ds, (0, 1)))
    replay = cs.replaying_samples(None)
    for ds in sets.values():
        assert list(replay(ds)) == list(read(ds, (0, 1)))
    with pytest.raises(AssertionError):
        list(replay(sets["Set5"], [1]))
    cs.keep_samples_of("Set5")
    assert list(replay(sets["Set5"])) == list(read(sets["Set5"], (0, 1)))
    with pytest.raises(AssertionError):
        list(replay(sets["Urban100"]))
