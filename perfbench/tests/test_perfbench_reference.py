"""The reference agrees with the program's CPU path at tiny widths (the
program's kernels run their plain versions on the CPU), and its pieces
with the program's own grids."""

import numpy as np
import pytest
import torch

from conftest import tiny_config
from perfbench.reference import diinn as ref
from perfbench.reference.precision import Rounding, round_fp8, round_tf32
from perfbench.weights import make_weights
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels.decoder_fused import tf32_split
from tpu_diinn_torch.train import loop

FP32 = Rounding("fp32")


def program_task(cfg):
    task = loop.build_task(load_config(cfg["program"]), device="cpu")
    w = make_weights(cfg, 5, "cpu")
    task.net.load_state_dict(w, strict=True)
    return task, w


@pytest.mark.parametrize("kind", ["rdn", "edsr"])
@pytest.mark.parametrize("size", [(24, 32), (38, 50), (48, 64)])
def test_predict_agrees_with_the_program(kind, size):
    cfg = tiny_config(kind)
    task, w = program_task(cfg)
    x = torch.rand((1, 12, 16, 3), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = task.predict(x, size, bsize=200)
    want = ref.predict(w, cfg, x, size, FP32, block=300)
    assert got.shape == want.shape == (1, *size, 3)
    assert float((got - want).abs().max()) < 1e-5
    assert float(want.std()) > 1e-3          # not a constant image


@pytest.mark.parametrize("kind", ["rdn", "edsr"])
def test_loss_and_gradients_agree_with_the_program(kind):
    cfg = tiny_config(kind)
    task, w = program_task(cfg)
    g = torch.Generator().manual_seed(2)
    batch = {s: (torch.rand((2, 8, 8, 3), generator=g),
                 torch.rand((2, 8 * s, 8 * s, 3), generator=g))
             for s in (2, 3)}
    loss = task.train_loss(batch)
    loss.backward()
    got = {k: p.grad for k, p in task.net.named_parameters()}
    want_loss, want = ref.loss_and_grads(w, cfg, list(batch.values()), FP32,
                                         block=100, image_block=3)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-6)
    assert set(got) == set(want)
    for k in want:
        scale = float(want[k].abs().max()) + 1e-12
        assert float((got[k] - want[k]).abs().max()) / scale < 1e-4, k


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(5, 4, generator=g), "b": torch.randn(3, generator=g)}
    theirs = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    opt = torch.optim.Adam(list(theirs.values()), lr=1e-4)
    mine = ref.Adam(p, 1e-4)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        for k, t in theirs.items():
            t.grad = grads[k].clone()
        opt.step()
        mine.step(p, grads)
    for k in p:
        assert torch.allclose(p[k], theirs[k].detach(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n_in,n_out", [(12, 24), (192, 603), (256, 804),
                                        (48, 144), (7, 3)])
def test_grid_pieces_agree_with_the_programs(n_in, n_out):
    assert np.array_equal(ref.nearest_exact(n_in, n_out, "cpu").numpy(),
                          grids.nearest_exact_indices(n_in, n_out))
    syn = ref.syn_rows((n_in, 16), (n_out, 40), 0, n_out, "cpu")
    want = grids.syn_input_grid((n_in, 16), (n_out, 40))
    # the program takes the difference of two float32 centres in [-1, 1]
    # and scales it by n_in: a few units of 2**-24, times n_in
    assert float((syn - want).abs().max()) <= 2 ** -21 * n_in


def test_rounding():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(4))
    assert torch.equal(round_tf32(x), tf32_split(x)[0])
    q = round_fp8(x)
    assert len(torch.unique(q)) < len(torch.unique(x))
    assert float(((q - x).abs() / x.abs().clamp_min(1e-3)).median()) < 0.07
    assert torch.equal(Rounding("fp32").operand(x), x)
