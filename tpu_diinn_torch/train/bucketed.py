"""Bucketed static-shape benchmark eval: one program per bucket, one CUDA
graph per program.

Counterpart of ``tpu_diinn/train/bucketed.py``. Every benchmark image is
zero-padded to a bucket canvas (its LR side rounded up to a multiple of
``quantum``) and evaluated by the program of that bucket:

- the encoder runs under ``nn.masking.valid_extent``: conv outputs are
  zeroed beyond the true extent, so every activation inside it equals the
  unpadded run's;
- the decoder reads gather indices and relative coordinates that the host
  builds per image and copies in (``decode_traced`` of each family), and
  the synthesis grid is computed on the device from the true sizes
  (``_syn_traced``);
- the metrics run masked on the padded canvases (``metrics.psnr_masked``,
  ``ssim_masked``, ``lr_psnr_masked``), LR-PSNR with the resize matrices of
  the true sizes zero-embedded in the bucket's.

Per pixel, the values match the exact-shape route; only the fp32
summation order of the metric means differs. The programs, keyed as the
JAX package keys its jitted functions: ``("kernel", h_pad, w_pad, hh_pad,
ww_pad)`` (DIINN on the fused configuration at an integer scale with HR
exactly s x LR: one ``decode_int_fwd`` over the padded canvas, its fp32
output kept), ``"traced"`` (DIINN otherwise: ``decode_traced`` in row
bands), ``"liif"`` and ``"metasr"``.

On a CUDA device each program is captured once as a ``torch.cuda.CUDAGraph``
over static input buffers, after an eager warm-up on a side stream (cuDNN,
cuBLAS and the kernel library initialise outside the capture); every graph
allocates from one shared memory pool, since they replay one at a time.
Per image: host prep in numpy, ``copy_`` into the static buffers,
``replay()``, one ``.tolist()`` of the three metrics. A failed capture
raises; nothing falls back to eager. The wrappers of
``kernels/decoder_fused.py`` and ``kernels/liif_decoder.py`` count a launch
when they are called, which happens at capture only: each graph's launches
counted there are taken back and added at every replay instead
(``_launch_counts``). On the CPU the same program
function runs eagerly for every image.

The graphs hold pointers to the net's weights: build a ``BucketedEval``
after the weights are loaded (as ``cli/benchmarks.py`` does) and do not
replace the parameter tensors afterwards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_diinn_torch.core import grids
from tpu_diinn_torch.core.resize import resize_by_scale_size, resize_matrix
from tpu_diinn_torch.kernels import decoder_fused as kern
from tpu_diinn_torch.kernels import liif_decoder as ld
from tpu_diinn_torch.nn import masking
from tpu_diinn_torch.nn.diinn import DIINN
from tpu_diinn_torch.nn.liif import LIIF, _CORNERS, _corner_axis_indices
from tpu_diinn_torch.nn.metasr import MetaSR, _axis_lookup
from tpu_diinn_torch.train import metrics as M
from tpu_diinn_torch.train.task import SRTask, denormalize, normalize

Key = Tuple[str, int, int, int, int]
SPLIT = ("prep", "copy", "capture", "replay", "read")


class BucketedUnsupported(Exception):
    """A model outside the bucketed eval's scope (DIINN mode 4, or a class
    that is neither DIINN, LIIF nor MetaSR); callers take the exact-shape
    route."""


def _bucket_up(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q


def _pad_to(a: np.ndarray, shape: Tuple[int, ...], fill=0) -> np.ndarray:
    """``a`` in the leading corner of a ``shape`` array filled with
    ``fill``."""
    out = np.full(shape, fill, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _syn_traced(out_pad: Tuple[int, int], in_pad: Tuple[int, int],
                hv: torch.Tensor, wv: torch.Tensor, hhv: torch.Tensor,
                wwv: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
                ) -> torch.Tensor:
    """The (H_pad, W_pad, 3) float32 synthesis grid of a padded canvas,
    computed on the device from the true sizes (0-d int32 tensors) and the
    padded gather indices, in the JAX ``_syn_traced``'s fp32 operation
    order. Nothing is uploaded from the host."""
    h_pad, w_pad = out_pad
    f32 = torch.float32

    def centers(n, count):
        r = torch.reciprocal(n.to(f32))
        return (-1.0 + r) + (2.0 * r) * torch.arange(count, dtype=f32,
                                                     device=n.device)

    yo = centers(hhv, h_pad)
    xo = centers(wwv, w_pad)
    yi = centers(hv, in_pad[0])
    xi = centers(wv, in_pad[1])
    hf, wf = hv.to(f32), wv.to(f32)
    ry = (yo - yi.index_select(0, rows)) * hf
    rx = (xo - xi.index_select(0, cols)) * wf
    ratio = (hf * wf) / (hhv.to(f32) * wwv.to(f32))
    shape = (h_pad, w_pad)
    return torch.stack([ry[:, None].expand(shape), rx[None, :].expand(shape),
                        ratio.expand(shape)], dim=-1)


def _launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counts: the decoder's by wrapper key,
    LIIF's query-MLP kernel's under ``ld.KEY``."""
    return {**kern.launches, ld.KEY: ld.launches}


def _add_launches(counts: Dict[str, int]) -> None:
    """``counts`` (keys of ``_launch_counts``) added to the wrappers'."""
    for k, n in counts.items():
        if k == ld.KEY:
            ld.launches += n
        else:
            kern.launches[k] += n


@dataclasses.dataclass
class _Program:
    """One bucket's program: its static input buffers and, on a card, its
    graph, the graph's output and the kernel launches of one replay."""
    fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    bufs: Dict[str, torch.Tensor]
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: Optional[torch.Tensor] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    replays: int = 0


class BucketedEval:
    """The benchmark loop's evaluator (``loop.test_metrics(evaluator=)``):
    ``test_fn(scale, lr_shape, hr_shape)(lr, hr)`` -> [psnr, ssim,
    lr_psnr] for one numpy (1, h, w, 3) / (1, H, W, 3) pair in [0, 1]."""

    def __init__(self, task: SRTask, quantum: int = 64):
        net = task.net
        if isinstance(net, DIINN):
            if net.decoder.mode == 4:
                raise BucketedUnsupported("mode 4 (window output conv)")
            self.arch = "diinn"
        elif isinstance(net, (LIIF, MetaSR)):
            self.arch = "liif" if isinstance(net, LIIF) else "metasr"
        else:
            raise BucketedUnsupported(type(net).__name__)
        self.net = net
        self.task = task
        self.quantum = quantum
        self.device = next(net.parameters()).device
        self.graphs = self.device.type == "cuda"
        self._programs: Dict[Key, _Program] = {}
        self._pool = None
        # host seconds by part: numpy prep, copy-in, warm-up and capture,
        # replay (to the device's end), read-back of the metrics
        self.seconds = dict.fromkeys(SPLIT, 0.0)

    @property
    def n_programs(self) -> int:
        return len(self._programs)

    # -- the programs ----------------------------------------------------
    def _encode(self, lr: torch.Tensor) -> torch.Tensor:
        """The masked encoder: ``normalize`` maps the zero pad to -1, so
        the normalized input is masked too (the first conv must see zeros
        beyond the true extent, as same padding gives)."""
        x = masking.apply_valid_mask(normalize(lr).permute(0, 3, 1, 2))
        return self.net.encoder(x.permute(0, 2, 3, 1))

    def _predict(self, key: Key, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Program ``key``'s prediction on buffers ``b``: the (B, hh_pad,
        ww_pad, 3) canvas in [0, 1], the unpadded route's values inside the
        true extent."""
        kind, h_pad, w_pad, hh_pad, ww_pad = key
        net, bsize = self.net, self.task.eval_bsize
        hv, wv, hhv, wwv = b["ext"][:4].unbind()
        with masking.valid_extent((h_pad, w_pad), hv, wv):
            feat = self._encode(b["lr"])
            if kind == "liif":
                corners = [tuple(b[f"{n}{c}"] for n in ("iy", "ry", "ix",
                                                        "rx"))
                           for c in range(len(_CORNERS))]
                pred = net.decode_traced(feat, corners, b["cell"],
                                         (hh_pad, ww_pad), bsize)
            elif kind == "metasr":
                pred = net.decode_traced(feat, b["iy"], b["ry"], b["ix"],
                                         b["rx"], b["r_rev"],
                                         (hh_pad, ww_pad), bsize)
            else:
                syn = _syn_traced((hh_pad, ww_pad), (h_pad, w_pad), hv, wv,
                                  hhv, wwv, b["rows"], b["cols"])
                dec = net.decoder
                if kind == "traced":
                    pred = dec.decode_traced(feat, syn, b["rows"], b["cols"],
                                             bsize)
                else:
                    z = dec.lr_features_stacked(feat)
                    s = hh_pad // h_pad
                    # the kernel's fp32 output, unrounded (JAX's
                    # out.astype(float32))
                    pred = kern.decode(z, syn, dec._fused_params(),
                                       ratio=(s, s))
        return torch.clamp(denormalize(pred), 0.0, 1.0)

    def _program_fn(self, key: Key):
        def fn(b: Dict[str, torch.Tensor]) -> torch.Tensor:
            pred = self._predict(key, b)
            _, _, hhv, wwv, hlv, wlv = b["ext"].unbind()
            hr = b["hr"]
            return torch.stack([
                M.psnr_masked(pred, hr, hhv, wwv),
                M.ssim_masked(pred, hr, hhv, wwv),
                M.lr_psnr_masked(pred, hr, b["mh"], b["mw"], hlv, wlv)])
        return fn

    def _capture(self, prog: _Program) -> None:
        """Warm ``prog`` up eagerly on a side stream, then capture it; its
        wrappers' launch counts move from the capture to the replays."""
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            prog.fn(prog.bufs)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            prog.out = prog.fn(prog.bufs)
        prog.launches = {k: n - before[k]
                         for k, n in _launch_counts().items()
                         if n != before[k]}
        _add_launches({k: -n for k, n in prog.launches.items()})
        prog.graph = graph

    @torch.inference_mode()
    def replay(self, key: Key) -> torch.Tensor:
        """One run of program ``key`` on its buffers, the metrics as a (3,)
        tensor: the graph's replay on a card (its kernel launches counted;
        a copy of the graph's output, which the replay of any program of
        this evaluator may overwrite, as all share one pool), the eager
        function on the CPU."""
        prog = self._programs[key]
        prog.replays += 1
        if prog.graph is None:
            return prog.fn(prog.bufs)
        prog.graph.replay()
        _add_launches(prog.launches)
        return prog.out.clone()

    @torch.inference_mode()
    def eager(self, key: Key) -> torch.Tensor:
        """Program ``key``'s function run eagerly on its buffers (the last
        image copied in): what its graph replays, to check a replay
        against."""
        prog = self._programs[key]
        return prog.fn(prog.bufs)

    # -- per-image host prep and dispatch --------------------------------
    def _buckets(self, lr_hw, hr_hw, scale) -> Tuple[int, int, int, int]:
        q = self.quantum
        h, w = lr_hw
        hh, ww = hr_hw
        h_pad, w_pad = _bucket_up(h, q), _bucket_up(w, q)
        if float(scale).is_integer():
            s = int(scale)
            hh_pad, ww_pad = s * h_pad, s * w_pad
            # round(H/s) can exceed s*bucket(h) when h is already a
            # multiple of the quantum; widen once
            if hh_pad < hh:
                h_pad += q
                hh_pad = s * h_pad
            if ww_pad < ww:
                w_pad += q
                ww_pad = s * w_pad
        else:
            hh_pad, ww_pad = _bucket_up(hh, 2 * q), _bucket_up(ww, 2 * q)
        return h_pad, w_pad, hh_pad, ww_pad

    def _inputs(self, lr: np.ndarray, hr: np.ndarray, scale
                ) -> Tuple[Key, Dict[str, np.ndarray]]:
        """The program key of an image pair and its padded host inputs."""
        b, h, w = lr.shape[:3]
        hh, ww = hr.shape[1:3]
        buckets = self._buckets((h, w), (hh, ww), scale)
        h_pad, w_pad, hh_pad, ww_pad = buckets
        hl, wl = resize_by_scale_size((hh, ww), scale)
        if not (hl <= h_pad and wl <= w_pad):
            raise ValueError(f"LR-PSNR size {(hl, wl)} exceeds the bucket "
                             f"{(h_pad, w_pad)}")
        x = {"lr": _pad_to(lr, (b, h_pad, w_pad, 3)),
             "hr": _pad_to(hr, (b, hh_pad, ww_pad, 3)),
             "ext": np.array([h, w, hh, ww, hl, wl], np.int32),
             "mh": _pad_to(resize_matrix(hh, hl).astype(np.float32),
                           (h_pad, hh_pad)),
             "mw": _pad_to(resize_matrix(ww, wl).astype(np.float32),
                           (w_pad, ww_pad))}
        if self.arch == "liif":
            for c, (vy, vx) in enumerate(_CORNERS):
                iy, ry = _corner_axis_indices(h, hh, vy)
                ix, rx = _corner_axis_indices(w, ww, vx)
                x.update({f"iy{c}": _pad_to(iy, (hh_pad,)),
                          f"ry{c}": _pad_to(ry, (hh_pad,)),
                          f"ix{c}": _pad_to(ix, (ww_pad,)),
                          f"rx{c}": _pad_to(rx, (ww_pad,))})
            x["cell"] = np.asarray([2.0 * h / hh, 2.0 * w / ww], np.float32)
            return ("liif",) + buckets, x
        if self.arch == "metasr":
            iy, ry = _axis_lookup(h, hh)
            ix, rx = _axis_lookup(w, ww)
            x.update({"iy": _pad_to(iy, (hh_pad,)),
                      "ry": _pad_to(ry, (hh_pad,)),
                      "ix": _pad_to(ix, (ww_pad,)),
                      "rx": _pad_to(rx, (ww_pad,)),
                      "r_rev": np.asarray((2.0 / hh) * h / 2.0, np.float32)})
            return ("metasr",) + buckets, x
        # integer-scale images with HR exactly s x LR (the benchmark
        # protocol's) take decode_int_fwd over the padded canvas when the
        # decoder's configuration takes the fused route
        s = int(scale) if float(scale).is_integer() else 0
        use_kernel = (1 <= s <= kern.MAX_INT_RATIO
                      and hh == s * h and ww == s * w
                      and hh_pad == s * h_pad
                      and self.net.decoder._fused_config_ok())
        # past the true extent the index vectors repeat the last true index
        # (JAX pads with 0), so that they stay non-decreasing, as the
        # window kernel's index vectors must be; what is decoded there is
        # masked out of every metric
        rows = grids.nearest_exact_indices(h, hh)
        cols = grids.nearest_exact_indices(w, ww)
        x["rows"] = _pad_to(rows, (hh_pad,), rows[-1])
        x["cols"] = _pad_to(cols, (ww_pad,), cols[-1])
        return ("kernel" if use_kernel else "traced",) + buckets, x

    def _program(self, key: Key, x: Dict[str, np.ndarray]) -> _Program:
        prog = self._programs.get(key)
        if prog is None:
            bufs = {k: torch.empty(a.shape, device=self.device,
                                   dtype=torch.from_numpy(a).dtype)
                    for k, a in x.items()}
            prog = self._programs[key] = _Program(self._program_fn(key),
                                                  bufs)
        return prog

    @torch.inference_mode()
    def metrics(self, lr: np.ndarray, hr: np.ndarray, scale) -> list:
        """[psnr, ssim, lr_psnr] of one (1, h, w, 3) / (1, H, W, 3) numpy
        pair in [0, 1]."""
        sec = self.seconds
        t0 = time.perf_counter()
        key, x = self._inputs(np.asarray(lr, np.float32),
                              np.asarray(hr, np.float32), scale)
        t1 = time.perf_counter()
        prog = self._program(key, x)
        if prog.bufs["lr"].shape != x["lr"].shape:
            raise ValueError(f"bucket {key} holds batches of "
                             f"{prog.bufs['lr'].shape[0]}, got "
                             f"{x['lr'].shape[0]}")
        for k, a in x.items():
            prog.bufs[k].copy_(torch.from_numpy(a))
        t2 = time.perf_counter()
        if self.graphs and prog.graph is None:
            self._capture(prog)
        t3 = time.perf_counter()
        out = self.replay(key)
        if self.graphs:
            torch.cuda.synchronize(self.device)
        t4 = time.perf_counter()
        vals = out.tolist()
        t5 = time.perf_counter()
        for part, dt in zip(SPLIT, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                    t5 - t4)):
            sec[part] += dt
        return vals

    def test_fn(self, scale, lr_shape, hr_shape):
        """``loop.EvalJit``'s surface in the JAX package: a callable of
        (lr, hr) numpy arrays."""
        def run(lr, hr):
            return self.metrics(lr, hr, scale)
        return run
