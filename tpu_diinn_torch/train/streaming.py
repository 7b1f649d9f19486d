"""Out-of-core decoding of arbitrarily large HR outputs.

Counterpart of ``tpu_diinn/train/streaming.py``: ``predict_streaming``
runs the encoder once, then decodes fixed-height row bands on the device
and copies each band into one host array, so the device holds the LR
features and one band, whatever the size of the output (the reference's
demo2 outputs at x20 and beyond). The stacked LR conv of the fused decoder
runs once per image, not once per band (the JAX package recomputes it for
every band; the arithmetic is the same), and each band builds only its
own synthesis grid and index vectors.

Under a mesh (``mesh=``, the JAX ``shard_queries`` of each band over
'space'), each rank of the space axis decodes its clamped column stripe
of every band (``parallel/sharding.py``), the stripes are gathered, and
the axis's first rank assembles the image; the other ranks return None.
Every rank of the mesh calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_diinn_torch.nn.diinn import DIINN
from tpu_diinn_torch.parallel.mesh import Mesh, all_gather_cat
from tpu_diinn_torch.parallel.sharding import stripe_columns, stripe_width
from tpu_diinn_torch.train.task import denormalize, normalize


@torch.inference_mode()
def predict_streaming(net: DIINN, lr, size: Tuple[int, int], *,
                      band_rows: int = 512,
                      mesh: Optional[Mesh] = None) -> Optional[np.ndarray]:
    """[0, 1] LR image (B, h, w, 3), numpy or a tensor -> [0, 1] HR image
    of ``size`` as a float32 numpy array, decoded on ``net``'s device in
    bands of ``band_rows`` rows over the full width (over this rank's
    stripe under ``mesh``; None on a rank that does not assemble). Each
    band takes the decoder's window route (``ImplicitDecoder.windows``):
    the window kernel on the fused configuration at every ratio, the
    eager decode otherwise."""
    if not isinstance(net, DIINN):
        raise TypeError(f"predict_streaming decodes DIINN, got "
                        f"{type(net).__name__}")
    device = next(net.parameters()).device
    x = normalize(torch.as_tensor(lr, dtype=torch.float32, device=device))
    window = net.decoder.windows(net.encoder(x), size)
    h_out, w_out = size
    n, i = (mesh.space.size, mesh.space.index) if mesh else (1, 0)
    width = stripe_width(w_out, n)
    cols = (slice(0, w_out) if n == 1
            else stripe_columns(w_out, i * width, width))
    out = np.empty((x.shape[0], h_out, w_out, 3), np.float32) \
        if i == 0 else None
    for lo in range(0, h_out, band_rows):
        hi = min(lo + band_rows, h_out)
        y = torch.clamp(denormalize(window(lo, hi, cols)), 0.0, 1.0)
        if n > 1:
            y = all_gather_cat(y.contiguous(), mesh.space, dim=2)
        if out is not None:
            out[:, lo:hi] = y[:, :, :w_out].float().cpu().numpy()
    return out
