"""The seeded pool of source frames.

The picture is that of ``uvg266_tpu_torch/tools/bdrate.py`` ``synth_clip``
(the same family as ``bench.py``'s): a ramp, two moving sinusoids and a
moving 32x32 checkerboard in luma, moving sinusoids in chroma, with
uniform noise of -6..5 in luma and -3..2 in chroma. Here the seed is an
argument and the noise comes from a ``torch.Generator`` on the device the
pool is made on, in a few large calls; every seed gives the same picture
sizes and motion, and only the noise differs.
"""
from __future__ import annotations

import numpy as np
import torch


def make_pool(width: int, height: int, n: int, seed: int, device) -> list:
    """n frames of width x height 8-bit 4:2:0 as (y, u, v) uint8 arrays."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    f64 = torch.float64
    t = torch.arange(n, dtype=f64, device=dev)[:, None, None]
    yy = torch.arange(height, dtype=f64, device=dev)[None, :, None]
    xx = torch.arange(width, dtype=f64, device=dev)[None, None, :]
    y = (xx * 0.3 + yy * 0.2 + 40 * torch.sin((xx + 3 * t) / 16.0)
         + 30 * torch.cos((yy - 2 * t) / 11.0)
         + 20 * torch.remainder(torch.div(xx, 32, rounding_mode="floor")
                                + torch.div(yy, 32, rounding_mode="floor")
                                + t, 2))
    y = y + torch.randint(-6, 6, (n, height, width), generator=g, device=dev)
    xc, yc = xx[..., ::2], yy[:, ::2]
    u = 128 + 20 * torch.sin((xc + 5 * t) / 24.0) \
        + torch.randint(-3, 3, (n, height // 2, width // 2), generator=g,
                        device=dev)
    v = 128 + 20 * torch.cos((yc + 4 * t) / 21.0) \
        + torch.randint(-3, 3, (n, height // 2, width // 2), generator=g,
                        device=dev)
    planes = [p.clamp(0, 255).to(torch.uint8).cpu().numpy()
              for p in (y, u, v)]
    return [tuple(np.ascontiguousarray(p[i]) for p in planes)
            for i in range(n)]


def order(i: int, n: int, how: str) -> int:
    """The pool index of the i-th frame of the sequence: ``cycle`` wraps
    round, ``pingpong`` runs forward and back so that motion never jumps."""
    if how == "cycle" or n < 2:
        return i % n
    j = i % (2 * n - 2)
    return j if j < n else 2 * n - 2 - j
