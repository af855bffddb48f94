"""Neighborhood inhibition, Inhib4 (PyTorch counterpart of
``auditory_tpu/nn/neigh_inhib.py``; a behavioral port of
``emer/vision/kwta.NeighInhib``, used at reference sound/sndenv.go:303-311).

Each unit receives extra inhibition from the *same feature* (same polarity,
same filter) at the nearest neighbor positions orthogonal to the filter's
orientation, which reduces redundant activation along an edge's width. It
operates on the 4-D pooled layout [..., fIdx, tIdx, polarity, filter] (the
reference skips it for the 2-D layout, gbv.go:823-828).

:func:`orthogonal_offsets` is a host function copied verbatim from the JAX
package (``tests/test_torch_design.py`` holds the copy equal to it).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import NeighInhibParams

__all__ = ["orthogonal_offsets", "inhib4"]


def orthogonal_offsets(orientations_deg: Sequence[float]) -> np.ndarray:
    """[n_filters, 2] integer (dy, dx) unit offsets orthogonal to each
    filter's orientation."""
    offs = []
    for deg in orientations_deg:
        orth = math.radians(deg + 90.0)
        dx = int(round(math.cos(orth)))
        dy = int(round(math.sin(orth)))
        if dx == 0 and dy == 0:
            dy = 1
        offs.append((dy, dx))
    return np.asarray(offs, dtype=np.int32)


def inhib4(
    params: NeighInhibParams,
    act: torch.Tensor,
    orientations_deg: Sequence[float],
) -> torch.Tensor:
    """act [..., fIdx, tIdx, 2, n_filters] -> ext_gi of the same shape.

    ext_gi = Gi * max(act at pos +offset, act at pos -offset) for the same
    (polarity, filter); out-of-bounds neighbors contribute 0."""
    if not params.on:
        return torch.zeros_like(act)
    offs = orthogonal_offsets(orientations_deg)
    n_filters = act.shape[-1]
    if offs.shape[0] != n_filters:
        raise ValueError(
            f"need one orientation per filter: {offs.shape[0]} orientations "
            f"for {n_filters} filters"
        )
    cols = []
    for k in range(n_filters):
        dy, dx = int(offs[k, 0]), int(offs[k, 1])
        a = act[..., k]  # [..., fIdx, tIdx, 2]
        cols.append(torch.maximum(_shift2d(a, dy, dx), _shift2d(a, -dy, -dx)))
    return params.gi * torch.stack(cols, dim=-1)


def _shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[i] = x[i - d] along the negative axis ``dim``, zero-filled."""
    n = x.shape[dim]
    if d == 0:
        return x
    if abs(d) >= n:
        return torch.zeros_like(x)
    kept = x.narrow(dim, 0, n - d) if d > 0 else x.narrow(dim, -d, n + d)
    # F.pad lists (before, after) pairs from the last axis inward
    pad = [0, 0] * (-dim - 1) + ([d, 0] if d > 0 else [0, -d])
    return F.pad(kept, pad)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift along the (fIdx, tIdx) axes (-3, -2), zero-filling the border."""
    return _shift(_shift(x, dy, -3), dx, -2)
