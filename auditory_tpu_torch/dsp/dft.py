"""DFT power spectrum (PyTorch counterpart of ``auditory_tpu/dsp/dft.py``).

- power[k] = re^2 + im^2 for k in [0, N/2] of the unnormalized forward DFT,
  as ``windows @ cos`` and ``windows @ sin`` against the host-built basis
  (no analysis window unless folded into the basis rows, dft/dft.go:42-59).
- log power = ln(power + LogOffSet), with the exact ``== 0`` -> LogMin floor
  (dft/dft.go:73-83).

The uniform-grid frontend of the pipeline is the fused kernel in
:mod:`auditory_tpu_torch.ops.framefft`; this module holds the plain tensor
stages its reference version is built from.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import DFTParams

__all__ = ["floored_log", "power_spectrum", "log_power"]


def floored_log(x: torch.Tensor, offset: float, floor: float) -> torch.Tensor:
    """ln(x + offset), with an exactly-zero argument mapped to ``floor``
    (the reference's log chains in dft/dft.go:73-83 and mel/mel.go:134-143)."""
    shifted = x + offset
    return torch.where(
        shifted == 0,
        torch.full((), floor, dtype=x.dtype, device=x.device),
        torch.log(torch.where(shifted == 0, torch.ones_like(shifted), shifted)),
    )


def power_spectrum(
    windows: torch.Tensor, basis: Tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """[..., W] windows -> [..., K] DFT power against (cos [W, K], sin [W, K])."""
    cos_m, sin_m = basis
    re = torch.matmul(windows, cos_m)
    im = torch.matmul(windows, sin_m)
    return re * re + im * im


def log_power(power: torch.Tensor, dft: DFTParams) -> torch.Tensor:
    """ln(power + LogOffSet) with ==0 -> LogMin (dft/dft.go:73-83)."""
    return floored_log(power, dft.log_offset, dft.log_min)
