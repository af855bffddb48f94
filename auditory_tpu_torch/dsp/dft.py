"""DFT power spectrum (PyTorch counterpart of ``auditory_tpu/dsp/dft.py``).

- power[k] = re^2 + im^2 for k in [0, N/2] of the unnormalized forward DFT,
  as ``windows @ cos`` and ``windows @ sin`` against the host-built basis
  (no analysis window unless folded into the basis rows, dft/dft.go:42-59).
- log power = ln(power + LogOffSet), with the exact ``== 0`` -> LogMin floor
  (dft/dft.go:73-83).

- smoothing: the per-segment recurrence over steps (dft/dft.go:62-69).
- segment spans: each segment's samples as one row
  (:func:`segment_spans`), the input of the per-segment route through the
  fused kernel off the uniform grid.

The uniform-grid frontend of the pipeline is the fused kernel in
:mod:`auditory_tpu_torch.ops.framefft`; this module holds the plain tensor
stages its reference version is built from, and the gather frontend's
:func:`dft_power_pipeline` (off the uniform grid, or with smoothing).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import DFTParams

__all__ = [
    "floored_log", "power_spectrum", "log_power", "smooth_power",
    "dft_power_pipeline", "segment_spans",
]


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


def smooth_power(power: torch.Tensor, dft: DFTParams) -> torch.Tensor:
    """Temporal smoothing over the step axis (axis -2 of [..., steps, bins]):
    p'_0 = p_0 (step 0 is not smoothed, dft/dft.go:67), and for t > 0
    p'_t = prev_smooth * p'_{t-1} + cur_smooth * p_t.

    A loop over the steps, in the reference's order of operations (a closed
    form with cumulative products and divisions rounds differently)."""
    if dft.prev_smooth == 0.0:
        return power
    out = [power[..., 0, :]]
    for t in range(1, power.shape[-2]):
        out.append(dft.prev_smooth * out[-1] + dft.cur_smooth * power[..., t, :])
    return torch.stack(out, dim=-2)


def dft_power_pipeline(
    windows: torch.Tensor,
    dft: DFTParams,
    basis: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """windows [..., steps, W] -> (power, log_power) [..., steps, n_bins]:
    the DFT power against ``basis`` (the analysis window folded into its
    rows), the smoothing recurrence, and the log (zeros when
    ``comp_log_pow`` is off)."""
    p = smooth_power(power_spectrum(windows, basis), dft)
    lp = log_power(p, dft) if dft.comp_log_pow else torch.zeros_like(p)
    return p, lp


def segment_spans(signals: torch.Tensor, stride_samples: int, span: int,
                  offset0: int, n_segments: int) -> torch.Tensor:
    """[B, S] -> [B, n_segments, span]: slice s holds samples
    [offset0 + s*stride, offset0 + s*stride + span), zero where they lie
    left of sample 0 or past the buffer's end (sndenv.go:455-478; the JAX
    package's ``segment_spans``). Nothing is masked at the true lengths:
    the caller masks the steps that overrun them. A zero pad and one
    ``unfold``, so gradients flow to ``signals``; the result is a view of
    the padded copy (``reshape`` or ``contiguous`` materializes it)."""
    if n_segments <= 0 or span <= 0 or stride_samples <= 0:
        raise ValueError(
            f"n_segments={n_segments}, span={span} and stride="
            f"{stride_samples} must be > 0"
        )
    n = signals.shape[-1]
    pad_l = max(0, -offset0)
    reach = (n_segments - 1) * stride_samples + span
    first = offset0 + pad_l
    pad_r = max(0, first + reach - (n + pad_l))
    padded = F.pad(signals, (pad_l, pad_r))
    return padded[..., first:first + reach].unfold(-1, span, stride_samples)
