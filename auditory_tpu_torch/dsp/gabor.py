"""Gabor feature extraction over the mel spectrogram (PyTorch counterpart of
``auditory_tpu/dsp/gabor.py``; reference agabor.Convolve,
agabor/gabor.go:225-315):

- NaN inputs are replaced with 0.5 before filtering (gabor.go:279-281). The
  reference mel stage can legitimately emit NaN (see dsp/design.mel_design).
- valid-mode strided 2-D cross-correlation of the filter bank with the
  [freq, time] mel segment (``F.conv2d``).
- half-rectified two-channel output: act = Gain * |sum| routed to the 'on'
  channel if sum >= 0 else 'off' (gabor.go:284-308).
- the 2-D layout [2*fIdx, flt + tIdx*nf] / byTime [2*fIdx, tIdx + tMax*flt]
  (gabor.go:286-300), a pure transpose/reshape of the conv output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import GaborSet

__all__ = ["gabor_out_counts", "convolve", "to_layout_2d"]


def gabor_out_counts(
    mel_shape: Tuple[int, int],
    gset: GaborSet,
    out_pools: Optional[Tuple[int, int]] = None,
) -> Tuple[int, int]:
    """(f_count, t_count) of gabor output positions, per the reference loop
    bounds (gabor.go:231-262). mel_shape is (n_mel_freq, n_steps).

    out_pools = (poolsY, poolsX) triggers the 4-D clamping logic; None uses
    the 2-D logic.
    """
    n_freq, n_time = mel_shape
    if out_pools is None:
        x = n_time - gset.size_x
        t_max = 1 if (x == 0 or x < gset.stride_x) else x + 1
        y = n_freq - gset.size_y
        f_max = 1 if (y == 0 or y < gset.stride_y) else y + 1
    else:
        pools_y, pools_x = out_pools
        t_max = min(pools_x * gset.stride_x, n_time - gset.stride_x)
        f_max = min(pools_y * gset.stride_y, n_freq - gset.stride_y)
    t_count = max(0, -(-t_max // gset.stride_x))  # ceil(t_max / stride)
    f_count = max(0, -(-f_max // gset.stride_y))
    if out_pools is not None:
        # clamp to the VALID conv range so this public count always matches
        # what convolve() emits (the JAX package's DOCUMENTED DEVIATION)
        t_count = min(
            t_count, max(0, (n_time - gset.size_x) // gset.stride_x + 1)
        )
        f_count = min(
            f_count, max(0, (n_freq - gset.size_y) // gset.stride_y + 1)
        )
    return f_count, t_count


def convolve(
    mel_seg: torch.Tensor, filters: torch.Tensor, gset: GaborSet
) -> torch.Tensor:
    """mel_seg [..., n_freq, n_steps], filters [n_filters, size_y, size_x]
    -> gabor activations [..., f_count, t_count, 2, n_filters] (float32)."""
    n_freq, n_time = mel_seg.shape[-2], mel_seg.shape[-1]
    if n_time < gset.size_x:
        # the reference silently leaves its output all-zero here
        # (agabor/gabor.go:231-236); the JAX package raises, and so does this
        raise ValueError(
            "gabor filter width cannot exceed the mel matrix width "
            f"({gset.size_x} > {n_time}); the reference would silently "
            "produce all-zero gabor output here"
        )
    if n_freq < gset.size_y:
        raise ValueError(
            "gabor filter height cannot exceed the mel band count "
            f"({gset.size_y} > {n_freq})"
        )
    f_count, t_count = gabor_out_counts((n_freq, n_time), gset)

    x = torch.where(torch.isnan(mel_seg), torch.full_like(mel_seg, 0.5), mel_seg)
    batch_shape = x.shape[:-2]
    x = x.reshape((-1, 1) + x.shape[-2:])  # [N, 1, n_freq, n_time]
    k = filters.to(x.dtype)[:, None]       # [nf, 1, sy, sx]
    out = F.conv2d(x, k, stride=(gset.stride_y, gset.stride_x))
    out = out[:, :, :f_count, :t_count]   # [N, nf, fI, tI]

    act = (torch.abs(out) * gset.gain).to(torch.float32)
    pos = out >= 0
    zero = torch.zeros((), dtype=act.dtype, device=act.device)
    res = torch.stack(
        [torch.where(pos, act, zero), torch.where(pos, zero, act)], dim=2
    )  # [N, nf, 2, fI, tI]
    res = res.permute(0, 3, 4, 2, 1)  # [N, fI, tI, 2, nf]
    return res.reshape(batch_shape + res.shape[1:])


def to_layout_2d(
    gabor4d: torch.Tensor, by_time: bool, t_max_strides: int
) -> torch.Tensor:
    """[..., fI, tI, 2, nf] -> the reference 2-D layout [..., 2*fI, X]
    (gabor.go:286-300).

    Default: X = flt + tIdx*nf  -> [..., fI, 2, tI, nf] reshaped.
    byTime:  X = tIdx + t_max_strides*flt -> [..., fI, 2, nf, tI] reshaped,
    where t_max_strides may exceed tI, leaving zero columns exactly like the
    reference's pre-zeroed output tensor.
    """
    *b, fi, ti, two, nf = gabor4d.shape
    x = gabor4d.movedim(-2, -3)  # [..., fI, 2, tI, nf]
    if not by_time:
        return x.reshape(*b, fi * two, ti * nf)
    x = x.movedim(-1, -2)  # [..., fI, 2, nf, tI]
    if t_max_strides > ti:
        x = F.pad(x, (0, t_max_strides - ti))
    return x.reshape(*b, fi * two, nf * t_max_strides)
