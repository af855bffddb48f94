"""Window extraction (PyTorch counterpart of ``auditory_tpu/dsp/frame.py``).

The window grid is a host constant (NumPy, copied verbatim from the JAX
package so the two cannot disagree on it):

- step start offsets: ``StepSamples * (i - BorderSteps)`` (sndenv.go:247-251)
- segment starts: ``segment * StrideSamples`` (sndenv.go:441)
- negative starts are left-zero-padded (sndenv.go:455-478)
- a window whose end overruns the signal is *invalid*: the reference breaks
  the step loop and leaves every later column zero (sndenv.go:353-359); since
  starts increase monotonically the failing steps are exactly those with
  ``start + win > len``, so masking them reproduces the break semantics.

:func:`extract_windows` gathers the windows of a [..., S] tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DerivedTiming, msec_to_samples

__all__ = ["window_starts", "extract_windows", "pad_signal", "tail_len", "pad_len"]


def window_starts(
    timing: DerivedTiming, seg_cnt: int, add_ms: int = 0
) -> np.ndarray:
    """[seg_cnt, segment_steps] int32 window start indices (host constant)."""
    add = msec_to_samples(float(add_ms), timing.sample_rate)
    segs = np.arange(seg_cnt, dtype=np.int64)[:, None] * timing.stride_samples
    offs = np.asarray(timing.step_offsets, dtype=np.int64)[None, :]
    starts = segs + offs + add
    if starts.size and int(starts.max()) + timing.win_samples >= 2**31:
        # int32 device indices would wrap to negative -> every window would
        # silently read the left zero-pad; refuse loudly instead (shard a
        # >2^31-sample utterance over segments/files first)
        raise ValueError(
            f"window grid reaches sample {int(starts.max())}: beyond int32 "
            "device indexing; split the utterance"
        )
    return starts.astype(np.int32)


def extract_windows(
    signal: torch.Tensor, starts: torch.Tensor, win_samples: int
) -> torch.Tensor:
    """signal [..., S], starts [...grid] integer -> windows
    [..., *grid, W], zero where a window reaches left of sample 0 or past
    the buffer's end. Step validity against a true length is the caller's
    mask (see :func:`window_starts`)."""
    s_total = signal.shape[-1]
    idx = starts.to(torch.int64)[..., None] + torch.arange(
        win_samples, device=signal.device
    )
    inside = (idx >= 0) & (idx < s_total)
    gathered = signal[..., idx.clamp(0, max(s_total - 1, 0))]
    return torch.where(inside, gathered, 0.0)


def tail_len(n: int, timing: DerivedTiming) -> int:
    """Samples beyond the last full stride (sndenv.go:503-507; Go %)."""
    if timing.stride_samples <= 0:
        # mirror the Go integer-division-by-zero panic (sndenv.go:506): a
        # sub-sample stride_ms rounds to 0 samples at low rates, and
        # np.fmod(x, 0) would silently return 0 instead of refusing
        raise ValueError(
            f"stride_samples={timing.stride_samples}: the stride rounds to "
            "zero samples at this rate (the reference panics here)"
        )
    temp = n - timing.segment_samples
    return int(np.fmod(temp, timing.stride_samples))


def pad_len(n: int, timing: DerivedTiming) -> int:
    """Right-pad length so ``n`` divides evenly into strides
    (sndenv.go:510-519; the single source of truth for the Pad arithmetic,
    also used by the online flush)."""
    if timing.step_samples <= 0:
        raise ValueError(
            f"step_samples={timing.step_samples}: the step rounds to zero "
            "samples at this rate (the reference panics here)"
        )
    tail = tail_len(n, timing)
    return (
        timing.segment_samples
        - timing.step_samples
        - int(np.fmod(tail, timing.step_samples))
    )


def pad_signal(
    signal: np.ndarray, timing: DerivedTiming, value: float = 0.0
) -> np.ndarray:
    """Right-pad so length divides evenly into strides (sndenv.go:510-519).

    Pads the LAST axis, so [..., S] batched/multi-channel signals pad each
    row (a len()-based version would measure the leading axis and corrupt
    multi-dimensional input)."""
    n = pad_len(signal.shape[-1], timing)
    pad_shape = signal.shape[:-1] + (n,)
    return np.concatenate(
        [signal, np.full(pad_shape, value, dtype=signal.dtype)], axis=-1
    )
