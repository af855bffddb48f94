"""Batched processing (counterpart of ``auditory_tpu/pipeline/batch.py``):
the ragged-length bucketing rule and :class:`BatchedSndEnv` over one padded
float batch on one device. Meshes, integer transfer and packed outputs are
not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

from .sndenv import SndEnv

__all__ = ["BatchedSndEnv", "bucket_length"]


def bucket_length(
    n: int,
    timing,
    min_samples: Optional[int] = None,
    quantum: int = 0,
) -> int:
    """Round a padded signal length up to the next stride boundary, so that
    utterances of similar length share one padded batch shape. ``quantum``
    (samples) coarsens the buckets further; masking makes the extra padding
    free."""
    stride = timing.stride_samples
    base = timing.segment_samples
    step = max(stride, quantum)
    if n <= base:
        out = base
    else:
        k = -(-(n - base) // step)
        out = base + k * step
        # keep the stride alignment the masking math expects
        out = base + (-(-(out - base) // stride)) * stride
    if min_samples is not None:
        out = max(out, min_samples)
    return out


class BatchedSndEnv:
    """The SndEnv pipeline over a padded utterance batch on ``env``'s
    device."""

    def __init__(self, env: SndEnv):
        self.env = env

    def process(self, signals, lengths, add_ms: int = 0):
        """signals [B, S] float (padded), lengths [B] true lengths ->
        (outputs with leading [B, seg] axes, seg_valid [B, seg]), plus the
        feature-stats dict when the env has ``feature_stats``. NumPy input
        is copied to the env's device."""
        dev = self.env.device
        signals = torch.as_tensor(signals, device=dev)
        if not signals.is_floating_point():
            raise ValueError(
                f"signals must be float, got {signals.dtype} (integer "
                "transfer is not ported yet)"
            )
        return self.env(signals, torch.as_tensor(lengths, device=dev), add_ms)
