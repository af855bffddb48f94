"""Fused frame extraction + DFT power + log + mel filterbank on the uniform
window grid ``start_i = step*i + offset0``: the Hopper port of the Pallas
kernel ``auditory_tpu/ops/framefft.py::fused_frame_power_mel``.

The kernel is CUDA C++ (``csrc/framefft.cu``), built for ``sm_90a`` at first
use and bound with ctypes (:mod:`._build`). One kernel replaces the Pallas
grouped, masked and merged modes: those exist because Mosaic only loads at
128-aligned offsets and budgets VMEM, while Hopper loads at any offset. It
computes in FP32 FMA.

Semantics (dft/dft.go:62-85, mel/mel.go:120-153), per window of each row:
- zero fill left of sample 0 and past the buffer's end (the caller masks
  steps that overrun the true length, as the JAX pipeline does);
- power[k] = re^2 + im^2 of the unnormalized DFT, bins 0..N/2;
- log power = ln(power + LogOffSet) with the exact ==0 -> LogMin floor;
- mel = ln(sum_k W[k,f] power[k] + LogOff), ==0 -> LogMin; NaN weights
  propagate. The renorm clamp, if on, is the caller's (as in JAX).

:func:`fused_frame_power_mel` launches the kernel for a CUDA tensor and
runs :func:`fused_frame_power_mel_reference`, the plain PyTorch version, for
a CPU tensor. :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DFTParams, FilterBank
from ..dsp.dft import floored_log, power_spectrum
from ..dsp.frame import extract_windows

__all__ = [
    "LAUNCHES", "fused_frame_power_mel", "fused_frame_power_mel_reference",
    "pad_basis",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_MAX_SHARED_BYTES = 232448  # per block on sm_90, opted in above 48 KB
_INT32_MAX = 2**31 - 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_basis(
    cos_m: np.ndarray, sin_m: np.ndarray, mel_w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad DFT basis columns (bins) and mel rows/cols to multiples of 128.

    mel_w comes in as [n_mel, n_bins] (design layout) and is returned
    transposed-padded as [k_pad, m_pad] with zero rows for the padding bins,
    so padded power bins contribute exactly 0 to every mel sum. The dtype
    of the inputs is kept (the JAX version returns float32)."""
    n_bins = cos_m.shape[1]
    n_mel = mel_w.shape[0]
    k_pad = _round_up(n_bins, 128)
    m_pad = _round_up(n_mel, 128)
    cos_p = np.zeros((cos_m.shape[0], k_pad), dtype=cos_m.dtype)
    sin_p = np.zeros((sin_m.shape[0], k_pad), dtype=sin_m.dtype)
    cos_p[:, :n_bins] = cos_m
    sin_p[:, :n_bins] = sin_m
    w_p = np.zeros((k_pad, m_pad), dtype=mel_w.dtype)
    w_p[:n_bins, :n_mel] = mel_w.T
    return cos_p, sin_p, w_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/framefft.cu`` at first use."""
    from . import _build

    lib = _build.load("framefft")
    lib.framefft_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.framefft_shared_bytes.restype = ctypes.c_int
    lib.framefft_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float] * 4
        + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.framefft_launch.restype = ctypes.c_int
    return lib


def _check(signals, step, offset0, n_windows, cos_b, sin_b, mel_w, n_bins,
           n_mel, dft):
    if dft.prev_smooth != 0.0:
        raise ValueError("fused_frame_power_mel requires prev_smooth == 0")
    if signals.ndim != 2:
        raise ValueError(f"signals must be [B, S], got {tuple(signals.shape)}")
    win, k_pad = cos_b.shape
    if sin_b.shape != cos_b.shape:
        raise ValueError(
            f"cos/sin basis shapes differ: {tuple(cos_b.shape)} vs "
            f"{tuple(sin_b.shape)}"
        )
    if not 0 < n_bins <= k_pad or mel_w.shape[0] != k_pad:
        raise ValueError(
            f"basis [win, k_pad]={tuple(cos_b.shape)}, mel weights "
            f"{tuple(mel_w.shape)} and n_bins={n_bins} disagree"
        )
    if not 0 < n_mel <= mel_w.shape[1]:
        raise ValueError(
            f"n_mel={n_mel} does not fit mel weights {tuple(mel_w.shape)}"
        )
    if step <= 0 or n_windows <= 0:
        raise ValueError(f"step={step}, n_windows={n_windows} must be > 0")
    last_end = offset0 + (n_windows - 1) * step + win
    if abs(offset0) > _INT32_MAX or last_end > _INT32_MAX:
        raise ValueError(
            f"window grid reaches sample {last_end}: beyond int32 indexing"
        )
    dtypes = {t.dtype for t in (signals, cos_b, sin_b, mel_w)}
    devices = {t.device for t in (signals, cos_b, sin_b, mel_w)}
    if len(dtypes) != 1 or len(devices) != 1:
        raise ValueError(
            f"inputs must share one dtype and device, got {dtypes}, {devices}"
        )
    return win, k_pad


def fused_frame_power_mel(
    signals: torch.Tensor,   # [B, S]
    step_samples: int,
    offset0: int,            # start of window 0 (may be negative)
    n_windows: int,
    cos_basis: torch.Tensor,  # [win, k_pad]
    sin_basis: torch.Tensor,  # [win, k_pad]
    mel_weights: torch.Tensor,  # [k_pad, m_pad]
    *,
    n_bins: int,
    n_mel: int,
    dft: DFTParams,
    fbank: FilterBank,
    emit: Tuple[bool, bool] = (True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
    """Fused frontend on the uniform grid start_i = step*i + offset0.

    Returns (power, log_power, log_mel): [B, n_windows, n_bins] x2 and
    [B, n_windows, n_mel]. ``emit`` = (power, log_power) gates the two wide
    outputs; a gated-off output is returned as None and never written.

    A CUDA tensor launches the kernel (float32, contiguous; anything else
    raises). A CPU tensor runs :func:`fused_frame_power_mel_reference`."""
    global LAUNCHES
    win, k_pad = _check(signals, step_samples, offset0, n_windows, cos_basis,
                        sin_basis, mel_weights, n_bins, n_mel, dft)
    if signals.device.type == "cpu":
        return fused_frame_power_mel_reference(
            signals, step_samples, offset0, n_windows, cos_basis, sin_basis,
            mel_weights, n_bins=n_bins, n_mel=n_mel, dft=dft, fbank=fbank,
            emit=emit,
        )
    if signals.device.type != "cuda":
        raise ValueError(f"unsupported device {signals.device}")
    if signals.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, got {signals.dtype}")
    tensors = (signals, cos_basis, sin_basis, mel_weights)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    b, s = signals.shape
    m_pad = mel_weights.shape[1]
    if not 0 < b <= 65535 or s > _INT32_MAX:
        raise ValueError(f"signals [B, S]={tuple(signals.shape)} out of range")

    lib = _lib()
    smem = lib.framefft_shared_bytes(step_samples, win, n_bins)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(
            f"win={win}, step={step_samples}, n_bins={n_bins} need {smem} "
            f"bytes of shared memory per block (limit {_MAX_SHARED_BYTES})"
        )
    emit_power, emit_logp = bool(emit[0]), bool(emit[1])
    new = lambda k: torch.empty((b, n_windows, k), dtype=torch.float32,
                                device=signals.device)
    power = new(n_bins) if emit_power else None
    logp = new(n_bins) if emit_logp else None
    mel = new(n_mel)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(signals.device):
        stream = torch.cuda.current_stream(signals.device).cuda_stream
        err = lib.framefft_launch(
            ptr(signals), ptr(cos_basis), ptr(sin_basis), ptr(mel_weights),
            ptr(power), ptr(logp), ptr(mel),
            b, s, step_samples, offset0, n_windows, win, n_bins, k_pad,
            n_mel, m_pad,
            float(dft.log_offset), float(dft.log_min), float(fbank.log_off),
            float(fbank.log_min), int(bool(dft.comp_log_pow)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"framefft kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return power, logp, mel


def fused_frame_power_mel_reference(
    signals: torch.Tensor,
    step_samples: int,
    offset0: int,
    n_windows: int,
    cos_basis: torch.Tensor,
    sin_basis: torch.Tensor,
    mel_weights: torch.Tensor,
    *,
    n_bins: int,
    n_mel: int,
    dft: DFTParams,
    fbank: FilterBank,
    emit: Tuple[bool, bool] = (True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
    """The plain PyTorch version of :func:`fused_frame_power_mel` (any
    device, float32 or float64): window gather, ``windows @ cos`` and
    ``windows @ sin``, power, log power and log-mel."""
    starts = offset0 + step_samples * torch.arange(
        n_windows, device=signals.device
    )
    windows = extract_windows(signals, starts, cos_basis.shape[0])
    power = power_spectrum(
        windows, (cos_basis[:, :n_bins], sin_basis[:, :n_bins])
    )
    mel = floored_log(
        torch.matmul(power, mel_weights[:n_bins, :n_mel]),
        fbank.log_off, fbank.log_min,
    )
    logp = None
    if emit[1]:
        logp = (
            floored_log(power, dft.log_offset, dft.log_min)
            if dft.comp_log_pow else torch.zeros_like(power)
        )
    return (power if emit[0] else None), logp, mel
