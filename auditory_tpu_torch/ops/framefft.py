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

:func:`fused_frame_power_mel` is differentiable: it applies
:class:`FusedFramePowerMel`, whose forward launches the kernel for a CUDA
tensor and runs :func:`fused_frame_power_mel_reference`, the plain PyTorch
version, for a CPU tensor, and whose backward is the chain rule in plain
tensor ops (:func:`fused_frame_power_mel_backward`; the JAX package has no
backward kernel either: ``jax.grad`` differentiates its XLA frontend).
:data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..config import DFTParams, FilterBank
from ..dsp.dft import floored_log, power_spectrum
from ..dsp.frame import extract_windows

__all__ = [
    "LAUNCHES", "FusedFramePowerMel", "fused_frame_power_mel",
    "fused_frame_power_mel_backward", "fused_frame_power_mel_reference",
    "overlap_add", "pad_basis", "tf32_flags",
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
    raises), also when a gradient is wanted. A CPU tensor runs
    :func:`fused_frame_power_mel_reference`. Gradients flow to the signals
    and to the three constants through :class:`FusedFramePowerMel`."""
    _check(signals, step_samples, offset0, n_windows, cos_basis, sin_basis,
           mel_weights, n_bins, n_mel, dft)
    geom = (int(step_samples), int(offset0), int(n_windows), int(n_bins),
            int(n_mel), dft, fbank, (bool(emit[0]), bool(emit[1])))
    return FusedFramePowerMel.apply(
        signals, cos_basis, sin_basis, mel_weights, geom
    )


@contextlib.contextmanager
def tf32_flags(flags: Tuple[bool, bool]):
    """Set (cuBLAS, cuDNN) allow_tf32 inside the block, then restore."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class FusedFramePowerMel(torch.autograd.Function):
    """The fused frontend as an autograd node.

    Forward: the CUDA kernel for a CUDA tensor (never the plain version, a
    gradient wanted or not), the plain version for a CPU tensor. Backward:
    :func:`fused_frame_power_mel_backward`, run under the TF32 flags the
    forward ran under, so a forward inside the 'highest' tier has an IEEE
    float32 backward wherever ``backward()`` is called from. Only the
    signals and the three constants take gradients; a gated-off output
    (None) takes none."""

    @staticmethod
    def forward(ctx, signals, cos_basis, sin_basis, mel_weights, geom):
        step, offset0, n_windows, n_bins, n_mel, dft, fbank, emit = geom
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(signals, cos_basis, sin_basis, mel_weights)
        ctx.geom = geom
        ctx.tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        args = (signals, step, offset0, n_windows, cos_basis, sin_basis,
                mel_weights)
        kw = dict(n_bins=n_bins, n_mel=n_mel, dft=dft, fbank=fbank, emit=emit)
        if signals.device.type == "cpu":
            return fused_frame_power_mel_reference(*args, **kw)
        return _launch(*args, **kw)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_power, g_logp, g_mel):
        signals, cos_b, sin_b, mel_w = ctx.saved_tensors
        step, offset0, n_windows, n_bins, n_mel, dft, fbank, _ = ctx.geom
        with tf32_flags(ctx.tf32):
            grads = fused_frame_power_mel_backward(
                signals, step, offset0, n_windows, cos_b, sin_b, mel_w,
                g_power, g_logp, g_mel, n_bins=n_bins, n_mel=n_mel, dft=dft,
                fbank=fbank, needs=ctx.needs_input_grad[:4],
            )
        return grads + (None,)


def _launch(signals, step_samples, offset0, n_windows, cos_basis, sin_basis,
            mel_weights, *, n_bins, n_mel, dft, fbank, emit):
    """One launch of the CUDA kernel into new output tensors."""
    global LAUNCHES
    if signals.device.type != "cuda":
        raise ValueError(f"unsupported device {signals.device}")
    if signals.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, got {signals.dtype}")
    tensors = (signals, cos_basis, sin_basis, mel_weights)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    win, k_pad = cos_basis.shape
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


def _floored_log_grad(g: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    """d/dx of floored_log at ``shifted = x + offset``: g / shifted, and 0
    where ``shifted == 0`` (the floor is a constant there). NaN stays NaN."""
    return torch.where(shifted == 0, torch.zeros_like(g), g / shifted)


def overlap_add(frames: torch.Tensor, step: int, offset0: int,
                length: int) -> torch.Tensor:
    """The adjoint of the window gather: frames [B, n, win] starting at
    ``offset0 + step*i`` summed into [B, length]; positions left of 0 or at
    or past ``length`` are dropped (the forward zero-filled them).

    Deterministic: ``ceil(win/step)`` shifted adds of [B, n, <=step] slices
    over a [B, n + r - 1, step] buffer, each a plain elementwise add (no
    atomics, so the sum order is fixed)."""
    b, n, win = frames.shape
    r = -(-win // step)
    buf = frames.new_zeros((b, n + r - 1, step))
    for j in range(r):
        width = min(step, win - j * step)
        buf[:, j:j + n, :width] += frames[:, :, j * step:j * step + width]
    buf = buf.reshape(b, -1)  # buf[:, k] is sample offset0 + k
    out = frames.new_zeros((b, length))
    lo, hi = max(offset0, 0), min(offset0 + buf.shape[1], length)
    if hi > lo:
        out[:, lo:hi] = buf[:, lo - offset0:hi - offset0]
    return out


def fused_frame_power_mel_backward(
    signals: torch.Tensor,
    step_samples: int,
    offset0: int,
    n_windows: int,
    cos_basis: torch.Tensor,
    sin_basis: torch.Tensor,
    mel_weights: torch.Tensor,
    g_power: Optional[torch.Tensor],
    g_logp: Optional[torch.Tensor],
    g_mel: Optional[torch.Tensor],
    *,
    n_bins: int,
    n_mel: int,
    dft: DFTParams,
    fbank: FilterBank,
    needs: Tuple[bool, bool, bool, bool] = (True, False, False, False),
) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of the fused frontend w.r.t. (signals, cos_basis,
    sin_basis, mel_weights) given the output gradients (None = no gradient
    for that output), in plain tensor ops: the windows and their re/im
    parts are recomputed from the signals (the gated outputs need not be
    kept), then

      g_p   = g_power + g_logp / (p + LogOffSet) + (g_mel / (melsum + LogOff)) @ W^T
      g_re  = 2 re g_p,  g_im = 2 im g_p
      g_win = g_re @ cos^T + g_im @ sin^T  -> overlap-added into the signal

    with the ``== 0`` floors taking no gradient, and NaN mel weights giving
    NaN, as autodiff of the plain version gives. ``needs`` selects which of
    the four gradients to compute (the others are None)."""
    if g_power is None and g_logp is None and g_mel is None:
        return (None,) * 4
    win, k_pad = cos_basis.shape
    starts = offset0 + step_samples * torch.arange(
        n_windows, device=signals.device
    )
    windows = extract_windows(signals, starts, win)   # [B, n, win]
    cos_m, sin_m = cos_basis[:, :n_bins], sin_basis[:, :n_bins]
    re = torch.matmul(windows, cos_m)
    im = torch.matmul(windows, sin_m)
    p = re * re + im * im
    g_p = torch.zeros_like(p) if g_power is None else g_power.clone()
    if g_logp is not None and dft.comp_log_pow:
        g_p += _floored_log_grad(g_logp, p + dft.log_offset)
    g_w = None
    if g_mel is not None:
        w = mel_weights[:n_bins, :n_mel]
        g_sum = _floored_log_grad(g_mel, torch.matmul(p, w) + fbank.log_off)
        g_p += torch.matmul(g_sum, w.T)
        if needs[3]:
            g_w = mel_weights.new_zeros(mel_weights.shape)
            g_w[:n_bins, :n_mel] = torch.matmul(
                p.reshape(-1, n_bins).T, g_sum.reshape(-1, n_mel)
            )
    g_re = 2.0 * re * g_p
    g_im = 2.0 * im * g_p
    del re, im, p, g_p

    def basis_grad(g_part):
        out = cos_basis.new_zeros(cos_basis.shape)
        out[:, :n_bins] = torch.matmul(
            windows.reshape(-1, win).T, g_part.reshape(-1, n_bins)
        )
        return out

    g_cos = basis_grad(g_re) if needs[1] else None
    g_sin = basis_grad(g_im) if needs[2] else None
    g_sig = None
    if needs[0]:
        g_win = torch.matmul(g_re, cos_m.T) + torch.matmul(g_im, sin_m.T)
        g_sig = overlap_add(g_win, step_samples, offset0, signals.shape[-1])
    return g_sig, g_cos, g_sin, g_w


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
