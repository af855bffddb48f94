"""Mel filterbank, MFCC cepstrum, energy and delta features (PyTorch
counterpart of ``auditory_tpu/dsp/mel.py``).

- :func:`apply_mel` -- mel.FilterDft (mel/mel.go:120-153) as one matmul
  against the dense triangle matrix from :mod:`.design`, followed by the
  +LogOff / ==0 -> LogMin / ln / optional renorm-clamp chain.
- :func:`mfcc_dct` -- mel.CepstrumDct (mel/mel.go:192-212): unnormalized DCT-I
  matmul, coef0 replaced by ln(1 + c0^2), first NCoefs kept.
- :func:`energy` -- the SndEnv Energy computation *including the reference's
  indexing quirk* (sndenv.go:360-366); see the mode notes there.
- :func:`mfcc_deltas` -- the accumulating delta recurrence (sndenv.go:379-432)
  as one matmul against the host-built linear operator
  (:func:`delta_operator`, copied verbatim from the JAX package), with the
  reachability mask that propagates NaN exactly as the recurrence does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FilterBank
from .dft import floored_log

__all__ = [
    "apply_mel", "mel_renorm", "mfcc_dct", "energy", "mfcc_deltas",
    "delta_operator",
]


def apply_mel(
    power: torch.Tensor, mel_weights: torch.Tensor, fbank: FilterBank
) -> torch.Tensor:
    """power [..., n_bins] -> log-mel [..., n_filters]; ``mel_weights`` is
    the design layout [n_filters, n_bins]."""
    val = floored_log(
        torch.matmul(power, mel_weights.T), fbank.log_off, fbank.log_min
    )
    if fbank.renorm_effective:
        val = mel_renorm(val, fbank)
    return val


def mel_renorm(val: torch.Tensor, fbank: FilterBank) -> torch.Tensor:
    """The reference's renorm clamp (mel/mel.go:144-149): scale into
    [renorm_min, renorm_max] and clip to [0, 1]."""
    val = (val - fbank.renorm_min) * fbank.renorm_scale
    return torch.clamp(val, 0.0, 1.0)


def mfcc_dct(
    mel_vals: torch.Tensor, dct_mat: torch.Tensor, n_coefs: int
) -> torch.Tensor:
    """log-mel [..., n_filters] -> MFCC [..., n_coefs] (mel/mel.go:192-212)."""
    out = torch.matmul(mel_vals, dct_mat.T)
    c0 = out[..., :1]
    out = torch.cat([torch.log(1.0 + c0 * c0), out[..., 1:]], dim=-1)
    return out[..., :n_coefs]


def energy(log_power_seg: torch.Tensor, mode: str = "sndenv") -> torch.Tensor:
    """log_power_seg [..., steps, n_bins] -> energy [..., steps].

    mode='sndenv' (reference sndenv.go:360-366): Energy[s] = sum_t LPS[s, t]
    where LPS is the [freq, step] matrix -- i.e. sum over *steps* of frequency
    row s. mode='gaborview' reproduces gbv.go:553-560 (sum over the first
    `steps` frequency rows at step s); mode='spectral' is the corrected sum
    over all frequency bins at step s.
    """
    steps = log_power_seg.shape[-2]
    n_bins = log_power_seg.shape[-1]
    if mode == "sndenv":
        if steps > n_bins:
            raise ValueError(
                "energy mode 'sndenv' requires segment_steps <= n_bins "
                "(the reference would index out of range)"
            )
        return torch.sum(log_power_seg[..., :, :steps], dim=-2)
    if mode == "gaborview":
        if steps > n_bins:
            raise ValueError("energy mode 'gaborview' requires steps <= n_bins")
        return torch.sum(log_power_seg[..., :steps], dim=-1)
    if mode == "spectral":
        return torch.sum(log_power_seg, dim=-1)
    raise ValueError(f"unknown energy mode: {mode}")


@functools.lru_cache(maxsize=32)
def delta_operator(
    steps: int, ncoef: int, npn: int = 2, mode: str = "sndenv"
):
    """The reference delta recurrence (sndenv.go:379-432) as an explicit
    linear operator: returns ``(M, reach)``, both
    [steps, ncoef, steps, ncoef] float64 host arrays, with
    ``delta[t, c] = sum_{s,i} M[t, c, s, i] * mfcc[s, i]`` and ``reach``
    marking which sources the recurrence touches (NaN propagation).

    Derivation: the (i', n') source term appears in the accumulating
    prv/nxt sums of output coefficient i for every tap n with
    (i', n') <= (i, n) in the reference's i-major/n-minor loop order, each
    weighted by n; source steps are edge-clamped. Equality with the cumsum
    formulation (``auditory_tpu.dsp.mel.mfcc_deltas_reference``) is
    asserted in the JAX package's tests."""
    M = np.zeros((steps, ncoef, steps, ncoef), dtype=np.float64)
    # reach[t, c, s, i]: the recurrence *touches* source (s, i) for output
    # (t, c) -- needed for exact NaN propagation, because touched terms can
    # cancel in M (e.g. clamped prev/next landing on the same step) yet a
    # NaN source still poisons the reference's accumulation
    reach = np.zeros((steps, ncoef, steps, ncoef), dtype=np.float64)
    if mode == "sndenv":
        scale = 1.0 / float(2 * npn * npn)
    elif mode == "gaborview":
        scale = float(npn * npn) / 2.0
    else:
        raise ValueError(f"unknown delta mode: {mode}")
    for i in range(ncoef):          # output coefficient
        for ip in range(i + 1):     # source coefficient i' <= i contributes
            for n_src in range(1, npn + 1):
                # taps n of output i that include (ip, n_src):
                # ip < i -> all n; ip == i -> n >= n_src
                lo_n = 1 if ip < i else n_src
                w = sum(range(lo_n, npn + 1)) * scale
                for s in range(steps):
                    sp = min(max(s - n_src, 0), steps - 1)
                    sx = min(max(s + n_src, 0), steps - 1)
                    M[s, i, sp, ip] -= w
                    M[s, i, sx, ip] += w
                    reach[s, i, sp, ip] = 1.0
                    reach[s, i, sx, ip] = 1.0
    return M, reach


@functools.lru_cache(maxsize=32)
def _delta_tensors(steps, ncoef, npn, mode, dtype, device):
    """(M, reach) flattened to [steps*ncoef, steps*ncoef] tensors, cached
    per device so a forward pass copies nothing from the host."""
    M, reach = delta_operator(steps, ncoef, npn, mode)
    n = steps * ncoef
    as_t = lambda a: torch.as_tensor(a.reshape(n, n), dtype=dtype, device=device)
    return as_t(M), as_t(reach)


def mfcc_deltas(
    mfcc_seg: torch.Tensor, npn: int = 2, mode: str = "sndenv"
) -> torch.Tensor:
    """mfcc_seg [..., steps, n_coefs] -> deltas of the same shape, as one
    matmul against the host-built :func:`delta_operator`."""
    *batch, steps, ncoef = mfcc_seg.shape
    m, r = _delta_tensors(
        steps, ncoef, npn, mode, mfcc_seg.dtype, mfcc_seg.device
    )
    flat = mfcc_seg.reshape(*batch, steps * ncoef)
    # exact NaN propagation: the recurrence poisons exactly the outputs it
    # *touches* from a NaN source (mel's NaN-triangle quirk), while a plain
    # matmul would spread NaN through zero-weight terms too. Sanitize, then
    # re-inject via the reachability mask (a second tiny matmul).
    nan_src = torch.isnan(flat)
    clean = torch.where(nan_src, torch.zeros_like(flat), flat)
    out = torch.matmul(clean, m.T)
    poisoned = torch.matmul(nan_src.to(flat.dtype), r.T) > 0
    out = torch.where(poisoned, torch.full_like(out, float("nan")), out)
    return out.reshape(*batch, steps, ncoef)
