"""Phone/unit-segment analysis pipeline, the ``examples/gaborview`` path
(PyTorch counterpart of ``auditory_tpu/pipeline/segments.py``; reference
examples/gaborview/gbv.go).

One time slice [SegmentStart, SegmentEnd] of an utterance -- typically one
TIMIT phone -- goes through the DFT/mel/MFCC/gabor pipeline with the
gaborview quirks:

- optional *resize* of the slice to the gabor filter's size and stride
  (gbv.go:456-479);
- the reference's literal "round up to a step" arithmetic
  ``segmentMs += stepMs * (int(segmentMs) % int(stepMs))`` (gbv.go:489-491);
- BorderSteps defaults to 0 (gbv.go:330-336);
- energy mode and delta mode 'gaborview' (gbv.go:553-560, 590-592);
- the 2-D gabor layout with byTime=True (gbv.go:300) and KWTALayer only
  (gbv.go:839-849).

The slice's windows start at ``start_sample + step*(i - border)``: a uniform
grid, so the frontend is the fused kernel on a CUDA device (its plain
version on the CPU), and the steps whose window ends past the signal are
masked after it with ``where``. With ``prev_smooth > 0`` the smoothing
recurrence runs over the slice's steps, so that case takes the window
gather (:func:`..dsp.dft.dft_power_pipeline`), as ``SndEnv`` does.
PyTorch runs eagerly, so nothing is compiled or cached per slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import (
    DFTParams,
    GaborSet,
    KWTAParams,
    MelParams,
    default_gabor_specs,
    msec_to_samples,
    resolve_device,
)
from ..convert import constants_from_numpy
from ..dsp import design
from ..dsp.dft import dft_power_pipeline
from ..dsp.frame import extract_windows
from ..dsp.gabor import convolve, gabor_out_counts, to_layout_2d
from ..dsp.mel import apply_mel, energy, mel_renorm, mfcc_dct, mfcc_deltas
from ..nn.kwta import kwta_layer
from ..ops.framefft import fused_frame_power_mel
from .sndenv import PRECISION_TIERS, precision_tier

__all__ = [
    "SegmentWindowParams",
    "resize_segment",
    "SegmentPipeline",
    "compare_segments",
]

_INT32_MAX = np.iinfo(np.int32).max


@dataclass(frozen=True)
class SegmentWindowParams:
    """gaborview WinParams (gbv.go:203-240); defaults per WinDefaults
    (gbv.go:330-336)."""

    win_ms: float = 25.0
    step_ms: float = 10.0
    border_steps: int = 0
    resize: bool = True


def resize_segment(
    start_ms: float,
    end_ms: float,
    step_ms: float,
    gset: GaborSet,
) -> Tuple[float, float]:
    """gbv.go:456-479: widen [start, end] to align with the gabor grid."""
    duration = end_ms - start_ms
    size_x_ms = float(gset.size_x) * step_ms
    stride_x_ms = float(gset.stride_x) * step_ms
    add = 0.0
    if duration < size_x_ms:
        add = size_x_ms - duration
    else:
        d = duration - size_x_ms
        rem = float(int(d) % int(stride_x_ms))
        if rem > 0:
            add = stride_x_ms - rem
    if start_ms - add < 0:
        end_ms += add
    else:
        start_ms -= add / 2
        end_ms += add / 2
    return start_ms, end_ms


class SegmentPipeline:
    """Process time slices of an utterance (one phone/CV at a time, or a
    batch of equal-length slices) on ``device``.

    DOCUMENTED DEVIATION (as in the JAX package): gbv.go's ProcessSetup
    force-sets ``Mel.FBank.NFilters = 32`` (gbv.go:497) and ``LoHz = 0``
    (gbv.go:509); this class honors arbitrary ``MelParams``. To reproduce a
    literal gaborview run, pass the defaults (32 filters, lo_hz=0).

    The JAX package's ``spectrum_method`` has no counterpart: the frontend is
    the kernel on CUDA and its plain version on the CPU, with
    ``DFTParams.window_fn`` folded into the DFT basis either way."""

    def __init__(
        self,
        sample_rate: int,
        wparams: SegmentWindowParams = SegmentWindowParams(),
        dft: DFTParams = DFTParams(),
        mel: Optional[MelParams] = None,
        gabor: Optional[GaborSet] = None,
        kwta: Optional[KWTAParams] = None,
        by_time: bool = True,
        dtype: torch.dtype = torch.float32,
        matmul_precision: str = "highest",
        device=None,
    ):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if matmul_precision not in PRECISION_TIERS:
            raise ValueError(
                f"matmul_precision must be one of {PRECISION_TIERS}, got "
                f"{matmul_precision!r}"
            )
        device = resolve_device(device)
        self.sample_rate = sample_rate
        self.wparams = wparams
        self.dft = dft
        self.mel = mel if mel is not None else MelParams()
        # gbv.go InitGabors (gbv.go:318-357): 8x8, stride (6,3), gain 1.5
        # and the 4-orientation spec grid; a bare GaborSet() has no specs
        self.gabor = (
            gabor if gabor is not None
            else GaborSet(specs=default_gabor_specs())
        )
        self.kwta = kwta if kwta is not None else KWTAParams()
        self.by_time = by_time
        self.dtype = dtype
        self.matmul_precision = matmul_precision
        self.device = device

        self.win_samples = msec_to_samples(wparams.win_ms, sample_rate)
        self.step_samples = msec_to_samples(wparams.step_ms, sample_rate)
        self.n_bins = self.win_samples // 2 + 1
        self.mel_des = design.mel_design(
            self.mel.fbank, self.win_samples, sample_rate
        )
        self.dct_mat = design.dct1_matrix(self.mel.fbank.n_filters)
        self.gabor_bank = design.gabor_filters(self.gabor)
        self.analysis_win = design.analysis_window(
            dft.window_fn, self.win_samples
        )
        consts = constants_from_numpy(
            self.mel_des.weights, self.dct_mat, self.gabor_bank,
            *design.dft_matrices(self.win_samples), self.analysis_win,
        )
        self.consts = {
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in consts.items()
        }

    # gbv.go:489-492 -- the reference's literal "round up" arithmetic
    def steps_total(self, start_ms: float, end_ms: float) -> int:
        segment_ms = end_ms - start_ms
        segment_ms = segment_ms + self.wparams.step_ms * float(
            int(segment_ms) % int(self.wparams.step_ms)
        )
        steps = int(segment_ms / self.wparams.step_ms)
        return steps + 2 * self.wparams.border_steps

    def setup(
        self, start_ms: float, end_ms: float
    ) -> Tuple[float, float, int]:
        """Apply resize + step rounding; returns (start_ms, end_ms, steps)."""
        if end_ms <= start_ms:
            # gbv.go:451-454: "SegmentEnd must be greater than SegmentStart"
            raise ValueError(
                f"SegmentEnd ({end_ms}) must be greater than SegmentStart "
                f"({start_ms}) (gbv.go:451-454)"
            )
        if self.wparams.resize:
            start_ms, end_ms = resize_segment(
                start_ms, end_ms, self.wparams.step_ms, self.gabor
            )
        return start_ms, end_ms, self.steps_total(start_ms, end_ms)

    def process(
        self, signal, start_ms: float, end_ms: float
    ) -> Dict[str, torch.Tensor]:
        """ProcessSetup + Process for one [start, end] slice (gbv.go:371-625).

        ``signal`` may be 1-D (one utterance; outputs have no batch axis) or
        [B, S] (B equal-length utterances sharing the slice; every output
        except the shared ``step_valid`` gains a leading batch axis); NumPy
        input is copied to the device. Outputs are tensors in the reference
        layouts ([n_bins, steps], [n_mel, steps], [steps], ...)."""
        start_ms, end_ms, steps = self.setup(start_ms, end_ms)
        if not torch.is_tensor(signal):
            signal = torch.as_tensor(np.asarray(signal))
        if signal.ndim not in (1, 2):
            raise ValueError(
                f"signal must be 1-D or [B, S], got shape {tuple(signal.shape)}"
            )
        squeeze = signal.ndim == 1
        sig2 = signal[None] if squeeze else signal
        if sig2.shape[-1] > _INT32_MAX - self.win_samples:
            # int32 window starts would wrap (the same refusal as the JAX
            # package and the kernel's wrapper)
            raise ValueError(
                f"signal length {sig2.shape[-1]} exceeds the int32 "
                "window-start range; slice the utterance first"
            )
        # window i starts at start_sample + step*(i - border)
        offset0 = (msec_to_samples(start_ms, self.sample_rate)
                   - self.step_samples * self.wparams.border_steps)
        sig2 = sig2.to(device=self.device, dtype=self.dtype).contiguous()
        with precision_tier(self.matmul_precision):
            out = self._forward(sig2, steps, offset0)
        if squeeze:
            out = {k: (v[0] if v is not None and k != "step_valid" else v)
                   for k, v in out.items()}
        return out

    def _forward(self, signal, steps, offset0):
        c = self.consts
        fb = self.mel.fbank
        n_mel = fb.n_filters
        starts = offset0 + self.step_samples * torch.arange(
            steps, device=signal.device
        )
        valid = starts + self.win_samples <= signal.shape[-1]
        vmask = valid[:, None]
        zero = torch.zeros((), dtype=self.dtype, device=signal.device)
        if self.dft.prev_smooth == 0.0:
            power, logp, mel_vals = fused_frame_power_mel(
                signal, self.step_samples, offset0, steps, c["dft_cos"],
                c["dft_sin"], c["mel_w"], n_bins=self.n_bins, n_mel=n_mel,
                dft=self.dft, fbank=fb,
            )
            if fb.renorm_effective:
                mel_vals = mel_renorm(mel_vals, fb)
        else:
            # the smoothing reads the invalid steps' windows: zero them
            # first, as the JAX pipeline does
            windows = extract_windows(
                signal, starts, self.win_samples,
                torch.full((signal.shape[0],), signal.shape[-1],
                           device=signal.device),
            )
            power, logp = dft_power_pipeline(
                windows, self.dft,
                (c["dft_cos"][:, :self.n_bins], c["dft_sin"][:, :self.n_bins]),
            )
            mel_vals = apply_mel(
                torch.where(vmask, power, zero),
                c["mel_w"][:self.n_bins, :n_mel].T, fb,
            )
        # steps whose window overruns the signal: zero (the JAX pipeline
        # zeroes their windows before the spectrum and masks mel after its
        # log)
        power = torch.where(vmask, power, zero)
        logp = torch.where(vmask, logp, zero)
        mel_vals = torch.where(vmask, mel_vals, zero)
        en = energy(logp, "gaborview")  # [B, steps]
        mfcc = deltas = ddeltas = None
        if self.mel.mfcc:
            mfcc = mfcc_dct(mel_vals, c["dct"], self.mel.n_coefs)
            mfcc = torch.where(vmask, mfcc, zero)
            mfcc = torch.cat([en[..., None], mfcc[..., 1:]], dim=-1)
            if self.mel.deltas:
                deltas = mfcc_deltas(mfcc, npn=2, mode="gaborview")
                ddeltas = mfcc_deltas(deltas, npn=2, mode="gaborview")

        mel_fs = mel_vals.transpose(-1, -2)  # [B, n_mel, steps]
        gab4 = convolve(mel_fs, c["gabor"], self.gabor)
        _, tms = gabor_out_counts((n_mel, steps), self.gabor, None)
        graw = to_layout_2d(gab4, self.by_time, tms)  # [B, Y, X]
        gk = kwta_layer(self.kwta, graw, batch_ndim=1) if self.kwta.on else graw
        swap = lambda x: x.transpose(-1, -2) if x is not None else None
        return {
            "power_segment": swap(power),
            "log_power_segment": swap(logp),
            "mel_fbank_segment": mel_fs,
            "energy": en,
            "mfcc_segment": swap(mfcc),
            "mfcc_deltas": swap(deltas),
            "mfcc_delta_deltas": swap(ddeltas),
            "gabor_raw": graw,
            "gabor_kwta": gk,
            "step_valid": valid,
        }


def _activity_summary(arr: np.ndarray) -> Dict[str, float]:
    """NaN-aware side stats: the NaN mel-triangle quirk makes NaN a
    legitimate value, and a NaN max/mean would leak non-strict JSON."""
    finite = arr[np.isfinite(arr)] if arr.size else arr
    return {
        "shape": list(arr.shape),
        "max_abs": float(np.max(np.abs(finite))) if finite.size else 0.0,
        "mean": float(finite.mean()) if finite.size else 0.0,
        "active_frac": float(np.mean(arr != 0)) if arr.size else 0.0,
        **(
            {"nan_frac": float(np.isnan(arr).mean())}
            if arr.size and np.isnan(arr).any()
            else {}
        ),
    }


def _host(v) -> np.ndarray:
    v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return v.astype(np.float64) if v.dtype == bool else v


def compare_segments(
    pipe_a: "SegmentPipeline",
    pipe_b: "SegmentPipeline",
    signal,
    start_ms: float,
    end_ms: float,
    signal_b=None,
    start_ms_b: Optional[float] = None,
    end_ms_b: Optional[float] = None,
) -> Dict[str, object]:
    """A/B dual-parameter comparison, the gaborview app's core capability
    (gbv.go:243-258 WParams1/2, PParams1/2, GParams1/2; dual result tabs
    gbv.go:1209-1313): the same slice (or two slices, like CurSnd1/CurSnd2)
    through two independent parameter stacks.

    Returns ``{"a": outputs, "b": outputs, "diff": {key: {...}}}``; each
    diff entry carries both sides' shape/max-abs/mean/active-fraction, the
    active-fraction delta and, when the shapes agree, the max-abs
    difference over positions finite on both sides plus ``nan_mismatch``
    when the NaN positions differ. A key off on one side is
    ``{"only_in": side}``; off on both, absent."""
    out_a = pipe_a.process(signal, start_ms, end_ms)
    out_b = pipe_b.process(
        signal if signal_b is None else signal_b,
        start_ms if start_ms_b is None else start_ms_b,
        end_ms if end_ms_b is None else end_ms_b,
    )
    diff: Dict[str, Dict[str, object]] = {}
    for k in sorted(set(out_a) | set(out_b)):
        va, vb = out_a.get(k), out_b.get(k)
        if va is None and vb is None:
            continue
        if va is None or vb is None:
            diff[k] = {"only_in": "a" if vb is None else "b"}
            continue
        na, nb = _host(va), _host(vb)
        sa, sb = _activity_summary(na), _activity_summary(nb)
        entry: Dict[str, object] = {
            "a": sa,
            "b": sb,
            "active_frac_delta": sb["active_frac"] - sa["active_frac"],
        }
        if na.shape == nb.shape:
            d = np.abs(na.astype(np.float64) - nb.astype(np.float64))
            finite = np.isfinite(d)
            entry["max_abs_diff"] = (
                float(d[finite].max()) if finite.any() else 0.0
            )
            mismatch = np.isnan(na) != np.isnan(nb)
            if mismatch.any():
                entry["nan_mismatch"] = int(mismatch.sum())
        diff[k] = entry
    return {"a": out_a, "b": out_b, "diff": diff}
