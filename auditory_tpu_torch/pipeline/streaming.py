"""Streaming multi-segment processing, the ``examples/processspeech`` path
(counterpart of ``auditory_tpu/pipeline/streaming.py``).

The reference's processspeech app (examples/processspeech/processspeech.go)
predates SndEnv and differs from it in ways reproduced here:

- step offsets use the multi-stride formula
  ``stepsBack = stepsPerStride*(strides-1) + BorderSteps`` with
  ``strides = SegmentMs/StrideMs`` and ``stepsPerStride = StrideMs/StepMs``
  (processspeech.go:276-282), instead of SndEnv's plain BorderSteps.
- segments advance by SegmentSamples (``start = segment*SegmentSamples +
  offset``, processspeech.go:375-377), not StrideSamples.
- a ``MoreSegments`` cursor streams through the file one segment per call
  (processspeech.go:332-352), restarting from the top when exhausted.
- multi-channel sounds are processed per channel into [freq, step, channel]
  tensors (processspeech.go:208-217); here the channel axis is a leading
  batch axis.

The spectrum is the window gather and ``windows @ basis`` with the analysis
window folded into the basis, in float32 and float64 alike (the JAX package
computes this path in XLA too, with a gather and a matmul in float32); the
fused frontend kernel does not run here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import (
    DFTParams, GaborSet, MelParams, WindowParams, resolve_device,
)
from ..convert import constants_from_numpy
from ..dsp import design
from ..dsp.dft import dft_power_pipeline
from ..dsp.frame import extract_windows, pad_signal
from ..dsp.gabor import convolve
from ..dsp.mel import apply_mel, mfcc_dct
from .sndenv import SndEnv, precision_tier

__all__ = ["StreamingProcessor"]


class StreamingProcessor(nn.Module):
    """Segment-cursor streaming over a (possibly multi-channel) signal.

    Usage::

        sp = StreamingProcessor(wparams, dft, mel, gabor, sample_rate,
                                channels, device="cuda")
        sp.load(signal)              # [S] or [channels, S]
        while sp.more_segments:
            out = sp.process_segment()   # tensors for the current segment

    The host-built constants are registered buffers under the names
    :class:`SndEnv` uses (``dft_cos``, ``dft_sin``, ``mel_w``, ``dct``,
    ``gabor``); :meth:`load_constants` replaces them.
    """

    def __init__(
        self,
        wparams: WindowParams,
        dft: DFTParams,
        mel: MelParams,
        gabor: GaborSet,
        sample_rate: int,
        channels: int = 1,
        dtype: torch.dtype = torch.float32,
        pad_value: float = 0.0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.wparams = wparams
        self.dft = dft
        self.mel = mel
        self.gabor_set = gabor
        self.sample_rate = sample_rate
        self.channels = channels
        self.dtype = dtype
        self.pad_value = pad_value

        self.timing = wparams.derive(sample_rate)
        # processspeech.go:276-282 multi-stride offsets
        strides = int(wparams.segment_ms / wparams.stride_ms)
        steps_per_stride = int(wparams.stride_ms / wparams.step_ms)
        steps_back = steps_per_stride * (strides - 1) + wparams.border_steps
        self.steps_back = steps_back
        self.step_offsets = np.asarray(
            [
                self.timing.step_samples * (i - steps_back)
                for i in range(self.timing.segment_steps)
            ],
            dtype=np.int64,
        )

        win = self.timing.win_samples
        self.mel_des = design.mel_design(mel.fbank, win, sample_rate)
        self.dct_mat = design.dct1_matrix(mel.fbank.n_filters)
        self.gabor_bank = design.gabor_filters(gabor)
        # optional analysis window (opt-in extension; the reference is
        # rectangular), folded into the DFT basis rows as in SndEnv
        self.analysis_win = design.analysis_window(dft.window_fn, win)
        consts = constants_from_numpy(
            self.mel_des.weights, self.dct_mat, self.gabor_bank,
            *design.dft_matrices(win), self.analysis_win,
        )
        for name, value in consts.items():
            self.register_buffer(
                name, torch.as_tensor(value, dtype=dtype, device=device)
            )
        self.register_buffer(
            "_offsets", torch.as_tensor(self.step_offsets, device=device),
            persistent=False,
        )

        self.segment = -1
        self.more_segments = False
        self.signal: Optional[np.ndarray] = None
        self._signal_dev: Optional[torch.Tensor] = None

    # one way to carry constants in, shared with SndEnv
    device = SndEnv.device
    load_constants = SndEnv.load_constants

    # processspeech.go:406-422 (same arithmetic as sndenv.go's Pad --
    # frame.pad_len is the single source of truth)
    def pad(self, signal: np.ndarray) -> np.ndarray:
        return pad_signal(np.asarray(signal), self.timing, self.pad_value)

    def load(self, signal: np.ndarray, pad: bool = False) -> None:
        """Load a new sound; resets the segment cursor
        (processspeech.go:307-329 ProcessSound semantics, minus the GUI).

        ``pad=False`` default, faithfully: the reference CALLS Pad but
        DISCARDS its return value (processspeech.go:319 -- `sp.Pad(...)`
        returns the padded slice, never assigned), so every length check in
        the app sees the unpadded signal. ``pad=True`` applies the padding
        Pad was evidently meant to apply (an opt-in extension)."""
        signal = np.asarray(signal)
        if signal.ndim == 1:
            signal = signal[None, :]
        if signal.shape[0] != self.channels:
            raise ValueError(
                f"signal has {signal.shape[0]} channels, the processor "
                f"{self.channels}"
            )
        if pad:
            signal = self.pad(signal)
        if signal.shape[-1] > np.iinfo(np.int32).max - self.timing.win_samples:
            # same loud refusal as frame.window_starts: int32 window starts
            # would wrap on a >2^31-sample signal
            raise ValueError(
                f"signal length {signal.shape[-1]} exceeds the int32 "
                "window-start range; split the stream"
            )
        self.signal = signal
        # upload ONCE: process_segment runs per segment, and re-converting
        # the full host array each call would re-pay the host->device
        # transfer hundreds of times on long files
        self._signal_dev = torch.as_tensor(signal, device=self.device).to(
            self.dtype
        )
        self.segment = -1
        self.more_segments = True

    def _program(self, segment: int) -> Dict[str, Optional[torch.Tensor]]:
        t = self.timing
        n = self._signal_dev.shape[-1]
        n_bins, n_mel = t.n_bins, self.mel.fbank.n_filters
        # [1, steps]; starts per processspeech.go:375-377
        starts = (self._offsets + segment * t.segment_samples)[None, :]
        valid = starts + t.win_samples <= n
        vmask = valid[..., None]
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        windows = extract_windows(self._signal_dev, starts, t.win_samples)
        windows = torch.where(vmask, windows, zero)  # [ch, 1, steps, W]
        power, logp = dft_power_pipeline(
            windows, self.dft,
            (self.dft_cos[:, :n_bins], self.dft_sin[:, :n_bins]),
        )
        power = torch.where(vmask, power, zero)
        logp = torch.where(vmask, logp, zero)
        mel_vals = apply_mel(
            power, self.mel_w[:n_bins, :n_mel].T, self.mel.fbank
        )
        mel_vals = torch.where(vmask, mel_vals, zero)
        mfcc = None
        if self.mel.mfcc:
            # all n_filters coefficients, as the JAX package computes them
            mfcc = mfcc_dct(mel_vals, self.dct, n_mel)
            mfcc = torch.where(vmask, mfcc, zero)

        mel_fs = mel_vals.transpose(-1, -2)  # [ch, 1, n_mel, steps]
        gab4 = convolve(mel_fs, self.gabor, self.gabor_set, out_pools=None)

        def refshape(x):  # [ch, 1, steps, k] -> [k, steps, ch]
            return x[:, 0].permute(2, 1, 0)

        return {
            "power_segment": refshape(power),
            "log_power_segment": refshape(logp),
            "mel_fbank_segment": refshape(mel_vals),
            "mfcc_segment": refshape(mfcc) if mfcc is not None else None,
            # processspeech 5-D layout [ch, y, x, 2, nf] (processspeech.go:265)
            "gabor": gab4[:, 0],
            "step_valid": valid[0],  # [steps]
        }

    def process_segment(self) -> Dict[str, Optional[torch.Tensor]]:
        """Process the next segment (processspeech.go:332-352). When the
        sound is exhausted the cursor restarts from segment 0 on the next
        call, exactly like the reference's ProcessSegment re-entering
        ProcessSound on the same file (processspeech.go:333-335); check
        ``more_segments`` to drive the loop."""
        if self.signal is None:
            raise RuntimeError("load() a sound first")
        if not self.more_segments:
            # reference re-enters ProcessSound on the same file
            self.segment = -1
            self.more_segments = True
        self.segment += 1
        with precision_tier("highest"):
            out = self._program(self.segment)
        t = self.timing
        n = self.signal.shape[-1]
        # SoundToWindow failure semantics (processspeech.go:340-345): any
        # step whose window overruns the signal sets MoreSegments=false. The
        # validity is host arithmetic on the same starts, so the cursor
        # never waits for the device.
        # DOCUMENTED DEVIATION (as in the JAX package): the reference still
        # runs the DFT/mel/DCT on the FAILING step with the previous step's
        # stale window and never re-zeroes the segment tensors; we zero the
        # overrunning steps and report them in step_valid instead.
        ends = self.segment * t.segment_samples + self.step_offsets + t.win_samples
        if not bool(np.all(ends <= n)):
            self.more_segments = False
        remaining = n - t.segment_samples * (self.segment + 1)
        if remaining < t.segment_samples:
            self.more_segments = False
        return out
