"""The SndEnv pipeline in PyTorch: WAV signal -> power/log-power -> mel ->
MFCC(+deltas) -> gabor -> kWTA, for all segments of a padded batch of
utterances (counterpart of ``auditory_tpu/pipeline/sndenv.py``; reference
``sound.SndEnv``, sound/sndenv.go:73-497).

The frontend runs once per distinct window of the shared global step grid
(the windows of consecutive segments overlap) through the fused
frame+DFT+power+log+mel kernel (:mod:`auditory_tpu_torch.ops.framefft`);
segments are then a row gather of the small spectra. Outputs keep the
reference's per-segment shapes with leading [batch, segment] axes, e.g.
``power_segment[b, seg]`` == the reference's PowerSegment [freq, step] after
ProcessSegment(seg) on utterance b.

This slice covers the uniform window grid (stride a multiple of step,
prev_smooth == 0) and the 2-D gabor layout; the rest raises
NotImplementedError.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import SndEnvConfig
from ..convert import constants_from_numpy
from ..dsp import design
from ..dsp.dft import log_power
from ..dsp.frame import pad_signal, window_starts
from ..dsp.gabor import convolve, gabor_out_counts, to_layout_2d
from ..dsp.mel import energy, mel_renorm, mfcc_dct, mfcc_deltas
from ..nn.kwta import kwta_layer
from ..ops.framefft import fused_frame_power_mel

__all__ = ["SndEnvOutputs", "SndEnv", "precision_tier"]

PRECISION_TIERS = ("highest", "high", "default")


@contextlib.contextmanager
def precision_tier(tier: str):
    """Contraction precision of the float32 matmuls and convolutions run
    inside the block, restoring the previous settings on exit.

    'highest' and 'high' switch TF32 off for both ``torch.matmul`` (cuBLAS)
    and convolutions (cuDNN, where PyTorch leaves TF32 on by default): IEEE
    float32, which meets the JAX tiers' grades (exact f32 and ~1.5e-5 rel).
    'default' allows TF32 for both (~5e-4 rel, finer than the TPU default
    tier's bf16 operands). The CPU ignores both flags."""
    if tier not in PRECISION_TIERS:
        raise ValueError(
            f"matmul_precision must be one of {PRECISION_TIERS}, got {tier!r}"
        )
    allow = tier == "default"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclass
class SndEnvOutputs:
    """Pipeline outputs; leading axes [batch, segment] (batch squeezed away
    by :meth:`SndEnv.process`).

    Shapes follow the reference tensors (sndenv.go:95-163):
      power_segment      [.., n_bins, steps]     <- PowerSegment
      log_power_segment  [.., n_bins, steps]     <- LogPowerSegment
      mel_fbank_segment  [.., n_mel, steps]      <- MelFBankSegment
      energy             [.., steps]             <- Energy
      mfcc_segment       [.., n_coefs, steps]    <- MFCCSegment
      mfcc_deltas        [.., n_coefs, steps]    <- MFCCDeltas
      mfcc_delta_deltas  [.., n_coefs, steps]    <- MFCCDeltaDeltas
      gabor_raw          [.., units_y, units_x]  <- GborOutput (2-D layout)
      gabor_kwta         [.., units_y, units_x]  <- GborKwta
      step_valid         [.., steps] bool        (True where the reference
                                                  would have processed the step)
      mel_fbank_global   [.., n_flat, n_mel]     (opt-in: the deduped global
                                                  step grid mel_fbank_segment
                                                  is gathered from, UNMASKED)
    """

    power_segment: Optional[torch.Tensor]
    log_power_segment: Optional[torch.Tensor]
    mel_fbank_segment: Optional[torch.Tensor]
    energy: Optional[torch.Tensor]
    mfcc_segment: Optional[torch.Tensor]
    mfcc_deltas: Optional[torch.Tensor]
    mfcc_delta_deltas: Optional[torch.Tensor]
    gabor_raw: Optional[torch.Tensor]
    gabor_kwta: Optional[torch.Tensor]
    step_valid: Optional[torch.Tensor]
    mel_fbank_global: Optional[torch.Tensor] = None


class SndEnv(nn.Module):
    """Configured pipeline for a fixed sample rate.

    Usage::

        env = SndEnv(cfg, sample_rate=16000, device="cuda")
        out = env.process(env.pad(signal))      # all segments of one utterance
        out, seg_valid = env(signals, lengths)  # a [B, S] batch

    The host-built constants are registered buffers (``dft_cos``,
    ``dft_sin``, ``mel_w``, ``dct``, ``gabor``), so ``env.to(device)``
    moves them; :meth:`load_constants` replaces them.
    """

    ALL_OUTPUTS = (
        "power_segment",
        "log_power_segment",
        "mel_fbank_segment",
        "energy",
        "mfcc_segment",
        "mfcc_deltas",
        "mfcc_delta_deltas",
        "gabor_raw",
        "gabor_kwta",
        "step_valid",
        "mel_fbank_global",
    )

    def __init__(
        self,
        cfg: SndEnvConfig,
        sample_rate: int,
        dtype: torch.dtype = torch.float32,
        outputs: Optional[Tuple[str, ...]] = None,
        channels: int = 1,
        feature_stats: bool = False,
        matmul_precision: str = "highest",
        device=None,
    ):
        """``outputs``: which SndEnvOutputs fields to return (None = all);
        fields left out are not computed where nothing else needs them.
        ``channels``: interleaved channels of the signal, used only by the
        SegCnt arithmetic (sndenv.go:263-265). ``feature_stats``: also return
        per-mel-band moments (sum, sumsq, count over all valid steps).
        ``matmul_precision``: see :func:`precision_tier`."""
        super().__init__()
        if outputs is not None:
            unknown = set(outputs) - set(self.ALL_OUTPUTS)
            if unknown:
                raise ValueError(f"unknown outputs: {sorted(unknown)}")
        self.outputs = tuple(outputs) if outputs is not None else None
        if cfg.gabor.n_filters == 0:
            gabor_keys = {"gabor_raw", "gabor_kwta"}
            requested = set(self.outputs) if self.outputs else gabor_keys
            if requested & gabor_keys:
                raise ValueError(
                    "cfg.gabor has no active specs (empty or all Off) but "
                    "gabor outputs are requested; pass outputs=(...) "
                    "without gabor_raw/gabor_kwta for a mel/MFCC-only "
                    "pipeline, or provide gabor specs"
                )
        if matmul_precision not in PRECISION_TIERS:
            raise ValueError(
                "matmul_precision must be 'highest', 'high' or 'default', "
                f"got {matmul_precision!r}"
            )
        if (cfg.gbor_out_pools_x > 0) != (cfg.gbor_out_pools_y > 0):
            raise ValueError(
                "GborOutPoolsX & GborOutPoolsY must both be == 0 or > 0 "
                "(2D or 4D; sndenv.go:220-222)"
            )
        if cfg.gbor_out_pools_x > 0:
            raise NotImplementedError(
                "the 4-D pooled gabor layout (with neighbor inhibition) is "
                "not ported yet; use gbor_out_pools_x = gbor_out_pools_y = 0"
            )
        if cfg.dft.prev_smooth != 0.0:
            raise NotImplementedError(
                "dft.prev_smooth > 0 needs the per-window gather frontend, "
                "which is not ported yet"
            )
        timing = cfg.params.derive(sample_rate)
        if timing.stride_samples <= 0 or (
            timing.stride_samples % timing.step_samples
        ):
            raise NotImplementedError(
                f"stride {timing.stride_samples} is not a multiple of step "
                f"{timing.step_samples} samples: the off-grid gather "
                "frontend is not ported yet"
            )
        device = torch.device(device if device is not None else "cpu")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is False"
            )
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.channels = int(channels)
        self.feature_stats = bool(feature_stats)
        self.matmul_precision = matmul_precision
        self.dtype = dtype
        self.timing = timing

        # host-built constants (float64 NumPy)
        self.mel_des = design.mel_design(
            cfg.mel.fbank, timing.win_samples, sample_rate
        )
        self.dct_mat = design.dct1_matrix(cfg.mel.fbank.n_filters)
        self.gabor_bank = design.gabor_filters(cfg.gabor)
        self.analysis_win = design.analysis_window(
            cfg.dft.window_fn, timing.win_samples
        )
        consts = constants_from_numpy(
            self.mel_des.weights, self.dct_mat, self.gabor_bank,
            *design.dft_matrices(timing.win_samples), self.analysis_win,
        )
        for name, value in consts.items():
            self.register_buffer(
                name, torch.as_tensor(value, dtype=dtype, device=device)
            )
        self._geometry: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    # constants and geometry
    # ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.dft_cos.device

    def load_constants(self, consts: Dict[str, np.ndarray]) -> None:
        """Replace the constant buffers with ``consts`` (the dict of
        :func:`auditory_tpu_torch.convert.constants_from_numpy`); shapes
        must match this configuration's."""
        for name, value in consts.items():
            old = getattr(self, name)
            if tuple(value.shape) != tuple(old.shape):
                raise ValueError(
                    f"constant {name!r}: shape {tuple(value.shape)} does not "
                    f"match this configuration's {tuple(old.shape)}"
                )
            setattr(
                self, name,
                torch.as_tensor(value, dtype=self.dtype, device=self.device),
            )

    def gabor_output_shape(self) -> Tuple[int, int]:
        cfg = self.cfg
        fc, tc = gabor_out_counts(
            (cfg.mel.fbank.n_filters, self.timing.segment_steps), cfg.gabor
        )
        uy = cfg.gbor_out_units_y or fc * 2
        ux = cfg.gbor_out_units_x or tc * cfg.gabor.n_filters
        return (uy, ux)

    def seg_cnt(self, n_samples: int) -> int:
        return self.timing.seg_cnt(n_samples, self.channels)

    def _window_grid(self, seg_cnt: int, add_ms: int):
        """The (segment, step) -> window-start geometry on the shared global
        step grid: segment s, step i is global window s*(stride/step) + i
        (border windows of consecutive segments are shared, so the frontend
        runs once per distinct window). Returns (flat_starts [n_flat],
        map_idx [seg, steps] into flat, starts [seg, steps])."""
        t = self.timing
        starts_np = window_starts(t, seg_cnt, add_ms)
        sps = t.stride_samples // t.step_samples
        n_global = (seg_cnt - 1) * sps + t.segment_steps
        g_starts = (
            t.step_samples * np.arange(n_global, dtype=np.int64)
            + starts_np[0, 0]
        ).astype(np.int32)
        map_idx = (
            np.arange(seg_cnt, dtype=np.int64)[:, None] * sps
            + np.arange(t.segment_steps, dtype=np.int64)[None, :]
        )
        if not (g_starts[map_idx] == starts_np).all():
            raise AssertionError("window grid does not match window_starts")
        return g_starts, map_idx, starts_np

    def _grid_for(self, n_samples: int, add_ms: int):
        """Per-length geometry as device tensors (cached)."""
        key = (n_samples, add_ms, self.device)
        if key not in self._geometry:
            seg = self.seg_cnt(n_samples)
            if seg <= 0:
                raise ValueError(
                    f"a signal of {n_samples} samples has no segments"
                )
            flat, map_idx, starts = self._window_grid(seg, add_ms)
            dev = self.device
            self._geometry[key] = (
                int(flat[0]), int(flat.shape[0]),
                torch.as_tensor(map_idx, device=dev),
                torch.as_tensor(starts.astype(np.int64) + self.timing.win_samples,
                                device=dev),
            )
        return self._geometry[key]

    # ------------------------------------------------------------------
    # the batched program
    # ------------------------------------------------------------------

    def _want(self, *fields: str) -> bool:
        return self.outputs is None or any(f in self.outputs for f in fields)

    def forward(self, signals: torch.Tensor, lengths: torch.Tensor,
                add_ms: int = 0):
        """signals [B, S], lengths [B] (true lengths) -> (SndEnvOutputs with
        [B, seg, ...] axes, seg_valid [B, seg]), plus the feature-stats dict
        when ``feature_stats``."""
        with precision_tier(self.matmul_precision):
            return self._forward(signals, lengths, add_ms)

    def _forward(self, signals, lengths, add_ms):
        cfg = self.cfg
        t = self.timing
        dev = self.device
        signals = torch.as_tensor(signals, device=dev).to(self.dtype)
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
        offset0, n_flat, map_idx, ends = self._grid_for(
            signals.shape[-1], add_ms
        )
        steps = t.segment_steps

        # the kernel's wide outputs are written only when something reads
        # them: power also feeds the Energy chain, whose value reaches the
        # energy output and every MFCC field (coef0 <- Energy)
        need_energy = self._want(
            "energy", "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas"
        )
        need_power = self._want("power_segment")
        need_logp = self._want("log_power_segment")
        power, logp, mel_vals = fused_frame_power_mel(
            signals.contiguous(), t.step_samples, offset0, n_flat,
            self.dft_cos, self.dft_sin, self.mel_w,
            n_bins=t.n_bins, n_mel=cfg.mel.fbank.n_filters,
            dft=cfg.dft, fbank=cfg.mel.fbank,
            emit=(need_power or need_energy, need_logp),
        )
        if cfg.mel.fbank.renorm_effective:
            mel_vals = mel_renorm(mel_vals, cfg.mel.fbank)

        # step validity from the per-(seg, step) window ends (sndenv.go:353-359
        # break semantics; see dsp/frame.py)
        valid = ends[None] <= lengths[:, None, None]  # [B, seg, steps]
        vmask = valid[..., None]

        # Energy reads only a narrow slice of the log-power bins (the
        # reference's indexing quirks, dsp/mel.py::energy): take the slice
        # at the power stage (log of a slice == slice of the log)
        logp_narrow = None
        if need_energy:
            en_bins = steps if cfg.energy_mode in ("sndenv", "gaborview") else None
            en_src = power[..., :en_bins] if en_bins else power
            logp_narrow = (
                log_power(en_src, cfg.dft) if cfg.dft.comp_log_pow
                else torch.zeros_like(en_src)
            )

        # the deduped global-grid mel before the segment gather and before
        # any masking (opt-in output)
        mel_global = (
            mel_vals
            if self.outputs is not None and "mel_fbank_global" in self.outputs
            else None
        )

        # materialize segments from the shared global windows: row gathers
        # of the small spectra (wide power/log-power only when requested)
        zero = torch.zeros((), dtype=self.dtype, device=dev)
        mel_vals = torch.where(vmask, mel_vals[:, map_idx], zero)
        power = (
            torch.where(vmask, power[:, map_idx], zero) if need_power else None
        )
        logp = torch.where(vmask, logp[:, map_idx], zero) if need_logp else None
        en = None
        if logp_narrow is not None:
            logp_narrow = torch.where(vmask, logp_narrow[:, map_idx], zero)
            en = energy(logp_narrow, cfg.energy_mode)  # [B, seg, steps]

        mfcc = deltas = ddeltas = None
        if cfg.mel.mfcc and en is not None:
            mfcc = mfcc_dct(mel_vals, self.dct, cfg.mel.n_coefs)
            mfcc = torch.where(vmask, mfcc, zero)
            # coef0 <- Energy for ALL steps (sndenv.go:368-372; runs after
            # the step loop regardless of step validity)
            mfcc = torch.cat([en[..., None], mfcc[..., 1:]], dim=-1)
            if cfg.mel.deltas:
                deltas = mfcc_deltas(mfcc, npn=2, mode=cfg.delta_mode)
                ddeltas = mfcc_deltas(deltas, npn=2, mode=cfg.delta_mode)

        # gabor over the [n_mel, steps] mel matrix (sndenv.go:481-497)
        mel_fs = mel_vals.transpose(-1, -2)  # [B, seg, n_mel, steps]
        gabor_raw = gabor_kwta = None
        if cfg.gabor.n_filters and self._want("gabor_raw", "gabor_kwta"):
            gab4 = convolve(mel_fs, self.gabor, cfg.gabor)
            _, tms = gabor_out_counts((cfg.mel.fbank.n_filters, steps), cfg.gabor)
            gabor_raw = to_layout_2d(gab4, cfg.by_time, tms)
            uy, ux = self.gabor_output_shape()
            if gabor_raw.shape[-2:] != (uy, ux):
                buf = gabor_raw.new_zeros(gabor_raw.shape[:2] + (uy, ux))
                buf[:, :, : gabor_raw.shape[-2], : gabor_raw.shape[-1]] = gabor_raw
                gabor_raw = buf
            # NeighInhib is 4-D only (gbv.go:823-828): no ext_gi in 2-D
            if not cfg.kwta.on:
                gabor_kwta = gabor_raw
            elif self._want("gabor_kwta"):
                gabor_kwta = kwta_layer(cfg.kwta, gabor_raw, batch_ndim=2)

        # per-utterance SegCnt mask (sndenv.go:263-265, Go truncating
        # division, including the division by Channels())
        ch = self.channels
        siglen = torch.div(lengths - t.segment_samples * ch, ch,
                           rounding_mode="trunc")
        seg_cnt = torch.div(siglen, t.stride_samples, rounding_mode="trunc") + 1
        n_seg = map_idx.shape[0]
        seg_valid = torch.arange(n_seg, device=dev)[None, :] < seg_cnt[:, None]

        def seg_mask(x):
            if x is None:
                return None
            m = seg_valid.reshape(seg_valid.shape + (1,) * (x.ndim - 2))
            return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=dev))

        swap = lambda x: x.transpose(-1, -2) if x is not None else None
        fields = dict(
            power_segment=swap(power),
            log_power_segment=swap(logp),
            mel_fbank_segment=mel_fs,
            energy=en,
            mfcc_segment=swap(mfcc),
            mfcc_deltas=swap(deltas),
            mfcc_delta_deltas=swap(ddeltas),
            gabor_raw=gabor_raw,
            gabor_kwta=gabor_kwta,
        )
        fields = {k: seg_mask(v) for k, v in fields.items()}
        out = SndEnvOutputs(
            **fields,
            step_valid=valid & seg_valid[..., None],
            # the global grid has no [B, seg] leading axes: attached after
            # the seg mask (a consumer expands and masks it)
            mel_fbank_global=mel_global,
        )
        if self.outputs is not None:
            out = dataclasses.replace(
                out,
                **{f: None for f in self.ALL_OUTPUTS if f not in self.outputs},
            )
        if self.feature_stats:
            # per-mel-band moments over all valid steps of all utterances
            fmask = (valid & seg_valid[..., None])[..., None]
            mel_valid = torch.where(fmask, mel_vals, zero)
            stats = {
                "sum": mel_valid.sum(dim=(0, 1, 2)),
                "sumsq": (mel_valid * mel_valid).sum(dim=(0, 1, 2)),
                "count": fmask.to(mel_vals.dtype).sum(),
            }
            return out, seg_valid, stats
        return out, seg_valid

    # ------------------------------------------------------------------
    # single-utterance helpers
    # ------------------------------------------------------------------

    def process(
        self, signal, add_ms: int = 0, signal_len: Optional[int] = None
    ) -> SndEnvOutputs:
        """Process one utterance (all segments); batch axis squeezed away."""
        if not torch.is_tensor(signal):
            signal = torch.as_tensor(np.asarray(signal))
        n = signal.shape[-1]
        out = self.forward(
            signal[None], torch.tensor([n if signal_len is None else signal_len]),
            add_ms,
        )[0]
        return SndEnvOutputs(**{
            f.name: (None if getattr(out, f.name) is None
                     else getattr(out, f.name)[0])
            for f in dataclasses.fields(out)
        })

    def pad(self, signal: np.ndarray, value: float = 0.0) -> np.ndarray:
        """SndEnv.Pad (sndenv.go:510-519)."""
        return pad_signal(np.asarray(signal), self.timing, value)
