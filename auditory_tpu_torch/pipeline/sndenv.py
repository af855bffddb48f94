"""The SndEnv pipeline in PyTorch: WAV signal -> power/log-power -> mel ->
MFCC(+deltas) -> gabor -> (neighbor inhibition) -> kWTA, for all segments of
a padded batch of utterances (counterpart of
``auditory_tpu/pipeline/sndenv.py``; reference ``sound.SndEnv``,
sound/sndenv.go:73-497).

Three frontends, the route decided from the geometry and
``segment_frontend`` before any launch (:meth:`SndEnv.route`):

- ``"kernel"``: on the uniform grid (stride a multiple of step,
  prev_smooth == 0) the frontend runs once per distinct window of the shared
  global step grid (the windows of consecutive segments overlap) through
  the fused frame+DFT+power+log+mel kernel
  (:mod:`auditory_tpu_torch.ops.framefft`), which holds every such grid;
  segments are then a row gather of the small spectra;
- ``"per_segment"`` (``segment_frontend='per_segment'``, off the grid: e.g.
  22.05 kHz, where the stride 2205 is no multiple of the step 221, or
  prev_smooth > 0): each segment's windows are still uniformly strided, so
  each segment's span becomes one row (:func:`~auditory_tpu_torch.dsp.dft.
  segment_spans`) and one launch of the same kernel runs every row's
  ``segment_steps`` windows from offset 0; with smoothing the kernel's
  power goes through the recurrence, log power and mel in plain ops;
- ``"gather"``: off the grid under ``'auto'`` (or everywhere under
  ``'gather'``) every window is gathered, its invalid steps zeroed:
  ``windows @ basis``, the smoothing recurrence, log power and mel. The
  JAX package's ``'auto'`` takes this branch off the grid too.

Outputs keep the reference's per-segment shapes with leading [batch,
segment] axes, e.g. ``power_segment[b, seg]`` == the reference's
PowerSegment [freq, step] after ProcessSegment(seg) on utterance b. The
gabor outputs take the 2-D layout, or the 4-D pooled layout with neighbor
inhibition when both ``gbor_out_pools_*`` are > 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import SndEnvConfig, msec_to_samples, resolve_device
from ..convert import constants_from_numpy
from ..dsp import design
from ..dsp.dft import (
    dft_power_pipeline, log_power, segment_spans, smooth_power,
)
from ..dsp.frame import extract_windows, pad_signal, window_starts
from ..dsp.gabor import convolve, gabor_out_counts, to_layout_2d
from ..dsp.mel import apply_mel, energy, mel_renorm, mfcc_dct, mfcc_deltas
from ..nn.kwta import kwta_layer, kwta_pool
from ..nn.neigh_inhib import inhib4
from ..ops.framefft import fused_frame_power_mel, n_limbs, tf32_flags

__all__ = ["SndEnvOutputs", "SndEnv", "precision_tier"]

PRECISION_TIERS = ("highest", "high", "default")
SEGMENT_FRONTENDS = ("auto", "per_segment", "gather")


@contextlib.contextmanager
def precision_tier(tier: str):
    """Contraction precision of the float32 matmuls and convolutions run
    inside the block, restoring the previous settings on exit.

    'highest' and 'high' switch TF32 off for both ``torch.matmul`` (cuBLAS)
    and convolutions (cuDNN, where PyTorch leaves TF32 on by default): IEEE
    float32, which meets the JAX tiers' grades (exact f32 and ~1.5e-5 rel).
    'default' allows TF32 for both (~5e-4 rel, finer than the TPU default
    tier's bf16 operands). The CPU ignores both flags.

    :meth:`SndEnv.forward` enters its tier itself, but ``loss.backward()``
    runs after the forward has returned: wrap it in the same tier
    (``with precision_tier(env.matmul_precision): loss.backward()``) so the
    gabor convolution's and the matmuls' backward keep the forward's
    precision. The fused frontend's backward re-enters the forward's flags
    on its own (:class:`~auditory_tpu_torch.ops.framefft.FusedFramePowerMel`)."""
    if tier not in PRECISION_TIERS:
        raise ValueError(
            f"matmul_precision must be one of {PRECISION_TIERS}, got {tier!r}"
        )
    allow = tier == "default"
    with tf32_flags((allow, allow)):
        yield


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
                         [.., py, px, 2, nf]     (4-D pooled layout)
      gabor_kwta         like gabor_raw          <- GborKwta
      step_valid         [.., steps] bool        (True where the reference
                                                  would have processed the step)
      mel_fbank_global   [.., n_flat, n_mel]     (opt-in: the deduped global
                                                  step grid mel_fbank_segment
                                                  is gathered from, UNMASKED;
                                                  None off the uniform grid.
                                                  Expand via SndEnv.global_grid)
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
        kernel_passes: int = 6,
        segment_frontend: str = "auto",
    ):
        """``outputs``: which SndEnvOutputs fields to return (None = all);
        fields left out are not computed where nothing else needs them.
        ``channels``: interleaved channels of the signal, used only by the
        SegCnt arithmetic (sndenv.go:263-265). ``feature_stats``: also return
        per-mel-band moments (sum, sumsq, count over all valid steps).
        ``matmul_precision``: see :func:`precision_tier`.

        ``device``: None means the card (``cuda``); without one it raises,
        and the CPU run passes ``device="cpu"`` (see
        :func:`~auditory_tpu_torch.config.resolve_device`). ``dtype``
        float64 is the CPU reference dtype: the fused frontend kernel takes
        float32 only and raises for float64 on a CUDA device.

        ``kernel_passes`` (1, 3 or 6; JAX's ``pallas_passes``) is the grade
        of the uniform-grid frontend's DFT contraction: bf16 limbs on the
        tensor cores, 6 products (three limbs, exact float32), 3 (two limbs,
        ~1.5e-5 relative) or 1 (bf16-rounded operands, ~2.5e-3 relative
        power). The float32 plain version on the CPU emulates the same
        grade; float64 computes exactly. The gather frontend off the grid
        ignores it.

        ``segment_frontend`` (JAX's argument) picks the frontend where no
        shared window grid exists (:meth:`route`): 'auto' the window
        gather, 'per_segment' the kernel on each segment's span; 'gather'
        runs the window gather on every grid, the uniform one included."""
        super().__init__()
        if segment_frontend not in SEGMENT_FRONTENDS:
            raise ValueError(
                "segment_frontend must be 'auto', 'per_segment' or "
                f"'gather', got {segment_frontend!r}"
            )
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
        n_limbs(kernel_passes)
        if (cfg.gbor_out_pools_x > 0) != (cfg.gbor_out_pools_y > 0):
            raise ValueError(
                "GborOutPoolsX & GborOutPoolsY must both be == 0 or > 0 "
                "(2D or 4D; sndenv.go:220-222)"
            )
        timing = cfg.params.derive(sample_rate)
        device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.channels = int(channels)
        self.feature_stats = bool(feature_stats)
        self.matmul_precision = matmul_precision
        self.kernel_passes = int(kernel_passes)
        self.segment_frontend = segment_frontend
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
        # one orientation per active filter, for the neighbor inhibition
        self._orients = tuple(
            s.with_defaults().orientation for s in cfg.gabor.active_specs()
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

    @property
    def is_4d(self) -> bool:
        # sndenv.go:214-223: both pools zero => 2-D layout
        return self.cfg.gbor_out_pools_x > 0 and self.cfg.gbor_out_pools_y > 0

    def gabor_output_shape(self) -> Tuple[int, ...]:
        cfg = self.cfg
        if self.is_4d:
            return (cfg.gbor_out_pools_y, cfg.gbor_out_pools_x, 2,
                    cfg.gabor.n_filters)
        fc, tc = gabor_out_counts(
            (cfg.mel.fbank.n_filters, self.timing.segment_steps), cfg.gabor
        )
        uy = cfg.gbor_out_units_y or fc * 2
        ux = cfg.gbor_out_units_x or tc * cfg.gabor.n_filters
        return (uy, ux)

    def seg_cnt(self, n_samples: int) -> int:
        return self.timing.seg_cnt(n_samples, self.channels)

    def global_grid(self, n_samples: int, add_ms: int = 0):
        """Host-side expansion metadata for ``mel_fbank_global``:
        (map_idx [seg, steps] global-row index per (segment, step), or None
        off the uniform grid; window_ends [seg, steps]). For segments
        ``s < seg_cnt_b``::

            valid = window_ends[s, i] <= length_b
            mel_fbank_segment[b, s, :, i] =
                where(valid, mel_fbank_global[b, map_idx[s, i]], 0)

        Use where/select, not multiplication by the mask: the mel NaN
        triangle quirk means gathered values can be NaN, and NaN * 0 != 0."""
        seg = max(self.seg_cnt(n_samples), 0)
        _, map_idx, starts_np = self._window_grid(seg, add_ms)
        return map_idx, starts_np + self.timing.win_samples

    def _window_grid(self, seg_cnt: int, add_ms: int):
        """The (segment, step) -> window-start geometry.

        When StrideSamples is a multiple of StepSamples (the default: 100 ms
        stride / 10 ms step) and there is no smoothing, consecutive
        segments' windows lie on one global step grid and border windows are
        shared: segment s, step i is global window s*(stride/step) + i, so
        the frontend runs once per distinct window.

        Returns (flat_starts [n_flat], map_idx [seg, steps] int32 into flat,
        starts [seg, steps]). Off that grid (a stride that is no multiple of
        the step, or smoothing, whose recurrence runs per segment,
        dft/dft.go:67-69) flat_starts is ``starts`` flattened and map_idx is
        None."""
        t = self.timing
        starts_np = window_starts(t, seg_cnt, add_ms)
        if (
            seg_cnt > 0
            and t.stride_samples > 0
            and t.stride_samples % t.step_samples == 0
            and self.cfg.dft.prev_smooth == 0.0
        ):
            sps = t.stride_samples // t.step_samples
            n_global = (seg_cnt - 1) * sps + t.segment_steps
            g_starts = (
                t.step_samples * np.arange(n_global, dtype=np.int64)
                + starts_np[0, 0]
            ).astype(np.int32)
            map_idx = (
                np.arange(seg_cnt, dtype=np.int32)[:, None] * sps
                + np.arange(t.segment_steps, dtype=np.int32)[None, :]
            )
            if not (g_starts[map_idx] == starts_np).all():
                raise AssertionError("window grid does not match window_starts")
            return g_starts, map_idx, starts_np
        return starts_np.reshape(-1), None, starts_np

    def route(self, n_samples: int, add_ms: int = 0,
              segments: Optional[Tuple[int, int]] = None) -> str:
        """The frontend a signal of ``n_samples`` samples takes, decided
        from the geometry and ``segment_frontend`` before any launch (the
        JAX package's rule): ``"kernel"`` on the uniform window grid unless
        ``'gather'`` is forced; off it ``"per_segment"`` under
        ``'per_segment'`` (where each segment's starts are affine, as
        ``window_starts`` makes them), else ``"gather"``."""
        return self._grid_for(n_samples, add_ms, segments)[-1]

    def _grid_for(self, n_samples: int, add_ms: int,
                  segments: Optional[Tuple[int, int]] = None):
        """Per-length geometry as device tensors (cached): (offset0, n_flat,
        map_idx or None, starts [seg, steps], window ends [seg, steps],
        segment indices [seg], route). ``segments`` = (s0, s1) restricts it
        to that contiguous range of the signal's segments (the same windows,
        validity and indices as in the whole signal's geometry)."""
        key = (n_samples, add_ms, segments, self.device)
        if key not in self._geometry:
            seg = self.seg_cnt(n_samples)
            if seg <= 0:
                raise ValueError(
                    f"a signal of {n_samples} samples has no segments"
                )
            s0, s1 = (0, seg) if segments is None else segments
            if not 0 <= s0 < s1 <= seg:
                raise ValueError(
                    f"segment range {segments} is not inside the signal's "
                    f"{seg} segments"
                )
            flat, map_idx, starts = self._window_grid(seg, add_ms)
            starts = starts[s0:s1]
            t = self.timing
            if map_idx is None:
                flat = starts.reshape(-1)
            else:
                sps = t.stride_samples // t.step_samples
                map_idx = map_idx[s0:s1] - s0 * sps
                flat = flat[s0 * sps:s0 * sps + int(map_idx.max()) + 1]
            route = self._route(map_idx, starts)
            dev = self.device
            starts_d = torch.as_tensor(starts.astype(np.int64), device=dev)
            self._geometry[key] = (
                int(flat[0]), int(flat.shape[0]),
                None if map_idx is None
                else torch.as_tensor(map_idx.astype(np.int64), device=dev),
                starts_d, starts_d + t.win_samples,
                torch.arange(s0, s1, device=dev), route,
            )
        return self._geometry[key]

    def _route(self, map_idx, starts) -> str:
        if self.segment_frontend == "gather":
            return "gather"
        if map_idx is not None:
            return "kernel"
        if self.segment_frontend == "per_segment":
            t = self.timing
            seg = np.arange(starts.shape[0], dtype=np.int64)[:, None]
            step = np.arange(starts.shape[1], dtype=np.int64)[None, :]
            affine = (int(starts[0, 0]) + t.stride_samples * seg
                      + t.step_samples * step)
            if t.stride_samples > 0 and (affine == starts).all():
                return "per_segment"
        return "gather"

    # ------------------------------------------------------------------
    # the batched program
    # ------------------------------------------------------------------

    def _want(self, *fields: str) -> bool:
        return self.outputs is None or any(f in self.outputs for f in fields)

    def forward(self, signals: torch.Tensor, lengths: torch.Tensor,
                add_ms: int = 0, segments: Optional[Tuple[int, int]] = None):
        """signals [B, S], lengths [B] (true lengths) -> (SndEnvOutputs with
        [B, seg, ...] axes, seg_valid [B, seg]), plus the feature-stats dict
        when ``feature_stats``. ``segments`` = (s0, s1) computes only that
        contiguous range of the signal's segments, exactly as they are in
        the whole run (the segment axis then has s1 - s0 entries).

        Differentiable on both devices w.r.t. ``signals`` and any constant
        buffer a caller replaces by an ``nn.Parameter`` (e.g. ``gabor``);
        call ``backward()`` inside :func:`precision_tier` of the same tier."""
        with precision_tier(self.matmul_precision):
            return self._forward(signals, lengths, add_ms, segments)

    def _forward(self, signals, lengths, add_ms, segments=None):
        cfg = self.cfg
        t = self.timing
        dev = self.device
        signals = torch.as_tensor(signals, device=dev).to(self.dtype)
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
        offset0, n_flat, map_idx, starts, ends, seg_ids, route = self._grid_for(
            signals.shape[-1], add_ms, segments
        )
        steps = t.segment_steps
        n_bins, n_mel = t.n_bins, cfg.mel.fbank.n_filters

        # the wide outputs are computed only when something reads them:
        # power also feeds the Energy chain, whose value reaches the energy
        # output and every MFCC field (coef0 <- Energy)
        need_energy = self._want(
            "energy", "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas"
        )
        need_power = self._want("power_segment")
        need_logp = self._want("log_power_segment")
        if route == "kernel":
            # uniform grid: the fused kernel, once per distinct window
            power, logp, mel_vals = fused_frame_power_mel(
                signals.contiguous(), t.step_samples, offset0, n_flat,
                self.dft_cos, self.dft_sin, self.mel_w,
                n_bins=n_bins, n_mel=n_mel, dft=cfg.dft, fbank=cfg.mel.fbank,
                emit=(need_power or need_energy, need_logp),
                passes=self.kernel_passes,
            )
            if cfg.mel.fbank.renorm_effective:
                mel_vals = mel_renorm(mel_vals, cfg.mel.fbank)
        elif route == "per_segment":
            power, logp, mel_vals = self._per_segment(
                signals, offset0, starts.shape[0], need_power or need_energy,
                need_logp,
            )
        else:
            # one window per (segment, step), or per global window where
            # the gather is forced on the uniform grid; invalid steps'
            # windows zeroed before the spectrum (the smoothing reads them)
            if map_idx is not None:
                starts = offset0 + t.step_samples * torch.arange(
                    n_flat, device=dev
                )
            windows = extract_windows(signals, starts, t.win_samples, lengths)
            power, logp = dft_power_pipeline(
                windows, cfg.dft,
                (self.dft_cos[:, :n_bins], self.dft_sin[:, :n_bins]),
            )
            del windows
            mel_vals = apply_mel(
                power, self.mel_w[:n_bins, :n_mel].T, cfg.mel.fbank
            )

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
        # any masking (opt-in output; only the uniform grid has one)
        mel_global = (
            mel_vals
            if map_idx is not None and self.outputs is not None
            and "mel_fbank_global" in self.outputs
            else None
        )

        # materialize segments from the shared global windows: row gathers
        # of the small spectra (wide power/log-power only when requested);
        # off the grid the spectra already have their [seg, steps] axes
        zero = torch.zeros((), dtype=self.dtype, device=dev)

        def segments(x):
            x = x if map_idx is None else x[:, map_idx]
            return torch.where(vmask, x, zero)

        mel_vals = segments(mel_vals)
        power = segments(power) if need_power else None
        logp = segments(logp) if need_logp else None
        en = None
        if logp_narrow is not None:
            logp_narrow = segments(logp_narrow)
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
            if self.is_4d:
                # the pools, zero-padded past the conv's positions
                pools = (cfg.gbor_out_pools_y, cfg.gbor_out_pools_x)
                gab4 = convolve(mel_fs, self.gabor, cfg.gabor, out_pools=pools)
                fc, tc = gab4.shape[2], gab4.shape[3]
                gabor_raw = gab4.new_zeros(
                    gab4.shape[:2] + pools + gab4.shape[-2:]
                )
                gabor_raw[:, :, :fc, :tc] = gab4
                ext_gi = inhib4(cfg.neigh_inhib, gabor_raw, self._orients)
                settle = kwta_pool if cfg.kwta_pool else kwta_layer
            else:
                gab4 = convolve(mel_fs, self.gabor, cfg.gabor)
                _, tms = gabor_out_counts((n_mel, steps), cfg.gabor)
                gabor_raw = to_layout_2d(gab4, cfg.by_time, tms)
                uy, ux = self.gabor_output_shape()
                if gabor_raw.shape[-2:] != (uy, ux):
                    buf = gabor_raw.new_zeros(gabor_raw.shape[:2] + (uy, ux))
                    buf[:, :, : gabor_raw.shape[-2], : gabor_raw.shape[-1]] = gabor_raw
                    gabor_raw = buf
                # NeighInhib is 4-D only (gbv.go:823-828): no ext_gi in 2-D
                ext_gi, settle = None, kwta_layer
            if not cfg.kwta.on:
                gabor_kwta = gabor_raw
            elif self._want("gabor_kwta"):
                gabor_kwta = settle(cfg.kwta, gabor_raw, ext_gi, batch_ndim=2)

        # per-utterance SegCnt mask (sndenv.go:263-265, Go truncating
        # division, including the division by Channels())
        ch = self.channels
        siglen = torch.div(lengths - t.segment_samples * ch, ch,
                           rounding_mode="trunc")
        seg_cnt = torch.div(siglen, t.stride_samples, rounding_mode="trunc") + 1
        seg_valid = seg_ids[None, :] < seg_cnt[:, None]

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

    def _per_segment(self, signals, offset0: int, n_seg: int,
                     want_power: bool, want_logp: bool):
        """The ``"per_segment"`` frontend: each segment's span one row of a
        fresh contiguous [B * seg, span] tensor, one launch of the fused
        kernel over every row's ``segment_steps`` windows from offset 0,
        reshaped to [B, seg, steps, .]. With smoothing the kernel emits the
        power alone (its mel is left unread) and the recurrence, log power
        and mel follow in plain ops, as the JAX package's ``post_power``."""
        cfg, t = self.cfg, self.timing
        steps, n_bins, n_mel = t.segment_steps, t.n_bins, cfg.mel.fbank.n_filters
        span = (steps - 1) * t.step_samples + t.win_samples
        rows = segment_spans(
            signals, t.stride_samples, span, offset0, n_seg
        ).reshape(-1, span).contiguous()
        smooth = cfg.dft.prev_smooth != 0.0
        power, logp, mel_vals = fused_frame_power_mel(
            rows, t.step_samples, 0, steps,
            self.dft_cos, self.dft_sin, self.mel_w,
            n_bins=n_bins, n_mel=n_mel,
            dft=dataclasses.replace(cfg.dft, prev_smooth=0.0),
            fbank=cfg.mel.fbank,
            emit=(want_power or smooth, want_logp and not smooth),
            passes=self.kernel_passes,
        )
        b = signals.shape[0]
        unflat = lambda x: (None if x is None
                            else x.reshape(b, n_seg, steps, x.shape[-1]))
        power, logp, mel_vals = unflat(power), unflat(logp), unflat(mel_vals)
        if smooth:
            power = smooth_power(power, cfg.dft)
            if want_logp:
                logp = (log_power(power, cfg.dft) if cfg.dft.comp_log_pow
                        else torch.zeros_like(power))
            mel_vals = apply_mel(
                power, self.mel_w[:n_bins, :n_mel].T, cfg.mel.fbank
            )
        elif cfg.mel.fbank.renorm_effective:
            mel_vals = mel_renorm(mel_vals, cfg.mel.fbank)
        return power, logp, mel_vals

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

    def adjust_for_silence(
        self, signal: np.ndarray, add: float, existing: float
    ) -> Tuple[np.ndarray, int]:
        """SndEnv.AdjustForSilence (sndenv.go:274-294); host-side trim/pad
        of the leading silence from ``existing`` to ``add`` ms. Returns the
        signal and the offset in ms."""
        offset = 0
        out = np.asarray(signal)
        if add >= 0:
            if add < existing:
                offset = int(existing - add)
                n = msec_to_samples(float(offset), self.sample_rate)
                out = out[n:]
            elif add > existing:
                offset = int(add - existing)
                n = msec_to_samples(float(offset), self.sample_rate)
                out = np.concatenate([np.zeros(n, dtype=out.dtype), out])
        return out, offset
