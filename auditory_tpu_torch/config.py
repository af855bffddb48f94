"""Frozen configuration dataclasses for the auditory-tpu framework.

These mirror the parameter structs of the reference implementation
(``emer/auditory`` v0.9.8) with identical defaults, so that a user of the
reference can move config values over 1:1:

- :class:`DFTParams`      <- ``dft.Params``              (reference dft/dft.go:15-39)
- :class:`FilterBank`     <- ``mel.FilterBank``          (reference mel/mel.go:16-44,171-180)
- :class:`MelParams`      <- ``mel.Params``              (reference mel/mel.go:47-74)
- :class:`WindowParams`   <- ``sound.Params``            (reference sound/sndenv.go:24-71)
- :class:`GaborSpec`      <- ``agabor.Filter``           (reference agabor/gabor.go:17-42)
- :class:`GaborSet`       <- ``agabor.FilterSet``        (reference agabor/gabor.go:45-70)
- :class:`NeighInhibParams` / :class:`KWTAParams` <- external ``emer/vision/kwta``
  (behavioral re-implementation; see auditory_tpu/nn/)
- :class:`SndEnvConfig`   <- ``sound.SndEnv``            (reference sound/sndenv.go:73-192)

All dataclasses are frozen and hashable so they can be closed over by
``jax.jit``-ed functions as static configuration.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


def go_round(x: float) -> int:
    """Go math.Round: round half away from zero (Python round() is banker's).

    Computed WITHOUT adding 0.5 first: ``floor(x + 0.5)`` double-rounds at
    the largest double below 0.5 (0.49999999999999994 + 0.5 rounds up to
    1.0, but Go's bit-twiddling Round returns 0). The fraction compare is
    exact: ``abs(x) - floor(abs(x))`` is representable."""
    a = abs(x)
    f = math.floor(a)
    y = f + 1 if a - f >= 0.5 else f
    return int(-y if x < 0 else y)


def msec_to_samples(ms: float, rate: int) -> int:
    """Milliseconds -> samples. Mirrors sound.MSecToSamples (sndenv.go:522-524).

    Go uses math.Round (round-half-away-from-zero), not banker's rounding.
    """
    return go_round(ms * 0.001 * float(rate))


def samples_to_msec(samples: int, rate: int) -> float:
    """Samples -> milliseconds. Mirrors sound.SamplesToMSec (sndenv.go:527-529)."""
    return 1000.0 * float(samples) / float(rate)


@dataclass(frozen=True)
class DFTParams:
    """Windowed DFT power spectrum parameters (reference dft/dft.go:15-39).

    Note: the reference applies NO analysis window function (rectangular
    window straight into the FFT, dft/dft.go:42-59). ``window_fn`` is an
    opt-in extension; leave ``None`` for reference parity.
    """

    comp_log_pow: bool = True     # Defaults() dft/dft.go:36
    log_min: float = -100.0       # Defaults() dft/dft.go:38
    log_offset: float = 1.0       # Defaults() sets 1.0 (dft/dft.go:37) despite doc "def: 0"
    prev_smooth: float = 0.0      # Defaults() dft/dft.go:34
    window_fn: Optional[str] = None  # extension: None|'hamming'|'hann'

    @property
    def cur_smooth(self) -> float:
        # dft/dft.go:35
        return 1.0 - self.prev_smooth


@dataclass(frozen=True)
class FilterBank:
    """Mel filter bank parameters (reference mel/mel.go:16-44; Defaults 171-180)."""

    n_filters: int = 32
    lo_hz: float = 0.0
    hi_hz: float = 8000.0
    log_off: float = 0.0
    log_min: float = -10.0
    # NOTE: reference InitFilters force-sets Renorm=false (mel/mel.go:80), so
    # the Defaults() value true is dead there. We reproduce: renorm only takes
    # effect if `renorm_after_init` is set (the reference user would re-enable
    # Renorm after calling InitFilters).
    renorm: bool = True
    renorm_min: float = -6.0
    renorm_max: float = 4.0
    renorm_after_init: bool = False

    @property
    def renorm_effective(self) -> bool:
        return self.renorm_after_init

    @property
    def renorm_scale(self) -> float:
        """1/(max-min), the value the reference's DEAD code would compute:
        mel/mel.go:81-83 guards the RenormScale assignment with
        ``if Renorm == true`` immediately after force-setting Renorm=false,
        so a literal Go user re-enabling Renorm post-Init runs with the
        zero-valued RenormScale field (all outputs collapse to 0 after the
        clamp). We compute the obviously-intended scale instead --
        documented deviation, see docs/PARITY.md."""
        return 1.0 / (self.renorm_max - self.renorm_min)


@dataclass(frozen=True)
class MelParams:
    """Mel + MFCC parameters (reference mel/mel.go:47-74)."""

    fbank: FilterBank = field(default_factory=FilterBank)
    mfcc: bool = True    # mel.Params.Defaults (mel/mel.go:69-74)
    deltas: bool = True
    n_coefs: int = 13


@dataclass(frozen=True)
class WindowParams:
    """Windowing / stepping / segmenting parameters (reference sound/sndenv.go:24-71).

    Defaults per SndEnv.ParamDefaults (sndenv.go:64-71).
    """

    win_ms: float = 25.0
    step_ms: float = 10.0
    segment_ms: float = 100.0
    stride_ms: float = 100.0
    border_steps: int = 2
    channel: int = 0

    def derive(self, sample_rate: int) -> "DerivedTiming":
        """Derived sample counts; mirrors SndEnv.Init (sndenv.go:195-251)."""
        if sample_rate <= 0:
            raise ValueError("sample rate <= 0")
        win = msec_to_samples(self.win_ms, sample_rate)
        step = msec_to_samples(self.step_ms, sample_rate)
        seg = msec_to_samples(self.segment_ms, sample_rate)
        stride = msec_to_samples(self.stride_ms, sample_rate)
        # sndenv.go:205 uses math.Round (half away from zero), NOT Python's
        # banker's rounding: 10.5 steps must give 11
        steps = go_round(self.segment_ms / self.step_ms)
        segment_steps = steps + 2 * self.border_steps
        # per-step start offsets: StepSamples*(i-BorderSteps)  (sndenv.go:247-251)
        offsets = tuple(step * (i - self.border_steps) for i in range(segment_steps))
        return DerivedTiming(
            sample_rate=sample_rate,
            win_samples=win,
            step_samples=step,
            segment_samples=seg,
            stride_samples=stride,
            segment_steps=segment_steps,
            step_offsets=offsets,
        )


@dataclass(frozen=True)
class DerivedTiming:
    sample_rate: int
    win_samples: int
    step_samples: int
    segment_samples: int
    stride_samples: int
    segment_steps: int
    step_offsets: Tuple[int, ...]

    @property
    def n_bins(self) -> int:
        # nyquist bin count: WinSamples/2+1 (sndenv.go:229)
        return self.win_samples // 2 + 1

    def seg_cnt(self, signal_len: int, channels: int = 1) -> int:
        """Number of segments (sndenv.go:263-265). Go int division truncates
        toward zero, reproduced here for negative siglen."""

        def godiv(a: int, b: int) -> int:
            q = abs(a) // abs(b)
            return q if (a >= 0) == (b >= 0) else -q

        siglen = signal_len - self.segment_samples * channels
        siglen = godiv(siglen, channels)
        return godiv(siglen, self.stride_samples) + 1


@dataclass(frozen=True)
class GaborSpec:
    """One gabor filter spec (reference agabor/gabor.go:17-42).

    Zero-valued WaveLen/Sigma fields get the Defaults() fallback values
    (agabor/gabor.go:73-86) at render time.
    """

    off: bool = False
    wavelen: float = 0.0
    orientation: float = 0.0
    sigma_width: float = 0.0
    sigma_length: float = 0.0
    phase_offset: float = 0.0
    circle_edge: bool = False
    circular: bool = False

    def with_defaults(self) -> "GaborSpec":
        """agabor.Filter.Defaults (gabor.go:73-86)."""
        f = self
        if f.wavelen == 0:
            f = dataclasses.replace(f, wavelen=2.0)
        if f.sigma_length == 0 and not f.circular:
            f = dataclasses.replace(f, sigma_length=0.5)
        if f.sigma_width == 0:
            f = dataclasses.replace(f, sigma_width=0.5)
        return f


@dataclass(frozen=True)
class GaborSet:
    """Gabor filter set geometry (reference agabor/gabor.go:45-70)."""

    size_x: int = 8
    size_y: int = 8
    stride_x: int = 6
    stride_y: int = 3
    gain: float = 1.5
    distribute: bool = False
    specs: Tuple[GaborSpec, ...] = ()

    def active_specs(self) -> Tuple[GaborSpec, ...]:
        # agabor.Active (gabor.go:329-336)
        return tuple(s for s in self.specs if not s.off)

    @property
    def n_filters(self) -> int:
        return len(self.active_specs())


def default_gabor_specs(
    orients=(0.0, 45.0, 90.0, 135.0),
    wavelens=(2.0,),
    phases=(0.0,),
    sigmas=(0.5,),
    circle_edge: bool = True,
) -> Tuple[GaborSpec, ...]:
    """Spec grid used by the reference examples
    (processspeech.go:237-253 uses phases (0, 1.5708); gbv.go:340-357 uses (0,))."""
    out = []
    for o in orients:
        for w in wavelens:
            for p in phases:
                for s in sigmas:
                    out.append(
                        GaborSpec(
                            wavelen=w,
                            orientation=o,
                            sigma_width=s,
                            sigma_length=s,
                            phase_offset=p,
                            circle_edge=circle_edge,
                        )
                    )
    return tuple(out)


@dataclass(frozen=True)
class NeighInhibParams:
    """Neighborhood inhibition (behavioral port of emer/vision/kwta NeighInhib;
    used at reference sound/sndenv.go:303-311)."""

    on: bool = False
    gi: float = 0.6


@dataclass(frozen=True)
class FFFBParams:
    """Feedforward+feedback inhibition (behavioral port of emer/leabra/fffb).

    gi: overall inhibition gain; ff/fb: feedforward/feedback weights;
    fb_tau: integration time constant for fb; max_vs_avg: mix of max vs avg
    netinput for ff drive; ff0: ff offset subtracted from netin avg.
    """

    on: bool = True
    gi: float = 1.8
    ff: float = 1.0
    fb: float = 1.0
    fb_tau: float = 1.4
    max_vs_avg: float = 0.0
    ff0: float = 0.1

    @property
    def fb_dt(self) -> float:
        return 1.0 / self.fb_tau


@dataclass(frozen=True)
class KWTAParams:
    """FFFB-based k-winners-take-all (behavioral port of emer/vision/kwta.KWTA;
    used at reference sound/sndenv.go:314-323).

    The iteration loop runs a fixed ``iters`` count under jit (the reference
    early-stops when max delta act < ``del_act_thr``; we keep the threshold
    for the interpretable numpy path and document the fixed-iteration jit
    deviation).

    Error budget for the settle cost (round 3; tests/test_kwta.py +
    tests/test_kwta_cross.py freeze the bounds):

    - ``iters=16`` is the FIRST count whose final-iteration max |delta act|
      (4.7e-3, worst over the gi/pool config grid x 5 seeds) satisfies the
      upstream early-stop criterion ``< del_act_thr`` (0.005) -- i.e. a
      literal upstream run would have stopped by here. Residual distance to
      the fully-settled (40-iter) fixed point is 1.0e-2, half the 0.02
      pinned-sparsity tolerance; pinned active fractions are unchanged.
    - ``xx1_fit_degrees=(16, 10)`` gives a max Chebyshev fit error of 8e-5
      vs the dense convolution (budget 1e-4, vs 7e-7 at the legacy (24, 16))
      -- two orders of magnitude below the sparsity tolerance, ~35% fewer
      Clenshaw FMAs per settle iteration.
    """

    on: bool = True
    iters: int = 16
    del_act_thr: float = 0.005
    # (deg_a, deg_b) of the two-band Chebyshev noisy-XX1 fit (nn/kwta.py)
    xx1_fit_degrees: Tuple[int, int] = (16, 10)
    lay_fffb: FFFBParams = field(default_factory=lambda: FFFBParams(gi=1.5))
    pool_fffb: FFFBParams = field(default_factory=lambda: FFFBParams(gi=0.6))
    # rate-code activation params (leabra-style noisy-XX1)
    xx1_gain: float = 80.0
    xx1_nvar: float = 0.01
    thr: float = 0.5
    act_tau: float = 3.0
    # channel conductances / reversal potentials (normalized leabra units)
    gbar_e: float = 0.5
    gbar_l: float = 0.2
    gbar_i: float = 1.0
    erev_e: float = 1.0
    erev_l: float = 0.3
    erev_i: float = 0.25

    @property
    def act_dt(self) -> float:
        return 1.0 / self.act_tau


@dataclass(frozen=True)
class SndEnvConfig:
    """Full pipeline configuration, the analog of sound.SndEnv (sndenv.go:73-192).

    SndEnv.Defaults (sndenv.go:185-192) = all defaults here.
    """

    params: WindowParams = field(default_factory=WindowParams)
    dft: DFTParams = field(default_factory=DFTParams)
    mel: MelParams = field(default_factory=MelParams)
    gabor: GaborSet = field(default_factory=GaborSet)
    neigh_inhib: NeighInhibParams = field(default_factory=NeighInhibParams)
    kwta: KWTAParams = field(default_factory=KWTAParams)
    kwta_pool: bool = True     # sndenv.go:190
    by_time: bool = False      # sndenv.go:191
    # gabor output geometry (sndenv.go:147-158); 0/0 pools => 2D layout
    gbor_out_pools_x: int = 0
    gbor_out_pools_y: int = 0
    gbor_out_units_x: int = 0
    gbor_out_units_y: int = 0
    # 'sndenv' reproduces the reference Energy indexing quirk
    # (sndenv.go:360-366 sums LogPowerSegment[s, :] -- step index used as the
    # frequency row). 'gaborview' reproduces gbv.go:553-560 (sums
    # LogPowerSegment[:steps, s]). 'spectral' is the corrected sum over all
    # frequency bins at step s.
    energy_mode: str = "sndenv"
    # 'sndenv' delta recurrence (sndenv.go:379-432) vs 'gaborview'
    # (gbv.go:570-620, d = nume/2*denom variant)
    delta_mode: str = "sndenv"


def clamp_mel_to_nyquist(cfg: "SndEnvConfig", sample_rate: int) -> "SndEnvConfig":
    """Lower ``mel.fbank.hi_hz`` to the Nyquist frequency when it exceeds it.

    The reference default HiHz=8000 (mel.go:173, FilterBank.Defaults) is
    only valid at sample
    rates >= 16 kHz; below that every user must lower it (SndEnv rejects the
    config otherwise). Benchmarks and tools that sweep sample rates share
    this helper so low-rate rows run the same config any real user would.
    """
    if cfg.mel.fbank.hi_hz <= sample_rate / 2:
        return cfg
    return dataclasses.replace(
        cfg,
        mel=dataclasses.replace(
            cfg.mel,
            fbank=dataclasses.replace(cfg.mel.fbank, hi_hz=sample_rate / 2),
        ),
    )


def resolve_device(device=None):
    """The device an entry point runs on: ``None`` means the card
    (``torch.device("cuda")``), never a silent fall back to the host. Raises
    when CUDA is asked for, by default or by name, and no card is present;
    the CPU run asks for the host with ``device="cpu"``."""
    import torch

    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        if device is None:
            raise RuntimeError(
                "no CUDA device: the entry points run on the card by default; "
                'pass device="cpu" to run on the host'
            )
        raise RuntimeError(
            f"device {resolved} requested but torch.cuda.is_available() is False"
        )
    return resolved
