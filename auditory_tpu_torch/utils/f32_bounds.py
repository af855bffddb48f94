"""The float32 error model of the SndEnv slice, against float64.

A float32 run of the slice (the port's, on the CPU or the card, or the JAX
package's) differs from the same inputs run in float64 by rounding, and
the size of that rounding depends on the inputs: a log mel 22 nats below
its row's peak reads a mel sum made of leakage, which any float32
summation order rounds differently. A fixed ``rtol``/``atol`` between two
float32 runs cannot hold both that element and a loud one. This module
gives, for each float32 output of the slice, an elementwise bound on its
distance from the float64 run of the same inputs, computed from the run's
own inputs (signal rows, window starts, basis, mel weights, DCT, delta
operator, gabor bank) and the float64 values of the chain, which it
computes from them.

A float32 output ``y`` is right when ``|y - y64| <= bound`` everywhere,
with NaN and +-inf at the float64 run's positions exactly
(:func:`share`: the largest ``|y - y64| / bound``, at most 1). Two float32
runs, each within the bound, are within twice the bound of each other.

The stages, each carrying the bound of its input:

- frontend (:func:`power_bound`, :func:`log_power_bound`,
  :func:`mel_bound`): per window and bin
  ``d_k = GRADE_U[passes] sum |y_n| + DFT_ROUNDINGS sqrt(N) U M_k`` (and
  ``sqrt(3N) U sum |y_n|`` more for a run whose sum order is unknown)
  bounds the error of each DFT component (``y`` the windowed samples,
  ``M_k`` the bound on every partial sum of component k,
  :func:`dft_envelope`); power within
  ``2 sqrt(2 p) d + 2 d^2`` plus its own rounding; log power within that
  over ``p + LogOffSet - bound``; log mel within ``W |dp|`` plus the mel
  sum's own rounding over ``mel sum + LogOff - bound``;
- linear stages (Energy, MFCC, the deltas, gabor): ``|A| b + gamma_n |A| |x|``
  (:func:`gamma`), with ``A`` the stage's operator and ``x`` its float64
  input;
- the kWTA settle is not linear: it is held to the settle applied in
  float64 to the run's own ``gabor_raw``, within :func:`settle_bound`;
- means and sums over elements (feature stats, the corpus statistics):
  the mean (or sum) of their elements' bounds plus the reduction's own
  rounding.

The main path does not use this module; the tests and ``chip_smoke.py``
do, with the same constants on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import DFTParams, FilterBank, KWTAParams, msec_to_samples
from ..dsp.dft import floored_log, power_spectrum
from ..dsp.frame import extract_windows
from ..dsp.gabor import gabor_out_counts, to_layout_2d
from ..dsp.mel import _delta_tensors, energy, mel_renorm
from ..nn.kwta import _settle
from ..nn.neigh_inhib import inhib4

__all__ = [
    "U", "TINY", "GRADE_U", "DFT_ROUNDINGS", "LOG_ULPS", "SETTLE_OPS",
    "gamma", "share", "stage_bound", "dft_envelope", "power_bound",
    "log_power_bound", "mel_bound", "in_float32_range", "frontend_bounds",
    "pair_frontend_bounds", "slice_bounds", "segment_bounds", "stream_bounds",
    "gabor_reference", "settle_reference", "settle_bound", "sum_bounds",
    "mean_std_bounds", "hold",
]

# float32's unit roundoff: a rounded operation is exact times (1 + e), |e| <= U
U = 2.0**-24
# per DFT term, the relative error a kernel grade adds to |x_n c_n|
# (|c| <= 1): bf16-rounded operands at 1 pass (2^-9 for each of the two),
# the dropped limb products at 3 (x1 c1 and the third limbs, below 2^-15),
# none at 6 (three limbs hold a float32 exactly; JAX's pallas_passes)
GRADE_U = {6: 0.0, 3: 2.0**-15, 1: 2.0**-8}
# The float32 DFT's rounding of one component k of an N-sample window y (the
# samples times the analysis window, |c| <= 1). Every partial sum a blocked
# or pairwise float32 sum forms runs over contiguous terms: the difference
# of two running sums, each at most the window's Dirichlet envelope
# M_k = (1/N) sum_j |Y_j| min(N, 1 / |sin(pi (j - k) / N)|) (Y its DFT; see
# dft_envelope), so at most 2 M_k, and so is a single term. The 3N
# roundings (the basis to float32, each product, each addition) are each at
# most U times such a sum, and their signs are random: they add as sqrt(3N)
# (Higham and Mary, SIAM J. Sci. Comput. 41 (2019), A2815), so the
# component is within DFT_ROUNDINGS sqrt(N) U M_k, DFT_ROUNDINGS = 2 sqrt(3).
# A sum over a circular range of the window (the JAX Pallas kernel's
# phase-rotated basis) is a running sum or the total less one: within 2 M_k
# too. At a limb grade the partial sums are of the grade's products, each
# within GRADE_U |y_n| of the exact term: M_k + GRADE_U[passes] sum |y_n|.
# A run whose sum order is not known (the JAX package's XLA formulations:
# a vectorized dot whose lanes sum strided terms, a strided convolution,
# shifted frame products, sub-DFTs) has partial sums over subsets that the
# envelope does not bound (a strided subset aliases the loud bins into a
# quiet one): each is at most sum |y_n|, so its 3N roundings add
# sqrt(3N) U sum |y_n| more (``any_order=True``).
DFT_ROUNDINGS = 2.0 * math.sqrt(3.0)
# float32's smallest normal: a rounding that underflows (or is flushed to
# zero, as the card may do) loses at most this, whatever the operands
TINY = 2.0**-126
# the rounding of ln and of its argument's offset: 2 ulps of the result
# and 1 of the argument (absolute U in ln)
LOG_ULPS = 2
# the float32 roundings on one unit's path through a settle iteration: the
# layer's and pool's mean and max, the feedforward and feedback
# inhibition, gi, ge_thr, the drive, the XX1's Clenshaw steps' leading
# terms and the activation's update (see settle_bound)
SETTLE_OPS = 16
# bounds past this are unbounded: an input's bound that is infinite
# stays so through a matmul without turning 0 * inf into NaN
_BIG = 1e300


def gamma(n: int) -> float:
    """gamma_n = n U / (1 - n U): the relative error bound of an n-term
    float32 sum or dot product in any order (Higham, Accuracy and Stability
    of Numerical Algorithms, 3.1)."""
    return n * U / (1.0 - n * U)


def _finite(b: torch.Tensor) -> torch.Tensor:
    """``b`` with NaN as 0 (a NaN element's position is held exactly, not
    its bound) and +inf as _BIG, for propagation through a matmul."""
    return torch.nan_to_num(b, nan=0.0, posinf=_BIG)


def _unbig(b: torch.Tensor) -> torch.Tensor:
    return torch.where(b >= _BIG, torch.full_like(b, math.inf), b)


def share(got: torch.Tensor, ref: torch.Tensor, bound: torch.Tensor) -> float:
    """Largest ``|got - ref| / bound`` (0 where the two are equal, inf where
    they differ at a zero bound), on ``ref``'s device. Raises ValueError
    when the shapes or the NaN, +inf or -inf positions differ."""
    r = torch.as_tensor(ref).detach().double()
    g = torch.as_tensor(got).detach().to(r.device).double()
    b = torch.as_tensor(bound).detach().to(r.device).double()
    if g.shape != r.shape or b.shape != r.shape:
        raise ValueError(f"shapes differ: {tuple(g.shape)}, {tuple(r.shape)}, "
                         f"bound {tuple(b.shape)}")
    for name, mask in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                       ("-inf", torch.isneginf)):
        if not torch.equal(mask(g), mask(r)):
            raise ValueError(f"{name} positions differ")
    err = torch.where(torch.isfinite(r), (g - r).abs(), torch.zeros_like(r))
    ratio = torch.where(err == 0, torch.zeros_like(err), err / b)
    return float(ratio.max()) if ratio.numel() else 0.0


# ----------------------------------------------------------------------
# the frontend
# ----------------------------------------------------------------------


def dft_envelope(y: torch.Tensor) -> torch.Tensor:
    """M_k [..., N] of windows ``y`` [..., N] (float64): the bound on every
    running sum of the DFT component k, |sum_{n<i} y_n e^(-2 pi i k n / N)|
    <= (1/N) sum_j |Y_j| |sum_{n<i} e^(2 pi i (j - k) n / N)| and the inner
    geometric sum is at most min(i, 1 / |sin(pi (j - k) / N)|): a circular
    convolution of |Y| with that kernel (by FFT)."""
    n = y.shape[-1]
    mag = torch.fft.fft(y.double(), dim=-1).abs()
    d = torch.arange(n, dtype=torch.float64, device=y.device)
    kern = torch.clamp(1.0 / torch.sin(math.pi * d / n).abs(), max=float(n))
    conv = torch.fft.ifft(torch.fft.fft(mag, dim=-1) * torch.fft.fft(kern).conj(),
                          dim=-1).real / n
    return conv.clamp_min(0.0)


def power_bound(windows: torch.Tensor, power: torch.Tensor, passes: int = 6,
                window_fn: Optional[torch.Tensor] = None,
                any_order: bool = False) -> torch.Tensor:
    """Bound of the float32 power around the float64 ``power`` [..., n_bins]
    of ``windows`` [..., N] (the analysis window ``window_fn`` [N], if any,
    folded into the basis): each DFT component within d_k, the grade's
    GRADE_U[passes] sum |y_n| plus the sum's rounding (:func:`_order_rounding`),
    so |re^2 + im^2 - p| <= 2 (|re| + |im|) d + 2 d^2 <= 2 sqrt(2 p) d + 2 d^2,
    and re^2 + im^2 itself within gamma_2 p (each rounding also within
    TINY, for underflow)."""
    y = _windowed(windows, window_fn)
    p = power.double()
    d = (GRADE_U[passes] * y.abs().sum(-1, keepdim=True)
         + _order_rounding(y, p.shape[-1], passes, any_order))
    return 2.0 * torch.sqrt(2.0 * p) * d + 2.0 * d * d + gamma(2) * p + 3 * TINY


def _windowed(windows: torch.Tensor, window_fn) -> torch.Tensor:
    y = windows.double()
    if window_fn is not None:
        y = y * torch.as_tensor(window_fn, dtype=torch.float64, device=y.device)
    return y


def _order_rounding(y: torch.Tensor, n_bins: int, passes: int,
                    any_order: bool) -> torch.Tensor:
    """The float32 rounding of each DFT component [..., n_bins] of the
    windowed samples ``y`` [..., N] summed at grade ``passes``:
    DFT_ROUNDINGS sqrt(N) U (M_k + GRADE_U[passes] sum |y_n|), plus
    sqrt(3N) U sum |y_n| for a run whose sum order is unknown (``any_order``),
    plus 3N TINY for underflow."""
    n = y.shape[-1]
    s = y.abs().sum(-1, keepdim=True)
    d = (DFT_ROUNDINGS * math.sqrt(n) * U
         * (dft_envelope(y)[..., :n_bins] + GRADE_U[passes] * s) + 3 * n * TINY)
    if any_order:
        d = d + math.sqrt(3 * n) * U * s
    return d


def _log_bound(err: torch.Tensor, arg: torch.Tensor, runs: int = 1) -> torch.Tensor:
    """Bound of |ln(a') - ln(arg)| for |a' - arg| <= err (the mean value
    theorem on [arg - err, arg + err]; unbounded when that reaches 0), plus
    ln's own rounding in each of ``runs`` float32 runs. An exact zero
    argument maps to the floor in both runs."""
    room = arg - err
    value = torch.log(torch.where(arg > 0, arg, torch.ones_like(arg))).abs()
    b = err / torch.where(room > 0, room, torch.ones_like(room))
    b = torch.where((room > 0) | (err == 0), b, torch.full_like(b, math.inf))
    return b + runs * (LOG_ULPS * U * (1.0 + value) + U)


def log_power_bound(bp: torch.Tensor, power: torch.Tensor,
                    dft: DFTParams, runs: int = 1) -> torch.Tensor:
    """Bound of ln(power + LogOffSet) given the power's bound ``bp`` (ln's
    rounding counted in each of ``runs`` runs)."""
    return _log_bound(bp, power.double() + dft.log_offset, runs)


def mel_bound(bp: torch.Tensor, power: torch.Tensor, mel_w: torch.Tensor,
              fbank: FilterBank, runs: int = 1) -> torch.Tensor:
    """Bound of the log mel ln(sum_k W[k, f] p_k + LogOff) [..., n_mel]
    given the power's bound ``bp``: the sum within W |bp| plus its own
    rounding, gamma_(K+1) |W| p with K the filter's nonzero weights (+1 for
    the weights' rounding to float32), in each of ``runs`` runs; the renorm
    clamp, where it is on, scales the bound by its factor. NaN weights give
    NaN (held by position)."""
    w = mel_w.double()
    aw = w.abs().nan_to_num(nan=0.0)
    terms = (w != 0).sum(0).to(torch.float64)
    rounding = (terms + 1.0) * U / (1.0 - (terms + 1.0) * U)
    p = power.double()
    err = runs * (rounding * torch.matmul(p, aw) + 2.0 * (terms + 1.0) * TINY)
    err = err + torch.matmul(_finite(bp), aw)
    b = _unbig(_log_bound(err, torch.matmul(p, w) + fbank.log_off, runs))
    if fbank.renorm_effective:
        b = b * fbank.renorm_scale
    return b


def in_float32_range(power: torch.Tensor, log_power: Optional[torch.Tensor],
                     mel: torch.Tensor, mel_w: torch.Tensor):
    """The float64 frontend outputs (power [..., n_bins], log power, log mel
    [..., n_mel]) carried into float32's range, where a float32 run's
    non-finite values are: a power past float32's largest is +inf, and so
    is its log; a log mel reading an infinite bin is NaN where a zero or
    negative weight meets it (0 * inf, inf - inf), +inf where only positive
    weights do."""
    over = power > torch.finfo(torch.float32).max
    if not bool(over.any()):
        return power, log_power, mel
    inf = torch.full_like(power, math.inf)
    power = torch.where(over, inf, power)
    if log_power is not None:
        log_power = torch.where(over, inf, log_power)
    o, w = over.double(), mel_w.double()
    pos = torch.matmul(o, (w > 0).double()) > 0
    bad = torch.matmul(o, (~(w > 0)).double()) > 0
    mel = torch.where(pos, torch.full_like(mel, math.inf), mel)
    mel = torch.where(bad, torch.full_like(mel, math.nan), mel)
    return power, log_power, mel


def frontend_bounds(signals: torch.Tensor, starts: torch.Tensor, win: int,
                    power: torch.Tensor, mel_w: torch.Tensor, *, dft: DFTParams,
                    fbank: FilterBank, passes: int = 6, signal_len=None,
                    window_fn=None, any_order: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(power, log power, log mel) bounds of the frontend over the windows
    of ``win`` samples at ``starts`` (any shape) of ``signals`` [B, S]
    (zero past ``signal_len`` where given, as the gather frontend reads
    them), given the float64 ``power`` of the same windows
    [B, *starts.shape, n_bins], the mel weights [n_bins, n_mel] and the
    analysis window folded into the basis (``window_fn``, None for none)."""
    x = extract_windows(signals.double(), starts, win, signal_len)
    bp = power_bound(x, power, passes, window_fn, any_order)
    return bp, log_power_bound(bp, power, dft), mel_bound(bp, power, mel_w, fbank)


def pair_frontend_bounds(signals: torch.Tensor, starts: torch.Tensor, win: int,
                         power: torch.Tensor, mel_w: torch.Tensor, *,
                         dft: DFTParams, fbank: FilterBank, passes: int,
                         window_fn=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(power, log power, log mel) bounds of two float32 runs of the same
    grade's products summed in other orders (the card's kernel and the
    plain version's limb emulation at ``passes``) around each other,
    ``power`` one run's float32 power [B, *starts.shape, n_bins]: each
    run's components within the grade's rounding d_k (:func:`_order_rounding`)
    of the exact sums of those products, so the two within D = 2 d_k of
    each other; the power within 2 sqrt(2 p) D + 2 D^2 plus both squares'
    rounding, and both runs' log and mel sum roundings. No grade term: a
    run of other products (another grade) leaves it."""
    y = _windowed(extract_windows(signals.double(), starts, win), window_fn)
    p = power.double()
    dd = 2.0 * _order_rounding(y, p.shape[-1], passes, False)
    bp = 2.0 * torch.sqrt(2.0 * p) * dd + 2.0 * dd * dd + 2.0 * gamma(2) * p + 6 * TINY
    return (bp, log_power_bound(bp, p, dft, runs=2),
            mel_bound(bp, p, mel_w, fbank, runs=2))


# ----------------------------------------------------------------------
# the slice
# ----------------------------------------------------------------------


class _Stages(NamedTuple):
    """What the stages after the frontend read of a pipeline (SndEnv or
    SegmentPipeline)."""

    dft: DFTParams
    fbank: FilterBank
    mfcc: bool
    deltas: bool
    n_coefs: int
    energy_mode: str
    delta_mode: str
    dct: torch.Tensor
    gset: object
    bank: torch.Tensor
    pools: Optional[Tuple[int, int]]
    layout: object          # ([..., fI, tI, 2, nf], steps) -> the output's layout
    kwta: KWTAParams
    settle: object          # float64 ge, batch_ndim -> settled act


def _stages(env) -> _Stages:
    if hasattr(env, "cfg"):                               # SndEnv
        cfg = env.cfg
        n_mel = cfg.mel.fbank.n_filters
        pools = ((cfg.gbor_out_pools_y, cfg.gbor_out_pools_x) if env.is_4d
                 else None)

        def layout(gab4, n_time):
            lead = gab4.shape[:-4]
            if pools is not None:
                raw = gab4.new_zeros(lead + pools + gab4.shape[-2:])
                raw[..., :gab4.shape[-4], :gab4.shape[-3], :, :] = gab4
                return raw
            _, tms = gabor_out_counts((n_mel, n_time), cfg.gabor)
            raw = to_layout_2d(gab4, cfg.by_time, tms)
            uy, ux = env.gabor_output_shape()
            if raw.shape[-2:] != (uy, ux):
                buf = raw.new_zeros(lead + (uy, ux))
                buf[..., :raw.shape[-2], :raw.shape[-1]] = raw
                raw = buf
            return raw

        def settle(ge, batch_ndim):
            if pools is not None:
                ext = inhib4(cfg.neigh_inhib, ge, env._orients)
                pool = (ge.ndim - 2, ge.ndim - 1) if cfg.kwta_pool else None
            else:
                ext, pool = torch.zeros_like(ge), None
            return _settle(cfg.kwta, ge, ext, batch_ndim, pool)

        return _Stages(cfg.dft, cfg.mel.fbank, cfg.mel.mfcc, cfg.mel.deltas,
                       cfg.mel.n_coefs, cfg.energy_mode, cfg.delta_mode,
                       env.dct, cfg.gabor, env.gabor, pools, layout, cfg.kwta,
                       settle)
    # SegmentPipeline: gaborview's energy and deltas, the 2-D layout, KWTALayer
    n_mel = env.mel.fbank.n_filters

    def layout(gab4, n_time):
        tms = gabor_out_counts((n_mel, n_time), env.gabor)[1]
        return to_layout_2d(gab4, env.by_time, tms)

    settle = lambda ge, batch_ndim: _settle(env.kwta, ge, torch.zeros_like(ge),
                                            batch_ndim, None)
    return _Stages(env.dft, env.mel.fbank, env.mel.mfcc, env.mel.deltas,
                   env.mel.n_coefs, "gaborview", "gaborview", env.consts["dct"],
                   env.gabor, env.consts["gabor"], None, layout, env.kwta, settle)


def stage_bound(b: torch.Tensor, x: torch.Tensor, op, n_terms: int) -> torch.Tensor:
    """The bound of a linear stage's float32 output: |A| b + gamma_(n+1)
    |A| |x|, for ``op`` the stage built with |A| (n terms a sum, +1 for the
    operator's rounding to float32), its input's bound ``b`` and float64
    input ``x``."""
    return _unbig(op(_finite(b)) + gamma(n_terms + 1) * op(x.abs().nan_to_num(nan=0.0)))


def _gabor_stage(st: _Stages, mel_fs: torch.Tensor, bank: torch.Tensor,
                 both: bool) -> torch.Tensor:
    """The gabor stage on [..., n_mel, steps] in float64: the valid strided
    convolution with ``bank`` [nf, sy, sx] times the gain, half-rectified
    into the on/off channels (``both``: the value on both, for a bound), in
    the output's layout."""
    gset = st.gset
    n_freq, n_time = mel_fs.shape[-2:]
    fc, tc = gabor_out_counts((n_freq, n_time), gset, st.pools)
    lead = mel_fs.shape[:-2]
    x = mel_fs.double().reshape((-1, 1, n_freq, n_time))
    out = F.conv2d(x, bank.double()[:, None], stride=(gset.stride_y, gset.stride_x))
    out = gset.gain * out[:, :, :fc, :tc]                    # [N, nf, fI, tI]
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    if both:
        on = off = out
    else:
        on, off = torch.where(out >= 0, out, zero), torch.where(out >= 0, zero, -out)
    res = torch.stack([on, off], dim=2).permute(0, 3, 4, 2, 1)  # [N, fI, tI, 2, nf]
    return st.layout(res.reshape(lead + res.shape[1:]), n_time)


def gabor_reference(env, mel_fs: torch.Tensor) -> torch.Tensor:
    """The gabor stage of ``env`` (SndEnv or SegmentPipeline) applied in
    float64 to a run's own log mel [..., n_mel, steps] (NaN read as 0.5, as
    the stage does)."""
    st = _stages(env)
    mel = mel_fs.detach().double()
    mel = torch.where(torch.isnan(mel), torch.full_like(mel, 0.5), mel)
    return _gabor_stage(st, mel, st.bank, False)


def _chain_bounds(st: _Stages, p, bp, valid, steps: int,
                  mel_w) -> Dict[str, torch.Tensor]:
    """The bounds of every output from the float64 power ``p`` and its bound
    ``bp`` [..., steps, n_bins]: the steps the runs mask (not ``valid``
    [..., steps]) are exact zeros in both, bound 0. The stages' own
    rounding reads the float64 chain, computed here from ``p``."""
    zero = torch.zeros((), dtype=torch.float64, device=p.device)
    v = valid[..., None]
    masked = lambda b: torch.where(v, b, zero)
    swap = lambda x: x.transpose(-1, -2)
    w = mel_w.double()
    if st.dft.comp_log_pow:
        logp = masked(floored_log(p, st.dft.log_offset, st.dft.log_min))
        blogp = masked(log_power_bound(bp, p, st.dft))
    else:
        logp = blogp = torch.zeros_like(p)
    mel = floored_log(torch.matmul(p, w), st.fbank.log_off, st.fbank.log_min)
    if st.fbank.renorm_effective:
        mel = mel_renorm(mel, st.fbank)
    mel = masked(mel)
    bmel = masked(mel_bound(bp, p, w, st.fbank))
    out = {"power_segment": swap(masked(bp)), "log_power_segment": swap(blogp),
           "mel_fbank_segment": swap(bmel)}
    # Energy: a sum of the narrow log power over steps or bins
    nb = p.shape[-1]
    en_bins = steps if st.energy_mode in ("sndenv", "gaborview") else nb
    to_energy = lambda x: energy(x, st.energy_mode)
    en = to_energy(logp[..., :en_bins])
    b_en = stage_bound(blogp[..., :en_bins], logp[..., :en_bins], to_energy,
                       max(steps, en_bins))
    out["energy"] = b_en
    if st.mfcc:
        dct = st.dct.double()
        n_mel = dct.shape[0]
        mfcc = masked(torch.matmul(mel.nan_to_num(nan=0.0), dct.T)[..., :st.n_coefs])
        mfcc = torch.cat([en[..., None], mfcc[..., 1:]], dim=-1)
        b_mfcc = masked(stage_bound(bmel, mel, lambda x: torch.matmul(x, dct.abs().T),
                                    n_mel)[..., :st.n_coefs])
        b_mfcc = torch.cat([b_en[..., None], b_mfcc[..., 1:]], dim=-1)
        out["mfcc_segment"] = swap(b_mfcc)
        if st.deltas:
            k = steps * st.n_coefs
            m = _delta_tensors(steps, st.n_coefs, 2, st.delta_mode, torch.float64,
                               p.device)[0]
            apply = lambda x, op: torch.matmul(x.reshape(x.shape[:-2] + (k,)),
                                               op.T).reshape(x.shape)
            b_d = stage_bound(b_mfcc, mfcc, lambda x: apply(x, m.abs()), k)
            out["mfcc_deltas"] = swap(b_d)
            out["mfcc_delta_deltas"] = swap(stage_bound(
                b_d, apply(mfcc, m), lambda x: apply(x, m.abs()), k))
    if st.gset.n_filters:
        mel_fs = swap(mel)
        nan = torch.isnan(mel_fs)
        x = torch.where(nan, torch.full_like(mel_fs, 0.5), mel_fs)
        b = torch.where(nan, torch.zeros_like(mel_fs), swap(bmel))
        bank = st.bank.double().abs()
        out["gabor_raw"] = stage_bound(
            b, x, lambda y: _gabor_stage(st, y, bank, True),
            st.gset.size_x * st.gset.size_y)
    return out


def step_validity(env, lengths, ends: torch.Tensor,
                  seg_ids: torch.Tensor) -> torch.Tensor:
    """SndEnv's step validity [B, seg, steps]: a step's window inside the
    true length (sndenv.go:353-359) and its segment below SegCnt (Go
    truncating division by the channels, sndenv.go:263-265)."""
    t, ch = env.timing, env.channels
    lens = torch.as_tensor(lengths, device=ends.device).to(torch.int64)
    siglen = torch.div(lens - t.segment_samples * ch, ch, rounding_mode="trunc")
    seg_cnt = torch.div(siglen, t.stride_samples, rounding_mode="trunc") + 1
    return ((ends[None] <= lens[:, None, None])
            & (seg_ids[None, :] < seg_cnt[:, None])[..., None])


def slice_bounds(env, signals, lengths, add_ms: int = 0,
                 segments: Optional[Tuple[int, int]] = None,
                 passes: int = 6, any_order: bool = False) -> Dict[str, torch.Tensor]:
    """Elementwise bounds of every float32 output of the slice but the kWTA
    (see :func:`settle_reference`) around the float64 run of the SndEnv
    ``env``'s configuration on ``signals`` [B, S] and ``lengths`` [B];
    ``env`` holds the constants in float64 (on any device: it runs no
    forward); ``passes`` is the float32 run's kernel grade, ``any_order``
    whether its DFT sums in an order the model does not know (the JAX
    package's XLA formulations). Keys are the SndEnvOutputs
    fields, each bound in its field's layout; mel_fbank_global is bounded
    where ``env`` is on the uniform grid."""
    cfg, t = env.cfg, env.timing
    dev = env.device
    sig = torch.as_tensor(signals, device=dev).double()
    lens = torch.as_tensor(lengths, device=dev).to(torch.int64)
    offset0, n_flat, map_idx, starts, ends, seg_ids, route = env._grid_for(
        sig.shape[-1], add_ms, segments)
    nb, nm, steps = t.n_bins, cfg.mel.fbank.n_filters, t.segment_steps
    basis = (env.dft_cos[:, :nb].double(), env.dft_sin[:, :nb].double())
    w = env.mel_w[:nb, :nm].double()
    # the kernel's grade on both of its routes; the gather zeroes the
    # windows past the true length (the smoothing reads them), the kernel
    # reads the buffer (its invalid steps are masked after)
    grade = passes if route in ("kernel", "per_segment") else 6
    x = extract_windows(sig, starts, t.win_samples,
                        lens if route == "gather" else None)  # [B, seg, steps, win]
    p = power_spectrum(x, basis)
    bp = power_bound(x, p, grade, env.analysis_win, any_order)
    del x
    if route != "kernel" and cfg.dft.prev_smooth != 0.0:
        p, bp = _smoothed(p, bp, cfg.dft)
    out = _chain_bounds(_stages(env), p, bp,
                        step_validity(env, lens, ends, seg_ids), steps, w)
    if map_idx is not None:
        gs = offset0 + t.step_samples * torch.arange(n_flat, device=dev)
        xg = extract_windows(sig, gs, t.win_samples,
                             lens if route == "gather" else None)
        pg = power_spectrum(xg, basis)
        out["mel_fbank_global"] = mel_bound(
            power_bound(xg, pg, grade, env.analysis_win, any_order), pg, w,
            cfg.mel.fbank)
    return out


def _smoothed(p, bp, dft: DFTParams):
    """p'_t = a p'_(t-1) + c p_t over the steps (axis -2), and its bound:
    the recurrence applied to the bound, each step adding its two
    roundings."""
    a, c = dft.prev_smooth, dft.cur_smooth
    ps, bs = [p[..., 0, :]], [bp[..., 0, :]]
    for i in range(1, p.shape[-2]):
        ps.append(a * ps[-1] + c * p[..., i, :])
        bs.append(a * bs[-1] + c * bp[..., i, :] + gamma(2) * ps[-1])
    return torch.stack(ps, -2), torch.stack(bs, -2)


def segment_bounds(pipe, signal, start_ms: float, end_ms: float,
                   any_order: bool = False) -> Dict[str, torch.Tensor]:
    """:func:`slice_bounds` for a SegmentPipeline ``pipe`` (its constants
    in float64) on one [start, end] slice of ``signal`` (1-D or [B, S])."""
    start_ms, end_ms, steps = pipe.setup(start_ms, end_ms)
    sig = torch.as_tensor(signal, device=pipe.device).double()
    squeeze = sig.ndim == 1
    sig2 = sig[None] if squeeze else sig
    offset0 = (msec_to_samples(start_ms, pipe.sample_rate)
               - pipe.step_samples * pipe.wparams.border_steps)
    starts = offset0 + pipe.step_samples * torch.arange(steps, device=sig.device)
    n = sig2.shape[-1]
    valid = starts + pipe.win_samples <= n
    nb, nm = pipe.n_bins, pipe.mel.fbank.n_filters
    c = pipe.consts
    smooth = pipe.dft.prev_smooth != 0.0
    x = extract_windows(sig2, starts, pipe.win_samples,
                        torch.full((sig2.shape[0],), n, device=sig.device)
                        if smooth else None)
    p = power_spectrum(x, (c["dft_cos"][:, :nb].double(), c["dft_sin"][:, :nb].double()))
    bp = power_bound(x, p, 6, pipe.analysis_win, any_order)
    if smooth:
        p, bp = _smoothed(p, bp, pipe.dft)
    out = _chain_bounds(_stages(pipe), p, bp, valid.expand(sig2.shape[0], -1),
                        steps, c["mel_w"][:nb, :nm])
    return {k: v[0] for k, v in out.items()} if squeeze else out


def stream_bounds(sp, segment: int, any_order: bool = False) -> Dict[str, torch.Tensor]:
    """:func:`slice_bounds` for the processspeech StreamingProcessor ``sp``
    (its constants in float64, its sound loaded) at ``segment``, in its
    outputs' layouts ([k, steps, channels], the gabor's [channels, y, x,
    2, nf]): the MFCC keeps every coefficient, c0 as ln(1 + c0^2), whose
    change is at most c0's (|2c / (1 + c^2)| <= 1) plus ln's rounding."""
    t = sp.timing
    sig = sp._signal_dev.double()
    nb, nm = t.n_bins, sp.mel.fbank.n_filters
    starts = (sp._offsets + segment * t.segment_samples)[None, :]
    valid = starts + t.win_samples <= sig.shape[-1]             # [1, steps]
    zero = torch.zeros((), dtype=torch.float64, device=sig.device)
    x = torch.where(valid[..., None],
                    extract_windows(sig, starts, t.win_samples), zero)
    p = power_spectrum(x, (sp.dft_cos[:, :nb].double(), sp.dft_sin[:, :nb].double()))
    bp = power_bound(x, p, 6, sp.analysis_win, any_order)
    if sp.dft.prev_smooth != 0.0:
        p, bp = _smoothed(p, bp, sp.dft)
    st = _Stages(sp.dft, sp.mel.fbank, False, False, 0, "spectral", "", sp.dct,
                 sp.gabor_set, sp.gabor, None, lambda g, n: g, None, None)
    b = _chain_bounds(st, p, bp, valid, t.segment_steps, sp.mel_w[:nb, :nm])
    # the chain's [ch, 1, k, steps] -> the processor's [k, steps, ch]
    refshape = lambda x: x[:, 0].permute(1, 2, 0)
    out = {k: refshape(b[k]) for k in ("power_segment", "log_power_segment",
                                       "mel_fbank_segment")}
    if sp.mel.mfcc:
        v = valid[..., None]
        w = sp.mel_w[:nb, :nm].double()
        mel = floored_log(torch.matmul(p, w), sp.mel.fbank.log_off,
                          sp.mel.fbank.log_min)
        if sp.mel.fbank.renorm_effective:
            mel = mel_renorm(mel, sp.mel.fbank)
        mel = torch.where(v, mel, zero)
        dct = sp.dct.double()
        bmel = b["mel_fbank_segment"].transpose(-1, -2)
        bm = stage_bound(bmel, mel, lambda y: torch.matmul(y, dct.abs().T), nm)
        c0 = torch.matmul(mel.nan_to_num(nan=0.0), dct[:1].T)
        c0 = torch.log(1.0 + c0 * c0)
        b0 = bm[..., :1] + LOG_ULPS * U * (1.0 + c0.abs()) + U
        out["mfcc_segment"] = refshape(torch.where(
            v, torch.cat([b0, bm[..., 1:]], -1), zero).transpose(-1, -2))
    out["gabor"] = b["gabor_raw"][:, 0]
    return out


# ----------------------------------------------------------------------
# the kWTA settle
# ----------------------------------------------------------------------


def settle_reference(env, gabor_raw: torch.Tensor, batch_ndim: int = 2) -> torch.Tensor:
    """The kWTA settle of ``env`` (SndEnv, or SegmentPipeline with
    ``batch_ndim`` 1, or 0 for one slice) applied in float64 to a run's own
    ``gabor_raw`` (with the neighbor inhibition it reads in the 4-D
    layout): what that run's gabor_kwta must be within
    :func:`settle_bound`."""
    st = _stages(env)
    ge = gabor_raw.detach().double()
    return st.settle(ge, batch_ndim) if st.kwta.on else ge


def settle_bound(params: KWTAParams, gabor_raw: torch.Tensor) -> float:
    """Bound of a float32 settle around :func:`settle_reference` on the same
    ``gabor_raw``: each of ``iters`` iterations rounds a unit's drive and
    activation SETTLE_OPS times, on terms of at most 1 + gbar_e max ge in
    magnitude (ge_thr is O(1) in the reversal potentials' units), and the
    iterations' errors add. The XX1's slope (up to xx1_gain) does not
    multiply them: act moves by act_dt of the XX1's change each iteration,
    and a unit's XX1 is flat where it is off or saturated."""
    if not params.on or gabor_raw.numel() == 0:
        return 0.0
    ge = float(torch.nan_to_num(gabor_raw.detach().double()).abs().max())
    return params.iters * SETTLE_OPS * U * (1.0 + params.gbar_e * ge)


# ----------------------------------------------------------------------
# sums, means and the check
# ----------------------------------------------------------------------


def sum_bounds(bmel: torch.Tensor, mel: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounds of the per-band sum and sum of squares of the log mel over
    the ``valid`` steps (SndEnv's feature stats), given the elements'
    bounds ``bmel`` and float64 values ``mel`` [..., n_mel] (steps on the
    leading axes): the sum of the elements' bounds plus the n-term sum's
    own rounding."""
    v = valid[..., None]
    zero = torch.zeros((), dtype=torch.float64, device=mel.device)
    b = torch.where(v, _finite(bmel.double()), zero)
    x = torch.where(v, mel.double().abs(), zero)
    axes = tuple(range(mel.ndim - 1))
    n = int(valid.sum())
    s = _unbig(b.sum(axes) + gamma(n) * x.sum(axes))
    sq = _unbig((2.0 * x * b + b * b).sum(axes) + gamma(n + 1) * (x * x).sum(axes))
    return s, sq


def mean_std_bounds(bmel: torch.Tensor, mel: torch.Tensor,
                    valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounds of the per-band mean and standard deviation of the log mel
    over the ``valid`` steps (the corpus statistics: float32 sums, their
    moments in float64): the mean of the elements' bounds (and of the
    squares'), plus the sums' rounding; the deviation's from its variance,
    |d sigma| <= |d var| / sigma."""
    n = max(int(valid.sum()), 1)
    s, sq = sum_bounds(bmel, mel, valid)
    v = valid[..., None]
    x = torch.where(v, mel.double(), torch.zeros((), dtype=torch.float64,
                                                 device=mel.device))
    axes = tuple(range(mel.ndim - 1))
    mean = x.sum(axes) / n
    sigma = torch.sqrt(torch.clamp((x * x).sum(axes) / n - mean * mean, min=0.0))
    b_mean = s / n
    b_var = sq / n + 2.0 * mean.abs() * b_mean + b_mean * b_mean
    b_std = torch.where(sigma > 0, b_var / sigma, torch.sqrt(b_var))
    return b_mean, b_std


def hold(got, ref, bounds: Dict[str, torch.Tensor], env=None,
         label: str = "", batch_ndim: int = 2) -> Dict[str, float]:
    """Hold the float32 outputs ``got`` (a mapping of SndEnvOutputs field
    -> array: torch, NumPy or any array NumPy takes) to the float64 run
    ``ref`` (SndEnvOutputs) within ``bounds`` (:func:`slice_bounds`):
    step_valid exactly, gabor_kwta against :func:`settle_reference` of
    ``got``'s own gabor_raw, or else of :func:`gabor_reference` of its own
    mel (``env``: the float64 SndEnv), within :func:`settle_bound`, every
    other field within its bound, NaN and +-inf at ``ref``'s positions. Raises AssertionError
    naming the field; returns each field's share of its bound."""
    shares = {}
    for name, g in got.items():
        if g is None:
            continue
        g = torch.as_tensor(_host(g))
        if name == "step_valid":
            want = ref["step_valid"] if isinstance(ref, dict) else ref.step_valid
            if not torch.equal(g.bool(), want.cpu()):
                raise AssertionError(f"{label}step_valid differs")
            continue
        if name == "gabor_kwta":
            raw = got.get("gabor_raw")
            if raw is not None:
                raw = torch.as_tensor(_host(raw))
            elif got.get("mel_fbank_segment") is not None:
                raw = gabor_reference(
                    env, torch.as_tensor(_host(got["mel_fbank_segment"])))
            else:
                raise AssertionError(f"{label}gabor_kwta is held through the "
                                     "run's own gabor_raw or mel, which it lacks")
            r = settle_reference(env, raw, batch_ndim).cpu()
            b = torch.full_like(r, settle_bound(_stages(env).kwta, raw))
        else:
            r = ref[name] if isinstance(ref, dict) else getattr(ref, name)
            r, b = r.cpu(), bounds[name].cpu()
        try:
            shares[name] = share(g, r, b)
        except ValueError as e:
            raise AssertionError(f"{label}{name}: {e}") from None
        if not shares[name] <= 1.0:
            raise AssertionError(f"{label}{name}: at {shares[name]:.3g} of "
                                 "its float32 bound")
    return shares


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    import numpy as np
    return np.array(x)
