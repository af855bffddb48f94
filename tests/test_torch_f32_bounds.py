"""Controls on both sides of the float32 error model
(auditory_tpu_torch/utils/f32_bounds.py), on the CPU.

The model holds: the plain float32 frontend (exact grade, passes=6) on
hypothesis-drawn rows (a tone at any frequency, silence, noise, a 1e30 tone
whose power overflows float32) and the whole slice at B=3 stay within the
model's bound of the float64 run.

The model still catches what the fixed bounds caught: the limb emulation at
passes=3 leaves the exact grade's bound in log power and log mel on the
flagship rows, passes=1 leaves it on every output, and a delta operator
with one coefficient changed by 1e-3 leaves the deltas' bound.

The pair bound (two runs of one grade's products in other sum orders, as
chip_smoke.py holds the card's kernel against the limb emulation) holds
the emulation around the exact sums of its own products, and the exact
grade's products leave it where they leave the grade's bound."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import auditory_tpu_torch as at
from auditory_tpu_torch import config as tcfg
from auditory_tpu_torch.dsp.dft import floored_log
from auditory_tpu_torch.dsp.frame import extract_windows
from auditory_tpu_torch.dsp.mel import delta_operator
from auditory_tpu_torch.ops import framefft
from auditory_tpu_torch.utils import f32_bounds as fb
from tests.conftest import default_cfg_2d, tone
from tests.test_torch_framefft import _bounds, _case, _f64, _port, _shares
from tests.test_torch_sndenv import hold_f32

CPU = torch.device("cpu")
SR = 16000

torch.set_num_threads(1)

# one row of the flagship geometry's buffer (0.3 s, padded)
_ROW = _case("flagship_16k")["sig"].shape[-1]


def _row(kind, freq, amp, seed):
    rng = np.random.default_rng(seed)
    if kind == "tone":
        return tone(freq, _ROW / SR, SR, amp=amp, dither=0.0)[:_ROW]
    if kind == "silence":
        return np.zeros(_ROW)
    if kind == "noise":
        return amp * rng.standard_normal(_ROW)
    # a tone off every bin at 1e30: every bin's power past float32's range
    return 1e30 * np.sin(2 * np.pi * (freq + 0.5 * SR / 400) * np.arange(_ROW) / SR)


ROWS = st.tuples(st.sampled_from(["tone", "silence", "noise", "overflow"]),
                 st.floats(0.0, SR / 2), st.floats(1e-3, 1.0),
                 st.integers(0, 2**31 - 1))


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(rows=st.lists(ROWS, min_size=1, max_size=3))
def test_plain_frontend_within_the_model(rows):
    c = _case("flagship_16k", rows=lambda n: np.stack([_row(*r) for r in rows]))
    f64, bounds = _bounds(c)
    w = torch.as_tensor(c["consts"]["mel_w"], dtype=torch.float64)
    want = fb.in_float32_range(*f64, w[:c["t"].n_bins, :32])
    for g, r, b in zip(_port(c), want, bounds):
        assert fb.share(g, r, b) <= 1.0


def _slice_rows(seed):
    rng = np.random.default_rng(seed)
    env = at.SndEnv(default_cfg_2d(), SR, device=CPU)
    n = env.pad(np.zeros(int(0.35 * SR))).shape[0]
    f = rng.uniform(50.0, 7900.0, size=2)
    rows = np.stack([tone(f[0], n / SR, SR, dither=0.0)[:n],
                     tone(f[1], n / SR, SR, amp=0.05)[:n] + 0.02 * rng.standard_normal(n),
                     0.1 * rng.standard_normal(n)]).astype(np.float32)
    return rows, np.array([n, n - 3000, n - 1500])


@settings(max_examples=4, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_slice_within_the_model(seed):
    signals, lengths = _slice_rows(seed)
    out, _ = at.SndEnv(default_cfg_2d(), SR, device=CPU)(
        torch.as_tensor(signals), torch.as_tensor(lengths))
    hold_f32({"port": out}, default_cfg_2d(), SR, signals, lengths)


def test_three_passes_leave_the_bound_in_log_power_and_log_mel():
    c = _case("flagship_16k")
    exact = _shares(c, _port(c))
    three = _shares(c, _port(c, lambda *a, **kw: at.ops.framefft.fused_frame_power_mel(
        *a, **kw, passes=3)))
    assert max(exact) <= 0.5
    assert three[1] > 1.0 and three[2] > 1.0
    # and stay within the bound of their own grade
    assert max(_shares(c, _port(c, lambda *a, **kw: at.ops.framefft.fused_frame_power_mel(
        *a, **kw, passes=3)), passes=3)) <= 1.0


@pytest.mark.parametrize("name", ["flagship_16k", "44k1", "hamming_16k"])
def test_one_pass_leaves_the_bound_everywhere(name):
    c = _case(name)
    one = _shares(c, _port(c, lambda *a, **kw: at.ops.framefft.fused_frame_power_mel(
        *a, **kw, passes=1)))
    assert min(one) > 1.0


def test_perturbed_delta_operator_leaves_the_bound():
    """The deltas of the run's own MFCC through the delta operator with one
    coefficient changed by 1e-3 (the energy coefficient of a middle step
    into the same coefficient of the next) leave the deltas' bound; through
    the operator itself they stay within it."""
    from tests.test_torch_sndenv import _batch

    signals, lengths = _batch()
    cfg = default_cfg_2d()
    out, _ = at.SndEnv(cfg, SR, device=CPU)(torch.as_tensor(signals),
                                            torch.as_tensor(lengths))
    _, ref, bounds, _ = hold_f32({"port": out}, cfg, SR, signals, lengths)
    bounds = bounds["port"]
    steps, n_coefs = out.mfcc_segment.shape[-1], out.mfcc_segment.shape[-2]
    k = steps * n_coefs
    m = torch.as_tensor(delta_operator(steps, n_coefs, 2, cfg.delta_mode)[0]
                        .reshape(k, k), dtype=torch.float32)
    x = out.mfcc_segment.transpose(-1, -2).reshape(-1, k)

    def deltas(op):
        return (x @ op.T).reshape(out.mfcc_segment.shape[:-2] + (steps, n_coefs)
                                  ).transpose(-1, -2)

    assert fb.share(deltas(m), ref.mfcc_deltas, bounds["mfcc_deltas"]) <= 1.0
    bad = m.clone()
    t = steps // 2
    bad[(t + 1) * n_coefs, t * n_coefs] += 1e-3
    assert fb.share(deltas(bad), ref.mfcc_deltas, bounds["mfcc_deltas"]) > 1.0


def _grade_sums(c, passes):
    """Case ``c``'s (power, log power, log mel) with each DFT component the
    exact (float64) sum of the products the grade ``passes`` forms: the
    bf16 limbs of the float32 windows and basis, paired as limb_terms."""
    t, n_mel = c["t"], c["fb"].n_filters
    k = {n: torch.as_tensor(c["consts"][n], dtype=torch.float32)
         for n in ("dft_cos", "dft_sin", "mel_w")}
    starts = c["offset0"] + t.step_samples * torch.arange(c["n_windows"])
    nl = framefft.n_limbs(passes)
    x = [v.double() for v in framefft.split_limbs(
        extract_windows(torch.as_tensor(c["sig"]), starts, t.win_samples), nl)]

    def component(basis):
        b = [v.double() for v in framefft.split_limbs(basis[:, :t.n_bins], nl)]
        return sum(x[i] @ b[j] for i, j in framefft.limb_terms(nl))

    p = component(k["dft_cos"]) ** 2 + component(k["dft_sin"]) ** 2
    dft, fbank = tcfg.DFTParams(), tcfg.FilterBank()
    return (p, floored_log(p, dft.log_offset, dft.log_min),
            floored_log(p @ k["mel_w"][:t.n_bins, :n_mel].double(),
                        fbank.log_off, fbank.log_min))


@pytest.mark.parametrize("passes", [3, 1])
def test_pair_bound_holds_one_grades_products_only(passes):
    c = _case("flagship_16k")
    t = c["t"]
    emu = _port(c, lambda *a, **kw: framefft.fused_frame_power_mel(
        *a, **kw, passes=passes))
    starts = c["offset0"] + t.step_samples * torch.arange(c["n_windows"])
    w = torch.as_tensor(c["consts"]["mel_w"], dtype=torch.float64)
    pair = fb.pair_frontend_bounds(
        torch.as_tensor(c["sig"]), starts, t.win_samples, emu[0],
        w[:t.n_bins, :c["fb"].n_filters], dft=tcfg.DFTParams(),
        fbank=tcfg.FilterBank(), passes=passes)
    # one run of the two: within half the pair's bound of the exact sums
    own = [fb.share(e, x, b) for e, x, b in zip(emu, _grade_sums(c, passes), pair)]
    assert max(own) <= 0.5
    # the exact grade's products (passes 6, the float64 run) leave it: at 1
    # pass in every output, at 3 in power and log power (its log mel, a sum
    # over a band, leaves the one-run bound of
    # test_three_passes_leave_the_bound_in_log_power_and_log_mel by less
    # than the pair's factor of two)
    outputs = list(zip(emu, _f64(c), pair))[:3 if passes == 1 else 2]
    assert min(fb.share(x, e, b) for e, x, b in outputs) > 1.0


@pytest.mark.parametrize("sr,prev_smooth", [(22050, 0.0), (16000, 0.4)],
                         ids=["22k05", "16k_smooth"])
def test_per_segment_bound_holds_six_passes_and_not_one(sr, prev_smooth):
    """The per-segment route's bound (slice_bounds at the kernel's grade on
    "per_segment"): the plain version at passes=6 within it; passes=1
    within its own grade's bound and outside the exact grade's in power,
    log power and log mel."""
    import dataclasses

    cfg = default_cfg_2d()
    cfg = dataclasses.replace(cfg, dft=dataclasses.replace(cfg.dft,
                                                           prev_smooth=prev_smooth))
    env = at.SndEnv(cfg, sr, device=CPU)
    n = env.pad(np.zeros(int(0.35 * sr))).shape[0]
    rows = np.stack([tone(1234.0, n / sr, sr, dither=0.0)[:n]
                     + 0.01 * np.random.default_rng(1234).standard_normal(n),
                     0.2 * np.random.default_rng(5).standard_normal(n)])
    signals, lengths = rows.astype(np.float32), np.array([n, n - int(0.07 * sr)])
    out = {}
    for passes in (6, 1):
        penv = at.SndEnv(cfg, sr, device=CPU, segment_frontend="per_segment",
                         kernel_passes=passes)
        assert penv.route(n) == "per_segment"
        out[passes], _ = penv(torch.as_tensor(signals), torch.as_tensor(lengths))
    env64, ref, bounds, _ = hold_f32({"port": out[6]}, cfg, sr, signals, lengths,
                                     segment_frontend="per_segment")
    hold_f32({"port": out[1]}, cfg, sr, signals, lengths, passes=1,
             segment_frontend="per_segment")
    for key in ("power_segment", "log_power_segment", "mel_fbank_segment"):
        assert fb.share(getattr(out[1], key), getattr(ref, key),
                        bounds["port"][key]) > 1.0, key
