"""The port's SegmentPipeline and compare_segments (the gaborview path)
against the JAX package's on the same numpy inputs (CPU), and its float64
path against the literal Go oracle (refemu.goref), as tests/test_segments.py
holds the JAX one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu.pipeline.segments as jseg
import auditory_tpu_torch as at
from auditory_tpu.config import (
    DFTParams,
    GaborSet,
    KWTAParams,
    MelParams,
    default_gabor_specs,
    msec_to_samples,
)
from auditory_tpu.refemu import goref
from auditory_tpu_torch.ops import framefft
from auditory_tpu_torch.pipeline import segments as tseg
from tests.conftest import tone

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000
# float32 against float32 (kernel's plain version vs JAX's matmul frontend):
# tests/test_pallas.py:34-56 and tests/test_batch_sharding.py:83, as
# tests/test_torch_sndenv.py holds the SndEnv
F32 = {
    "power_segment": dict(rtol=1e-5, atol=1e-4),
    "energy": dict(rtol=1e-4, atol=2e-3),
    "mfcc_segment": dict(rtol=1e-4, atol=2e-3),
    "gabor_raw": dict(rtol=1e-4, atol=1e-3),
    "gabor_kwta": dict(rtol=0, atol=1e-4),
}
# The float32 deltas are not held against another float32 run: the
# 'gaborview' delta operator M (scale npn^2/2, 16x the 'sndenv' one)
# amplifies the MFCC's float32 rounding by the row sums of |M|. Each delta
# stage is held instead to be M applied to its own input, within the
# float32 dot-product bound gamma_K |M| |x| (chip_smoke.py::delta_stage_ratio).
DELTA_STAGES = (("mfcc_segment", "mfcc_deltas"),
                ("mfcc_deltas", "mfcc_delta_deltas"))
# The float32 log power and log mel are held to the bounds the power bound
# implies: |dp| <= 1e-4 + 1e-5 p gives |d ln p| <= (1e-4 + 1e-5 p) / p and,
# through the mel weights W, |d ln m_f| <= (1e-4 sum_k W_kf + 1e-5 m_f) / m_f,
# each on top of its published fixed bound (1e-5; 1e-4 + 1e-5 |ln m|). In a
# bin or band where the windowed tone cancels, p or m is small and both
# DFTs' float32 rounding is a large share of it; a fixed bound holds only
# where they are large.
# float64 matmul basis against JAX's float64 FFT: float64 rounding; the
# gabor stage is float32 by contract on both sides
F64 = dict(rtol=1e-9, atol=1e-8)
F64_GABOR = dict(rtol=1e-5, atol=1e-5)


def gbv_gabor(gain=1.5, phases=(0.0,), stride_x=6):
    # gbv.go InitGabors: 8x8, stride (6,3), gain 1.5, 4 orientations, phase 0
    return GaborSet(size_x=8, size_y=8, stride_x=stride_x, stride_y=3,
                    gain=gain, specs=default_gabor_specs(phases=phases))


def _signals(batch=None, dur=0.6):
    """Dithered tones: a pure tone's stop bins read only rounding, which
    differs between frontends."""
    rng = np.random.default_rng(9)
    rows = [tone(500.0 + 300 * i, dur, SR) + 0.01 * rng.standard_normal(int(dur * SR))
            for i in range(batch or 1)]
    sig = np.stack(rows).astype(np.float32)
    return sig[0] if batch is None else sig


def _pipes(dtype="f32", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "f64": (jnp.float64, torch.float64)}[dtype]
    kw.setdefault("gabor", gbv_gabor())
    return (jseg.SegmentPipeline(SR, dtype=jdt, **kw),
            tseg.SegmentPipeline(SR, dtype=tdt, **kw, device=CPU))


def _assert_delta_stages(tout):
    from auditory_tpu_torch.dsp.mel import delta_operator

    for src, dst in DELTA_STAGES:
        x = tout[src].double().transpose(-1, -2).numpy()  # [.., steps, coefs]
        y = tout[dst].double().transpose(-1, -2).numpy()
        steps, n = x.shape[-2:]
        k = steps * n
        m = delta_operator(steps, n, 2, "gaborview")[0].reshape(k, k)
        x, y = x.reshape(-1, k), y.reshape(-1, k)
        gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
        lim = gamma * (np.abs(x) @ np.abs(m).T)
        assert np.all(np.abs(y - x @ m.T) <= lim), dst


def _assert_implied_log_bound(k, jv, tv, jout, wsum):
    jv = jv.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    if k == "log_power_segment":
        p = np.asarray(jout["power_segment"], dtype=np.float64)
        lim = 1e-5 + (1e-4 + 1e-5 * p) / np.maximum(p, 1e-30)
    else:  # [.., n_mel, steps]; m = exp(ln m)
        m = np.exp(np.nan_to_num(jv))
        lim = (1e-4 + 1e-5 * np.abs(np.nan_to_num(jv))
               + (1e-4 * wsum[:, None] + 1e-5 * m) / np.maximum(m, 1e-30))
    d = np.nan_to_num(np.abs(tv - jv))
    assert np.all(d <= lim), (k, float((d / lim).max()))


def _assert_outputs(jout, tout, bounds, gabor_bounds=None, wsum=None):
    assert set(jout) == set(tout)
    for k, jv in jout.items():
        tv = tout[k]
        assert (jv is None) == (tv is None), k
        if jv is None:
            continue
        if bounds is F32 and k in dict(DELTA_STAGES).values():
            assert jv.shape == tv.shape, k
            continue  # held by _assert_delta_stages
        if bounds is F32 and k in ("log_power_segment", "mel_fbank_segment"):
            _assert_implied_log_bound(k, np.asarray(jv), tv.numpy(), jout,
                                      wsum)
            continue
        jv, tv = np.asarray(jv), tv.numpy()
        assert jv.shape == tv.shape, (k, jv.shape, tv.shape)
        if k == "step_valid":
            np.testing.assert_array_equal(tv, jv)
            continue
        np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
        b = bounds[k] if bounds is F32 else bounds
        if gabor_bounds is not None and k.startswith("gabor"):
            b = gabor_bounds
        np.testing.assert_allclose(tv, jv, err_msg=k, **b)
    if bounds is F32 and tout.get("mfcc_deltas") is not None:
        _assert_delta_stages(tout)


@pytest.mark.parametrize("start,end,step,stride_x", [
    (100.0, 150.0, 10.0, 6), (100.0, 200.0, 10.0, 6), (100.0, 240.0, 10.0, 6),
    (10.0, 60.0, 10.0, 6), (33.3, 187.9, 10.0, 3), (0.0, 5.0, 5.0, 3),
])
def test_resize_and_steps_match_jax(start, end, step, stride_x):
    g = gbv_gabor(stride_x=stride_x)
    assert (tseg.resize_segment(start, end, step, g)
            == jseg.resize_segment(start, end, step, g))
    for resize in (True, False):
        wp = dict(win_ms=25.0, step_ms=step, border_steps=1, resize=resize)
        j = jseg.SegmentPipeline(SR, jseg.SegmentWindowParams(**wp), gabor=g)
        t = tseg.SegmentPipeline(SR, tseg.SegmentWindowParams(**wp), gabor=g, device=CPU)
        assert t.setup(start, end) == j.setup(start, end)
        assert t.steps_total(start, end) == j.steps_total(start, end)


@pytest.mark.parametrize("resize", [True, False], ids=["resize", "no_resize"])
@pytest.mark.parametrize("batched", [False, True], ids=["1d", "batch"])
def test_f32_matches_jax(resize, batched):
    wp = dict(wparams=jseg.SegmentWindowParams(resize=resize, border_steps=1))
    jp, tp = _pipes(**wp)
    tp.wparams = tseg.SegmentWindowParams(resize=resize, border_steps=1)
    sig = _signals(batch=3 if batched else None)
    jout, tout = jp.process(sig, 110.0, 275.0), tp.process(sig, 110.0, 275.0)
    if batched:
        assert tout["mel_fbank_segment"].shape[0] == 3
        assert tout["step_valid"].ndim == 1
    _assert_outputs(jout, tout, F32, wsum=_wsum(jp))


def _wsum(pipe):
    return np.nansum(pipe.mel_des.weights, axis=1)


def test_f32_kwta_on_and_overrun_matches_jax():
    """kWTA on, and a slice whose last windows overrun the signal (masked
    steps)."""
    jp, tp = _pipes(kwta=KWTAParams(on=True))
    sig = _signals(dur=0.3)
    jout, tout = jp.process(sig, 200.0, 290.0), tp.process(sig, 200.0, 290.0)
    assert not tout["step_valid"].all()
    assert (tout["gabor_kwta"] != tout["gabor_raw"]).any()
    _assert_outputs(jout, tout, F32, wsum=_wsum(jp))


@pytest.mark.parametrize("dft", [DFTParams(window_fn="hamming"),
                                 DFTParams(prev_smooth=0.4)],
                         ids=["hamming", "prev_smooth"])
def test_f64_dft_options_match_jax(dft):
    jp, tp = _pipes("f64", dft=dft)
    sig = _signals(batch=2)
    _assert_outputs(jp.process(sig, 50.0, 330.0), tp.process(sig, 50.0, 330.0),
                    F64, F64_GABOR)


def test_window_fn_reaches_the_spectrum():
    sig = _signals()
    ham = tseg.SegmentPipeline(SR, dft=DFTParams(window_fn="hamming"),
                               gabor=gbv_gabor(), dtype=torch.float64, device=CPU)
    rect = tseg.SegmentPipeline(SR, gabor=gbv_gabor(), dtype=torch.float64, device=CPU)
    a = ham.process(sig, 50.0, 330.0)["power_segment"]
    b = rect.process(sig, 50.0, 330.0)["power_segment"]
    assert (a - b).abs().max() > 1e-3


def test_stage_parity_vs_go_oracle():
    """mel/power/energy/MFCC of a slice equal the literal per-step oracle
    at the same window starts (tests/test_segments.py:64, on the port)."""
    wp = tseg.SegmentWindowParams(resize=True, border_steps=0)
    mel_params = MelParams()
    pipe = tseg.SegmentPipeline(SR, wp, mel=mel_params, gabor=gbv_gabor(),
                                kwta=KWTAParams(on=False), dtype=torch.float64, device=CPU)
    sig = tone(1100.0, 0.5, SR)
    start_ms, end_ms, steps = pipe.setup(120.0, 260.0)
    out = pipe.process(sig, 120.0, 260.0)

    n_bins = pipe.win_samples // 2 + 1
    nf = mel_params.fbank.n_filters
    power, logpow = np.zeros(n_bins), np.zeros(n_bins)
    power_seg, logpow_seg = np.zeros((n_bins, steps)), np.zeros((n_bins, steps))
    fbank, mel_seg = np.zeros(nf), np.zeros((nf, steps))
    mfcc_seg = np.zeros((mel_params.n_coefs, steps))
    bin_pts, _, tri = goref.init_filters(mel_params.fbank, pipe.win_samples, SR)
    start_sample = msec_to_samples(start_ms, SR)
    for s in range(steps):
        st = start_sample + pipe.step_samples * (s - wp.border_steps)
        en = st + pipe.win_samples
        if en > len(sig):
            break
        window = (np.concatenate([np.zeros(-st), sig[:en]]) if st < 0
                  else sig[st:en])
        goref.dft_filter(pipe.dft, s, window, pipe.win_samples, power, logpow,
                         power_seg, logpow_seg)
        goref.filter_dft(mel_params, s, power, mel_seg, fbank, tri, bin_pts)
        goref.cepstrum_dct(mel_params, s, fbank, mfcc_seg)

    host = lambda k: out[k].numpy()
    np.testing.assert_allclose(host("power_segment"), power_seg, atol=1e-6, rtol=1e-9)
    np.testing.assert_allclose(host("mel_fbank_segment"), mel_seg, atol=1e-5, rtol=0)
    e_ref = logpow_seg[:steps, :].sum(axis=0)
    np.testing.assert_allclose(host("energy"), e_ref, atol=1e-6, rtol=1e-9)
    np.testing.assert_allclose(host("mfcc_segment")[0], e_ref, atol=1e-6, rtol=1e-9)
    np.testing.assert_allclose(host("mfcc_segment")[1:],
                               mfcc_seg[1:mel_params.n_coefs], atol=1e-5, rtol=1e-9)


def _assert_diff_equal(jdiff, tdiff):
    assert sorted(jdiff) == sorted(tdiff)
    for k, je in jdiff.items():
        te = tdiff[k]
        assert sorted(je) == sorted(te), k
        for side in ("a", "b"):
            if side in je:
                assert je[side]["shape"] == te[side]["shape"], k
                assert sorted(je[side]) == sorted(te[side]), k
                for s in ("max_abs", "mean", "active_frac", "nan_frac"):
                    if s in je[side]:
                        assert te[side][s] == pytest.approx(
                            je[side][s], rel=1e-6, abs=1e-9), (k, side, s)
        if "only_in" in je:
            assert te["only_in"] == je["only_in"]
        if "max_abs_diff" in je:
            assert te["max_abs_diff"] == pytest.approx(
                je["max_abs_diff"], rel=1e-6, abs=1e-9), k
        if "nan_mismatch" in je:
            assert te["nan_mismatch"] == je["nan_mismatch"]


@pytest.mark.parametrize("case", ["params", "slices", "mfcc_off_nan"])
def test_compare_segments_matches_jax(case):
    """The diff summary of compare_segments equals the JAX package's
    (float64): differing mel heights and gains, two slices of one
    pipeline, and MFCC off on both sides with a NaN-triangle mel bank on
    one (NaN-aware stats, nan_mismatch)."""
    sig = _signals()
    kw = dict(signal=sig, start_ms=50.0, end_ms=330.0)
    if case == "params":
        a = dict(gabor=gbv_gabor())
        b = dict(gabor=gbv_gabor(gain=3.0), mel=MelParams(fbank=dataclasses.replace(
            MelParams().fbank, n_filters=40)))
    elif case == "slices":
        a = b = dict(gabor=gbv_gabor())
        kw.update(start_ms_b=300.0, end_ms_b=450.0)
    else:
        fb_nan = dataclasses.replace(MelParams().fbank, n_filters=80, hi_hz=4000.0)
        a = dict(gabor=gbv_gabor(), mel=MelParams(mfcc=False))
        b = dict(gabor=gbv_gabor(), mel=MelParams(mfcc=False, fbank=fb_nan))
    ja, ta = _pipes("f64", **a)
    jb, tb = _pipes("f64", **b)
    jres = jseg.compare_segments(ja, jb, **kw)
    tres = tseg.compare_segments(ta, tb, **kw)
    if case == "mfcc_off_nan":
        assert "mfcc_segment" not in tres["diff"]
        assert "nan_frac" in tres["diff"]["mel_fbank_segment"]["b"]
    _assert_diff_equal(jres["diff"], tres["diff"])
    for side in ("a", "b"):
        _assert_outputs(jres[side], tres[side], F64, F64_GABOR)


def test_bounds_shape_and_defaults():
    pipe = tseg.SegmentPipeline(SR, device=CPU)
    assert pipe.gabor.n_filters == 4 and pipe.gabor_bank.shape == (4, 8, 8)
    sig = tone(600.0, 0.5, SR)
    with pytest.raises(ValueError, match="SegmentEnd"):
        pipe.process(sig, 400.0, 380.0)
    with pytest.raises(ValueError, match="1-D or"):
        pipe.process(np.zeros((1, 2, 800)), 10.0, 100.0)
    with pytest.raises(ValueError, match="dtype"):
        tseg.SegmentPipeline(SR, dtype=torch.float16, device=CPU)
    with pytest.raises(ValueError, match="matmul_precision"):
        tseg.SegmentPipeline(SR, matmul_precision="bf16", device=CPU)
    assert at.SegmentPipeline is tseg.SegmentPipeline
    assert at.compare_segments is tseg.compare_segments
    assert at.SegmentWindowParams is tseg.SegmentWindowParams


def test_frontend_is_the_fused_wrapper(monkeypatch):
    """On the uniform slice grid the frontend is fused_frame_power_mel (the
    kernel on a CUDA device), called once per process() with window 0 at
    start_sample - border*step."""
    calls = []
    real = tseg.fused_frame_power_mel

    def spy(signals, step, offset0, n_windows, *args, **kw):
        calls.append((step, offset0, n_windows))
        return real(signals, step, offset0, n_windows, *args, **kw)

    monkeypatch.setattr(tseg, "fused_frame_power_mel", spy)
    pipe = tseg.SegmentPipeline(
        SR, tseg.SegmentWindowParams(resize=False, border_steps=2),
        gabor=gbv_gabor(), device=CPU)
    out = pipe.process(_signals(), 100.0, 200.0)
    assert calls == [(160, 1600 - 2 * 160, 14)]
    assert out["mel_fbank_segment"].shape == (32, 14)
    assert framefft.fused_frame_power_mel is real


def test_gabor_view_example(tmp_path):
    """The port's headless gaborview example over wav + PHN.MS fixtures
    prints what the JAX example prints."""
    import os
    import subprocess
    import sys

    from auditory_tpu_torch.io.wav import float_to_wave, write_wav

    for i in range(2):
        write_wav(str(tmp_path / f"g{i}.wav"),
                  float_to_wave(tone(600 + 300 * i, 0.6, SR), SR))
        (tmp_path / f"g{i}.PHN.MS").write_text("0 h#\n120 sh\n300 iy\n480 h#\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "auditory_tpu_torch.examples.gabor_view",
         str(tmp_path), "sh", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    assert out.returncode == 0, out.stderr[-1500:]
    lines = out.stdout.splitlines()
    assert lines[0] == "8 units loaded; processing 2 of 2 matching rows"
    assert lines[1].startswith("g0 [sh] 120-300 ms -> gabor (18, 12), active")
    assert "  gabor_kwta: A [18, 12]" in out.stdout and "B [18, 40]" in out.stdout
