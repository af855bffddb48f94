"""The fused frontend's plain PyTorch version and the JAX Pallas kernel
(interpret mode, masked mode, 6 passes) or the JAX XLA frontend, each within
the float32 error model's bound of the plain version in float64
(auditory_tpu_torch/utils/f32_bounds.py), on the geometries chip_smoke.py
checks the CUDA kernel at; plus the wrapper's CPU dispatch and input checks. The CUDA kernel itself runs only on the
card: chip_smoke.py holds it against this plain version there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auditory_tpu.config import DFTParams, FilterBank, WindowParams
from auditory_tpu.dsp import design as jdesign
from auditory_tpu.dsp.dft import log_power as jlog_power
from auditory_tpu.dsp.dft import power_spectrum_conv
from auditory_tpu.dsp.mel import apply_mel as japply_mel
from auditory_tpu.ops import framefft as jfft
from auditory_tpu_torch import config as tcfg
from auditory_tpu_torch.convert import constants_from_numpy
from auditory_tpu_torch.dsp.frame import pad_signal
from auditory_tpu_torch.ops import _build, framefft
from auditory_tpu_torch.utils import f32_bounds as f32b
from tests.conftest import tone

torch.set_num_threads(1)

# (sample rate, filter bank, analysis window, seconds, pad?, emit)
GEOMETRIES = {
    "flagship_16k": (16000, FilterBank(), None, 0.3, True, (True, True)),
    "44k1": (44100, FilterBank(), None, 0.15, True, (True, True)),
    "hamming_16k": (16000, FilterBank(), "hamming", 0.3, True, (True, True)),
    "unpadded_16k": (16000, FilterBank(), None, 0.217, False, (True, True)),
    "mel_only_16k": (16000, FilterBank(), None, 0.3, True, (False, False)),
    "nan_mel_8k": (8000, FilterBank(n_filters=80, lo_hz=0.0, hi_hz=4000.0),
                   None, 0.3, True, (True, True)),
}


def _case(name, batch=2, rows=None):
    """Case ``name``'s geometry on its noise-lifted rows, or on ``rows``
    (a function of the buffer length giving the [B, S] signals)."""
    sr, fb, wfn, seconds, pad, emit = GEOMETRIES[name]
    t = WindowParams().derive(sr)
    rng = np.random.default_rng(sr)
    # the added noise lifts the quietest bins off the f32 rounding floor:
    # the log-mel of a near-zero mel sum reads rounding noise, which differs
    # between any two f32 summation orders (a Hamming-windowed pure tone
    # leaves ~1e-6 of power in the lowest mel band)
    sig = tone(1234.0, seconds, sr)
    sig = sig + 0.01 * rng.standard_normal(sig.shape[0])
    if pad:
        sig = pad_signal(sig, t)
    sig = np.stack(
        [sig] + [0.2 * rng.standard_normal(sig.shape[0])] * (batch - 1)
    ).astype(np.float32)
    if rows is not None:
        sig = rows(sig.shape[-1]).astype(np.float32)
    seg = t.seg_cnt(sig.shape[-1])
    n_windows = (seg - 1) * (t.stride_samples // t.step_samples) + t.segment_steps
    offset0 = t.step_offsets[0]
    mel = jdesign.mel_design(fb, t.win_samples, sr)
    awin = jdesign.analysis_window(wfn, t.win_samples)
    cos_m, sin_m = jdesign.dft_matrices(t.win_samples)
    consts = constants_from_numpy(mel.weights, np.eye(1), np.zeros((1, 1, 1)),
                                  cos_m, sin_m, awin)
    return dict(
        sr=sr, fb=fb, emit=emit, t=t, sig=sig, n_windows=n_windows,
        offset0=offset0, mel=mel, awin=awin, basis=(cos_m, sin_m),
        consts=consts,
    )


def _port(c, fn=framefft.fused_frame_power_mel):
    k = {n: torch.as_tensor(c["consts"][n], dtype=torch.float32)
         for n in ("dft_cos", "dft_sin", "mel_w")}
    t, fb = c["t"], c["fb"]
    tfb = tcfg.FilterBank(**dataclasses.asdict(fb))
    return fn(
        torch.as_tensor(c["sig"]), t.step_samples, c["offset0"],
        c["n_windows"], k["dft_cos"], k["dft_sin"], k["mel_w"],
        n_bins=t.n_bins, n_mel=fb.n_filters, dft=tcfg.DFTParams(),
        fbank=tfb, emit=c["emit"],
    )


def _f64(c):
    """The plain version in float64 on case ``c``'s inputs, every output."""
    k = {n: torch.as_tensor(c["consts"][n], dtype=torch.float64)
         for n in ("dft_cos", "dft_sin", "mel_w")}
    t, fb = c["t"], c["fb"]
    return framefft.fused_frame_power_mel_reference(
        torch.as_tensor(c["sig"], dtype=torch.float64), t.step_samples,
        c["offset0"], c["n_windows"], k["dft_cos"], k["dft_sin"], k["mel_w"],
        n_bins=t.n_bins, n_mel=fb.n_filters, dft=tcfg.DFTParams(),
        fbank=tcfg.FilterBank(**dataclasses.asdict(fb)),
    )


def _bounds(c, passes=6, any_order=False):
    """The float32 error model's (power, log power, log mel) bounds of case
    ``c`` at a kernel grade (auditory_tpu_torch/utils/f32_bounds.py;
    ``any_order`` for a run that sums in an order the model does not know,
    as JAX's XLA formulations do), and the float64 outputs they are
    around."""
    t, fb = c["t"], c["fb"]
    ref = _f64(c)
    starts = c["offset0"] + t.step_samples * torch.arange(c["n_windows"])
    w = torch.as_tensor(c["consts"]["mel_w"], dtype=torch.float64)
    b = f32b.frontend_bounds(
        torch.as_tensor(c["sig"]), starts, t.win_samples, ref[0],
        w[:t.n_bins, :fb.n_filters], dft=tcfg.DFTParams(),
        fbank=tcfg.FilterBank(**dataclasses.asdict(fb)), passes=passes,
        window_fn=c["awin"], any_order=any_order)
    return ref, b


def _shares(c, got, passes=6, any_order=False):
    """Each emitted output's share of the model's bound at ``passes``
    (NaN and inf positions those of the float64 run)."""
    ref, bounds = _bounds(c, passes, any_order)
    return [None if g is None else
            f32b.share(torch.as_tensor(np.array(g)), r, b)
            for g, r, b in zip(got, ref, bounds)]


def _assert_close(c, got, ref, passes=6, xla=False):
    """The port's float32 run ``got`` and JAX's ``ref`` of case ``c`` (each
    a (power, log power, log mel) triple, None where not emitted), each
    within the float32 error model's bound of the float64 run at kernel
    grade ``passes``, and within the sum of their bounds of each other.
    ``xla``: JAX's run is an XLA formulation, whose sum order the model
    does not know (its Pallas kernel sums circular ranges of each window,
    which the model bounds directly)."""
    f64, bounds = _bounds(c, passes)
    _, jbounds = _bounds(c, passes, any_order=xla)
    for g, r, want, b, jb in zip(got, ref, f64, bounds, jbounds):
        assert (g is None) == (r is None)
        if g is None:
            continue
        g, r = (torch.as_tensor(np.array(x)) for x in (g, r))
        assert g.shape == r.shape
        assert f32b.share(g, want, b) <= 1.0
        assert f32b.share(r, want, jb) <= 1.0
        assert f32b.share(g, r, b + jb) <= 1.0


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_version_matches_pallas_masked(name):
    c = _case(name)
    t, fb = c["t"], c["fb"]
    cos_p, sin_p, w_p = jfft.pad_basis(*c["basis"], c["mel"].weights)
    ref = jfft.fused_frame_power_mel(
        jnp.asarray(c["sig"]), t.step_samples, c["offset0"], c["n_windows"],
        jnp.asarray(cos_p), jnp.asarray(sin_p), jnp.asarray(w_p),
        win=t.win_samples, n_bins=t.n_bins, n_mel=fb.n_filters,
        dft=DFTParams(), fbank=fb, interpret=True, passes=6, mode="masked",
        window=c["awin"], emit=c["emit"],
    )
    _assert_close(c, _port(c), ref)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_version_matches_xla_frontend(name):
    c = _case(name)
    t, fb = c["t"], c["fb"]
    cos_m, sin_m = c["basis"]
    if c["awin"] is not None:
        cos_m, sin_m = cos_m * c["awin"][:, None], sin_m * c["awin"][:, None]
    power = power_spectrum_conv(
        jnp.asarray(c["sig"]),
        (jnp.asarray(cos_m, jnp.float32), jnp.asarray(sin_m, jnp.float32)),
        t.step_samples, c["offset0"], c["n_windows"],
    )
    mel = japply_mel(power, jnp.asarray(c["mel"].weights, jnp.float32), fb)
    emit = c["emit"]
    ref = (power if emit[0] else None,
           jlog_power(power, DFTParams()) if emit[1] else None, mel)
    _assert_close(c, _port(c), ref, xla=True)


def test_pure_tone_within_the_model():
    """A Hamming-windowed pure 1234 Hz tone, no added noise: its quiet bins
    and bands read float32 rounding, which no fixed bound between two
    float32 runs holds. The plain version and the Pallas kernel (interpret
    mode, masked mode, 6 passes) each stay within the model's bound of the
    float64 run there, and of each other within the sum of the bounds."""
    sr = GEOMETRIES["hamming_16k"][0]
    c = _case("hamming_16k", rows=lambda n: np.stack(
        [tone(1234.0, n / sr, sr, dither=0.0)[:n],
         tone(1234.0, n / sr, sr, amp=0.05, dither=0.0)[:n]]))
    t, fb = c["t"], c["fb"]
    assert np.abs(np.diff(c["sig"], axis=0)).max() > 0.1
    cos_p, sin_p, w_p = jfft.pad_basis(*c["basis"], c["mel"].weights)
    ref = jfft.fused_frame_power_mel(
        jnp.asarray(c["sig"]), t.step_samples, c["offset0"], c["n_windows"],
        jnp.asarray(cos_p), jnp.asarray(sin_p), jnp.asarray(w_p),
        win=t.win_samples, n_bins=t.n_bins, n_mel=fb.n_filters,
        dft=DFTParams(), fbank=fb, interpret=True, passes=6, mode="masked",
        window=c["awin"], emit=c["emit"],
    )
    got = _port(c)
    # the tone leaves its quietest band 15 nats and more below its loudest
    mel = _f64(c)[2]
    assert float((mel.amax(-1) - mel.amin(-1)).max()) > 15.0
    _assert_close(c, got, ref)


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing():
    c = _case("flagship_16k")
    before = framefft.LAUNCHES
    got = _port(c)
    ref = _port(c, framefft.fused_frame_power_mel_reference)
    assert framefft.LAUNCHES == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_plain_version_float64_matches_rfft():
    c = _case("flagship_16k", batch=1)
    k = {n: torch.as_tensor(c["consts"][n]) for n in ("dft_cos", "dft_sin", "mel_w")}
    t = c["t"]
    sig = torch.as_tensor(c["sig"], dtype=torch.float64)
    power, logp, mel = framefft.fused_frame_power_mel(
        sig, t.step_samples, c["offset0"], c["n_windows"], k["dft_cos"],
        k["dft_sin"], k["mel_w"], n_bins=t.n_bins, n_mel=32,
        dft=tcfg.DFTParams(), fbank=tcfg.FilterBank(),
    )
    assert power.dtype == torch.float64
    starts = c["offset0"] + t.step_samples * np.arange(c["n_windows"])
    idx = starts[:, None] + np.arange(t.win_samples)
    x = np.where((idx >= 0) & (idx < sig.shape[-1]),
                 c["sig"][0].astype(np.float64)[np.clip(idx, 0, sig.shape[-1] - 1)], 0)
    np.testing.assert_allclose(
        power[0].numpy(), np.abs(np.fft.rfft(x, axis=-1)) ** 2,
        rtol=1e-9, atol=1e-9,
    )


def test_pad_basis_matches_jax():
    cos_m, sin_m = jdesign.dft_matrices(400)
    w = jdesign.mel_design(FilterBank(), 400, 16000).weights
    for a, b in zip(framefft.pad_basis(cos_m, sin_m, w),
                    jfft.pad_basis(cos_m, sin_m, w)):
        np.testing.assert_array_equal(a.astype(np.float32), b)


@pytest.mark.parametrize(
    "bad",
    ["prev_smooth", "n_bins", "mel_cols", "dtype_mix", "zero_windows",
     "int32_grid", "rank"],
)
def test_wrapper_refuses_bad_inputs(bad):
    c = _case("flagship_16k")
    k = {n: torch.as_tensor(c["consts"][n], dtype=torch.float32)
         for n in ("dft_cos", "dft_sin", "mel_w")}
    t = c["t"]
    args = dict(
        signals=torch.as_tensor(c["sig"]), step_samples=t.step_samples,
        offset0=c["offset0"], n_windows=c["n_windows"],
        cos_basis=k["dft_cos"], sin_basis=k["dft_sin"], mel_weights=k["mel_w"],
        n_bins=t.n_bins, n_mel=32, dft=tcfg.DFTParams(),
        fbank=tcfg.FilterBank(),
    )
    args.update({
        "prev_smooth": dict(dft=tcfg.DFTParams(prev_smooth=0.5)),
        "n_bins": dict(n_bins=300),
        "mel_cols": dict(n_mel=200),
        "dtype_mix": dict(signals=args["signals"].double()),
        "zero_windows": dict(n_windows=0),
        "int32_grid": dict(offset0=2**31 - 100),
        "rank": dict(signals=args["signals"][0]),
    }[bad])
    with pytest.raises(ValueError):
        framefft.fused_frame_power_mel(**args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("framefft")
    assert not list((tmp_path / "build").glob("*.so"))
