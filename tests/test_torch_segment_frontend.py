"""``SndEnv(segment_frontend=)`` in the port against the JAX package (CPU).

Off the uniform window grid (22.05 kHz: stride 2205, step 221; or
prev_smooth > 0) ``'per_segment'`` makes each segment's span one row and
runs the fused kernel's plain version over every row's windows from offset
0 (dsp/dft.py::segment_spans); ``'auto'`` keeps the window gather there and
``'gather'`` forces it on every grid. These tests pin:

- the routing: the six cases of tests/test_per_segment_frontend.py on the
  port's ``SndEnv.route``;
- float64: the port's ``per_segment`` against JAX's ``per_segment`` (its
  frames, conv and windowed formulations) within JAX's own tolerance on
  power, log power and mel, every other field at the port's float64
  tolerance, and against the port's gather;
- float32: the port's ``per_segment`` at kernel_passes 6 and 3 and JAX's
  ``per_segment`` within the float32 error model's bound of the port's
  float64 run (tests/test_torch_sndenv.py::hold_f32);
- ``segment_spans`` against direct slicing and JAX's; the forced gather
  on the 16 kHz grid against JAX's, ``mel_fbank_global`` included;
  gradients through the per-segment route against the gather's; and the
  argument carried into ``iter_device_features`` and ``BatchedSndEnv``'s
  per-device copies.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.dsp.dft import segment_spans as jax_segment_spans
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu_torch.dsp.dft import segment_spans
from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav
from auditory_tpu_torch.utils import f32_bounds as fb
from tests.conftest import default_cfg_2d, tone
from tests.test_torch_sndenv import hold_f32, jax_order

CPU = torch.device("cpu")

torch.set_num_threads(1)

OUTS = ("power_segment", "log_power_segment", "mel_fbank_segment",
        "step_valid")
SPECTRAL = OUTS[:3]
# JAX's tolerance between its per_segment and gather formulations
# (tests/test_per_segment_frontend.py), and the port's float64 tolerance
# against JAX for the stages after the frontend (tests/test_torch_routes.py)
JAX_F64 = dict(rtol=1e-11, atol=1e-13)
F64 = dict(rtol=1e-11, atol=1e-11)
# (rate, prev_smooth): no shared window grid at 22.05 kHz, and smoothing's
# per-segment recurrence on the 16 kHz grid
OFF_GRID = [(22050, 0.0), (22050, 0.3), (16000, 0.5)]
OFF_GRID_IDS = ["22k05", "22k05_smooth", "16k_smooth"]


def _cfg(prev_smooth=0.0, base=None):
    cfg = default_cfg_2d() if base is None else base
    return dataclasses.replace(
        cfg, dft=dataclasses.replace(cfg.dft, prev_smooth=prev_smooth))


def _signal(sr, dur=0.35):
    """JAX's test signal: a 1234.5 Hz tone with 0.01 noise, 3+ segments."""
    return tone(1234.5, dur, sr) + 0.01 * np.random.default_rng(7).normal(
        size=int(dur * sr))


def _batch(sr, cfg):
    """B=2 ragged batch: the tone row and a noise row 0.09 s shorter, whose
    last steps overrun its true length (the per-segment route reads past it,
    the gather zeroes those windows; both mask the steps)."""
    env = at.SndEnv(cfg, sr, device=CPU)
    sig = env.pad(_signal(sr))
    n = sig.shape[0]
    rows = np.stack([sig, 0.1 * np.random.default_rng(4).standard_normal(n)])
    return rows.astype(np.float32), np.array([n, n - int(0.09 * sr)], dtype=np.int32)


def _fields(out):
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
            if getattr(out, f.name) is not None}


# ---------------------------------------------------------------------------
# routing (tests/test_per_segment_frontend.py on the port's route)
# ---------------------------------------------------------------------------


def test_routing_22050_auto_is_gather():
    env = at.SndEnv(at.SndEnvConfig(), 22050, outputs=OUTS, device=CPU)
    t = env.timing
    assert t.stride_samples % t.step_samples != 0  # 2205 % 221
    assert env.route(3 * 22050) == "gather"


def test_routing_22050_opt_in_per_segment():
    env = at.SndEnv(at.SndEnvConfig(), 22050, outputs=OUTS, device=CPU,
                    segment_frontend="per_segment")
    assert env.route(3 * 22050) == "per_segment"
    assert env.route(3 * 22050, segments=(2, 5)) == "per_segment"


def test_routing_commensurate_stays_kernel():
    """'per_segment' never takes a uniform grid: the kernel runs there once
    per distinct window."""
    for sf in ("auto", "per_segment"):
        env = at.SndEnv(at.SndEnvConfig(), 16000, outputs=OUTS, device=CPU,
                        segment_frontend=sf)
        assert env.route(16000) == "kernel", sf


def test_routing_forced_gather_on_uniform_grid():
    env = at.SndEnv(at.SndEnvConfig(), 16000, outputs=OUTS, device=CPU,
                    segment_frontend="gather")
    assert env.route(16000) == "gather"
    assert env.global_grid(16000)[0] is not None  # the grid is still uniform


def test_bad_segment_frontend_refused():
    with pytest.raises(ValueError, match="segment_frontend"):
        at.SndEnv(at.SndEnvConfig(), 16000, outputs=OUTS, device=CPU,
                  segment_frontend="nope")


def test_routing_prev_smooth_auto_is_gather():
    cfg = _cfg(0.5, at.SndEnvConfig())
    env = at.SndEnv(cfg, 16000, outputs=OUTS, device=CPU)
    assert env.route(16000) == "gather"
    env2 = at.SndEnv(cfg, 16000, outputs=OUTS, device=CPU,
                     segment_frontend="per_segment")
    assert env2.route(16000) == "per_segment"


# ---------------------------------------------------------------------------
# float64 against JAX's per_segment and the port's gather
# ---------------------------------------------------------------------------


def _hold_kwta(got, want, env64, raw):
    """Two float32 settles of float64 gabor_raw within the sum of their
    bounds around the float64 settle of ``raw``."""
    b = fb.settle_bound(env64.cfg.kwta, raw)
    ref = fb.settle_reference(env64, raw, batch_ndim=1)
    for x in (got, want):
        assert fb.share(torch.as_tensor(np.array(x)).double(), ref,
                        torch.full_like(ref, b)) <= 1.0


@pytest.mark.parametrize("method", ["frames", "conv", "windowed"])
@pytest.mark.parametrize("sr,prev_smooth", OFF_GRID, ids=OFF_GRID_IDS)
def test_per_segment_matches_jax_per_segment_f64(sr, prev_smooth, method):
    cfg = _cfg(prev_smooth)
    sig = _signal(sr)
    jenv = JaxSndEnv(cfg, sr, dtype=jnp.float64, spectrum_method=method,
                     segment_frontend="per_segment")
    jo = jenv.process(jenv.pad(sig))
    assert jenv._frontend_structure == "per_segment"
    env = at.SndEnv(cfg, sr, dtype=torch.float64, device=CPU,
                    segment_frontend="per_segment")
    padded = env.pad(sig)
    assert env.route(len(padded)) == "per_segment"
    to = _fields(env.process(padded))
    assert set(to) == set(_fields(jo)) and "mel_fbank_global" not in to
    for key, got in to.items():
        want = np.asarray(getattr(jo, key))
        assert got.shape == want.shape, key
        if key == "step_valid":
            np.testing.assert_array_equal(got.numpy(), want)
        elif key == "gabor_kwta":
            _hold_kwta(got, want, env, to["gabor_raw"])
        else:
            np.testing.assert_allclose(got.numpy(), want, err_msg=key,
                                       **(JAX_F64 if key in SPECTRAL else F64))


@pytest.mark.parametrize("sr,prev_smooth", OFF_GRID, ids=OFF_GRID_IDS)
def test_per_segment_matches_gather_f64(sr, prev_smooth):
    cfg = _cfg(prev_smooth)
    signals, lengths = _batch(sr, cfg)
    sig, lens = torch.as_tensor(signals, dtype=torch.float64), torch.as_tensor(lengths)
    out = {}
    for sf in ("per_segment", "auto"):
        env = at.SndEnv(cfg, sr, dtype=torch.float64, device=CPU, segment_frontend=sf)
        out[sf] = env(sig, lens)
    (a, va), (b, vb) = out["per_segment"], out["auto"]
    assert torch.equal(va, vb)
    fa, fb_ = _fields(a), _fields(b)
    assert set(fa) == set(fb_)
    for key in fa:
        torch.testing.assert_close(fa[key], fb_[key], rtol=JAX_F64["rtol"],
                                   atol=JAX_F64["atol"], msg=key)


# ---------------------------------------------------------------------------
# float32: the kernel's plain version at its grades, and JAX's per_segment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr,prev_smooth", OFF_GRID, ids=OFF_GRID_IDS)
def test_per_segment_f32_within_the_model(sr, prev_smooth):
    cfg = _cfg(prev_smooth)
    signals, lengths = _batch(sr, cfg)
    sig, lens = torch.as_tensor(signals), torch.as_tensor(lengths)
    jenv = JaxSndEnv(cfg, sr, dtype=jnp.float32, segment_frontend="per_segment")
    jo, jv = jenv.process_fn(signals.shape[-1])(jnp.asarray(signals),
                                                 jnp.asarray(lengths))
    assert jenv._frontend_structure == "per_segment"
    runs = {}
    for passes in (6, 3):
        env = at.SndEnv(cfg, sr, device=CPU, segment_frontend="per_segment",
                        kernel_passes=passes)
        runs[passes], valid = env(sig, lens)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    hold_f32({"port": runs[6], "jax": jo}, cfg, sr, signals, lengths,
             segment_frontend="per_segment", any_order=jax_order(jenv))
    hold_f32({"port3": runs[3]}, cfg, sr, signals, lengths, passes=3,
             segment_frontend="per_segment")


# ---------------------------------------------------------------------------
# segment_spans
# ---------------------------------------------------------------------------

SPAN_CASES = [
    (100, 140, -30, 5),   # left zero fill and a right overrun
    (100, 95, 0, 5),      # span < stride
    (73, 211, -5, 6),     # span ~3x stride, odd sizes
    (120, 120, 40, 4),    # positive offset
]


@pytest.mark.parametrize("stride,span,offset0,nseg", SPAN_CASES)
def test_segment_spans_matches_slicing_and_jax(stride, span, offset0, nseg):
    sig = np.random.default_rng(0).normal(size=(3, 500))
    got = segment_spans(torch.as_tensor(sig), stride, span, offset0, nseg).numpy()
    want = np.zeros((3, nseg, span))
    for g in range(nseg):
        for i in range(span):
            j = offset0 + g * stride + i
            if 0 <= j < sig.shape[1]:
                want[:, g, i] = sig[:, j]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_segment_spans(
        jnp.asarray(sig), stride, span, offset0, nseg)))


# ---------------------------------------------------------------------------
# the forced gather on the uniform grid
# ---------------------------------------------------------------------------


def test_forced_gather_matches_jax_gather_f64():
    cfg = default_cfg_2d()
    signals, lengths = _batch(16000, cfg)
    signals = signals.astype(np.float64)
    outs = at.SndEnv.ALL_OUTPUTS
    jenv = JaxSndEnv(cfg, 16000, dtype=jnp.float64, spectrum_method="matmul",
                     outputs=outs, segment_frontend="gather")
    jo, jv = jenv.process_fn(signals.shape[-1])(jnp.asarray(signals),
                                                 jnp.asarray(lengths))
    assert jenv._frontend_structure == "gather"
    env = at.SndEnv(cfg, 16000, dtype=torch.float64, outputs=outs, device=CPU,
                    segment_frontend="gather")
    assert env.route(signals.shape[-1]) == "gather"
    to, tv = env(torch.as_tensor(signals), torch.as_tensor(lengths))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    got = _fields(to)
    assert got["mel_fbank_global"].shape[1] > got["mel_fbank_segment"].shape[1]
    assert set(got) == set(outs)
    for key, x in got.items():
        want = np.asarray(getattr(jo, key))
        assert x.shape == want.shape, key
        if key == "step_valid":
            np.testing.assert_array_equal(x.numpy(), want)
        elif key == "gabor_kwta":
            _hold_kwta(x.flatten(0, 1), want.reshape((-1,) + want.shape[2:]), env,
                       got["gabor_raw"].flatten(0, 1))
        else:
            np.testing.assert_allclose(x.numpy(), want, err_msg=key,
                                       **(JAX_F64 if key in SPECTRAL else F64))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr,prev_smooth", [(22050, 0.0), (16000, 0.4)],
                         ids=["22k05", "16k_smooth"])
def test_per_segment_gradients_match_gather_f64(sr, prev_smooth):
    """w.r.t. the signal and a gabor nn.Parameter: through the kernel's
    autograd Function and the span copy, against the gather's autograd."""
    cfg = _cfg(prev_smooth)
    signals, lengths = _batch(sr, cfg)
    outs = ("power_segment", "log_power_segment", "mel_fbank_segment",
            "mfcc_segment", "gabor_raw")
    grads = {}
    for sf in ("per_segment", "auto"):
        env = at.SndEnv(cfg, sr, dtype=torch.float64, outputs=outs, device=CPU,
                        segment_frontend=sf)
        env.gabor = torch.nn.Parameter(env.gabor.clone())
        sig = torch.tensor(signals, dtype=torch.float64, requires_grad=True)
        out, _ = env(sig, torch.as_tensor(lengths))
        loss = sum((getattr(out, k) ** 2).sum() for k in outs[1:])
        (loss + 1e-3 * out.power_segment.sum()).backward()
        grads[sf] = (sig.grad, env.gabor.grad)
    for a, b in zip(grads["per_segment"], grads["auto"]):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the argument carried through
# ---------------------------------------------------------------------------


def test_iter_device_features_and_copies_keep_segment_frontend(tmp_path, monkeypatch):
    sr = 22050
    cfg = default_cfg_2d()
    paths = []
    for i, f in enumerate((700.0, 1500.0, 2500.0)):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, float_to_wave(tone(f, 0.3 + 0.05 * i, sr), sr))
        paths.append(p)
    runs = []
    real = at.SndEnv._per_segment
    monkeypatch.setattr(at.SndEnv, "_per_segment",
                        lambda self, *a: runs.append(a[2]) or real(self, *a))
    runner = at.CorpusRunner(cfg, sr, batch_size=4, dtype=torch.float64, device=CPU)
    runner.env.segment_frontend = "per_segment"
    gather = at.SndEnv(cfg, sr, dtype=torch.float64, device=CPU)
    seen = 0
    for batch_paths, out, _, n_segs in runner.iter_device_features(paths):
        assert runner._batched_dev.env.segment_frontend == "per_segment"
        for j, p in enumerate(batch_paths):
            want = gather.process(gather.pad(load_wav(p).sound_to_tensor(np.float64)))
            torch.testing.assert_close(out.mel_fbank_segment[j, :n_segs[j]],
                                       want.mel_fbank_segment[:n_segs[j]], **F64)
            seen += 1
    assert seen == len(paths) and runs
    b = at.BatchedSndEnv(at.SndEnv(cfg, sr, device=CPU, segment_frontend="per_segment"))
    copy = b._env_on(torch.device("meta"))
    assert copy is not b.env and copy.segment_frontend == "per_segment"
    assert copy.route(3 * sr) == "per_segment"
