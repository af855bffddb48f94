"""The frontend route (CPU): the route SndEnv records (the kernel on every
uniform grid, at the sample rates and mel bank sizes users run; the window
gather only off the grid), and the geometries whose signal span the kernel
stages in pieces or whose mel sums it keeps in global memory (48 kHz with
64 filters, 96 kHz) through the kernel route's plain version against the
JAX package in float64 (rtol and atol 1e-11, as
tests/test_torch_configs.py holds 22.05 kHz), in SndEnv, SegmentPipeline
and CorpusRunner."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu.pipeline.segments as jseg
import auditory_tpu_torch as at
from auditory_tpu.config import FilterBank as JFilterBank
from auditory_tpu.config import MelParams as JMelParams
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu_torch.pipeline import sndenv as tsndenv
from auditory_tpu_torch.pipeline import segments as tseg
from tests.conftest import default_cfg_2d, tone

CPU = torch.device("cpu")
torch.set_num_threads(1)

F64 = dict(rtol=1e-11, atol=1e-11)
SPECTRAL = ("power_segment", "log_power_segment", "mel_fbank_segment",
            "mfcc_segment")


def _cfg(n_mel=32, **change):
    cfg = default_cfg_2d(**change)
    return dataclasses.replace(cfg, mel=dataclasses.replace(
        cfg.mel, fbank=dataclasses.replace(cfg.mel.fbank, n_filters=n_mel)))


# the sample rates of the port's default WindowParams, and mel banks from
# the default to many filters: every one is a uniform grid the kernel holds
RATES = (8000, 16000, 32000, 44100, 48000, 88200, 96000)


@pytest.mark.parametrize("n_mel", (32, 64, 128))
@pytest.mark.parametrize("sr", RATES)
def test_route_is_the_kernel_on_every_uniform_grid(sr, n_mel):
    cfg = _cfg(n_mel)
    cfg = dataclasses.replace(cfg, mel=dataclasses.replace(
        cfg.mel, fbank=dataclasses.replace(cfg.mel.fbank,
                                           hi_hz=min(8000.0, sr / 2))))
    env = at.SndEnv(cfg, sr, device=CPU)
    n = 3 * sr
    assert env.route(n) == "kernel"
    assert env.route(n, segments=(0, 1)) == "kernel"


@pytest.mark.parametrize("sr,n_mel,change,want", [
    (16000, 32, {}, "kernel"),
    (44100, 32, {}, "kernel"),
    (48000, 64, {}, "kernel"),
    (96000, 32, {}, "kernel"),
    (22050, 32, {}, "gather"),
    (16000, 32, {"dft": at.DFTParams(prev_smooth=0.4)}, "gather"),
], ids=["16k", "44k1", "48k_64", "96k", "22k05_offgrid", "prev_smooth"])
def test_route_recorded(sr, n_mel, change, want):
    env = at.SndEnv(_cfg(n_mel, **change), sr, device=CPU)
    n = 3 * sr
    assert env.route(n) == want


def _count_kernel(monkeypatch):
    calls = []
    real = tsndenv.fused_frame_power_mel
    monkeypatch.setattr(tsndenv, "fused_frame_power_mel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _jax_f64(cfg, sr, sig):
    jenv = JaxSndEnv(cfg, sr, dtype=jnp.float64, spectrum_method="matmul")
    return jenv.process(jenv.pad(sig))


@pytest.mark.parametrize("sr,n_mel", [(48000, 64), (96000, 32)],
                         ids=["48k_64", "96k"])
def test_kernel_route_matches_jax_f64(sr, n_mel, monkeypatch):
    cfg = _cfg(n_mel)
    dur = 0.35
    sig = tone(1234.5, dur, sr) + 0.01 * np.random.default_rng(7).normal(
        size=int(dur * sr))
    jo = _jax_f64(cfg, sr, sig)
    env = at.SndEnv(cfg, sr, dtype=torch.float64, device=CPU)
    calls = _count_kernel(monkeypatch)
    padded = env.pad(sig)
    to = env.process(padded)
    assert env.route(len(padded)) == "kernel" and len(calls) == 1
    for key in SPECTRAL:
        np.testing.assert_allclose(getattr(to, key).numpy(),
                                   np.asarray(getattr(jo, key)), err_msg=key, **F64)
    np.testing.assert_array_equal(to.step_valid.numpy(), np.asarray(jo.step_valid))
    assert to.mel_fbank_segment.shape[0] >= 3


@pytest.mark.parametrize("sr,n_mel", [(48000, 64), (96000, 32)],
                         ids=["48k_64", "96k"])
def test_segment_pipeline_matches_jax_f64(sr, n_mel, monkeypatch):
    mel = at.MelParams(fbank=at.FilterBank(n_filters=n_mel))
    jmel = JMelParams(fbank=JFilterBank(n_filters=n_mel))
    sig = tone(900.0, 0.5, sr) + 0.01 * np.random.default_rng(5).normal(
        size=int(0.5 * sr))
    jp = jseg.SegmentPipeline(sr, mel=jmel, dtype=jnp.float64,
                              spectrum_method="matmul")
    tp = tseg.SegmentPipeline(sr, mel=mel, dtype=torch.float64, device=CPU)
    calls = []
    real = tseg.fused_frame_power_mel
    monkeypatch.setattr(tseg, "fused_frame_power_mel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jout, tout = jp.process(sig, 120.0, 330.0), tp.process(sig, 120.0, 330.0)
    assert len(calls) == 1
    for key in SPECTRAL:
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   err_msg=key, **F64)
    np.testing.assert_array_equal(tout["step_valid"].numpy(),
                                  np.asarray(jout["step_valid"]))


def test_corpus_at_48k_with_64_filters(tmp_path):
    """CorpusRunner ships the deduped global-grid mel at 48 kHz with 64
    filters: each file's features equal SndEnv.process of the file."""
    from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav

    sr, cfg = 48000, _cfg(64)
    paths = []
    for i, dur in enumerate((0.4, 0.55)):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), float_to_wave(tone(500.0 + 400 * i, dur, sr), sr))
        paths.append(str(p))
    runner = at.CorpusRunner(cfg, sr, batch_size=2, device=CPU,
                             transfer="float32")
    assert runner._dedup_mel
    runner.run(paths, str(tmp_path / "out"))
    env = at.SndEnv(cfg, sr, device=CPU)
    for i, p in enumerate(paths):
        got = np.load(tmp_path / "out" / f"u{i}.npz")
        sig = env.pad(load_wav(p).sound_to_tensor(np.float32))
        want = env.process(sig)
        assert env.route(len(sig)) == "kernel"
        np.testing.assert_allclose(got["mel_fbank_segment"],
                                   want.mel_fbank_segment.numpy(),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["gabor_kwta"], want.gabor_kwta.numpy(),
                                   rtol=0, atol=1e-4)
