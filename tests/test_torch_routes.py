"""The frontend route (CPU): the route SndEnv records (the kernel on every
uniform grid, at the sample rates and mel bank sizes users run; the window
gather only off the grid), the kernel's block layout at each of them
(``ops/framefft.py::plan_layout``, whose byte counts chip_smoke.py holds
to the library's on the card), and the geometries
whose signal span the kernel stages in pieces (44.1 kHz with 80 filters,
48 kHz with 64 and 128, 88.2 kHz with 64, 96 kHz) through the kernel
route's plain version against the JAX package in float64 (rtol and atol
1e-11, as tests/test_torch_configs.py holds 22.05 kHz), in SndEnv,
SegmentPipeline and CorpusRunner."""

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
from auditory_tpu_torch.dsp import design
from auditory_tpu_torch.ops import framefft
from auditory_tpu_torch.pipeline import sndenv as tsndenv
from auditory_tpu_torch.pipeline import segments as tseg
from auditory_tpu_torch.pipeline.batch import bucket_length
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


# the block layout of every rate at 3 s rows, for a large batch:
# (warpgroups, basis stages, piece, piece buffers). Two warpgroups before
# one; with two the whole span before pieces, with one the deepest ring
# first: at 32 kHz and above the span is staged in pieces. The mel
# epilogue's shared memory (carry slots, the staged band table) is the same
# at every mel bank, so every bank takes its rate's layout: before the
# banded epilogue, 16 kHz with 80 filters ran in pieces, 8 and 16 kHz with
# 128 and 48 kHz with 128 with one warpgroup, and 256 filters kept the mel
# sums in global memory
LAYOUT_FILTERS = (32, 40, 64, 80, 128, 256)
WHOLE, PIECES = (2, 6, 0, 0), (2, 6, 64, 3)
LAYOUTS = {8000: WHOLE, 16000: WHOLE, 32000: PIECES, 44100: PIECES,
           48000: PIECES, 88200: PIECES, 96000: PIECES}


def _grid_windows(sr):
    t = at.WindowParams().derive(sr)
    n = bucket_length(3 * sr, t)
    return t, (t.seg_cnt(n) - 1) * (t.stride_samples // t.step_samples) + t.segment_steps


@pytest.mark.parametrize("n_mel", LAYOUT_FILTERS)
@pytest.mark.parametrize("sr", RATES)
def test_layout_plan(sr, n_mel):
    t, nw = _grid_windows(sr)
    geom = (t.step_samples, t.win_samples, nw)
    lay = framefft.plan_layout(*geom)
    assert tuple(lay[:4]) == LAYOUTS[sr]
    assert lay.bytes == framefft.shared_bytes(*geom, *lay[:4])
    assert lay.bytes <= framefft._MAX_SHARED_BYTES
    # the first fit in the picker's order
    fits = list(framefft.layouts(*geom))
    assert fits[0] == lay
    assert all(x.bytes <= framefft._MAX_SHARED_BYTES for x in fits)
    assert 4 <= lay.ring <= 6 and (not lay.piece or 3 <= lay.pbufs <= 4)
    # the layout's fixed mel share holds this bank's band table: each pass's
    # entries and weights are staged whole and every filter open across a
    # pass boundary has a shared carry slot
    fb = at.FilterBank(n_filters=n_mel, hi_hz=min(8000.0, sr / 2))
    w = torch.as_tensor(design.mel_design(fb, t.win_samples, sr).weights.T)
    table = framefft.band_table(w, t.n_bins, n_mel)
    n_pass = -(-t.n_bins // framefft.BINS_PER_PASS)
    e_stride = max(n_mel + 1, framefft.STAGED_ENTRIES)
    ent = table[:n_pass * e_stride * 4].reshape(n_pass, e_stride, 4)
    for q in range(n_pass):
        n_ent, _, nz, _ = ent[q, 0].tolist()
        assert n_ent < framefft.STAGED_ENTRIES and nz <= framefft.STAGED_WEIGHTS
        carried_out = ent[q, 1:1 + n_ent, 1] & (1 << 17) == 0
        assert int(carried_out.sum()) <= framefft.CARRY_SLOTS


# the flagship's 32 filters took 23.5 KB of shared memory for the mel sums
# and weight rows before the banded epilogue (228,000 bytes a block; the
# serving poll fitted 5 basis stages); the banded epilogue's share is
# 10,752 bytes at two warpgroups
def test_flagship_and_serving_keep_their_layouts():
    t, nw = _grid_windows(16000)
    flagship = framefft.plan_layout(t.step_samples, t.win_samples, nw)
    serving = framefft.plan_layout(t.step_samples, t.win_samples, t.segment_steps)
    assert tuple(flagship) == (2, 6, 0, 0, 215200)
    assert tuple(serving[:4]) == (2, 6, 0, 0)
    assert flagship.kind == serving.kind == "whole span"
    pieced = {sr for sr in RATES if LAYOUTS[sr][2]}
    assert pieced == {sr for sr in RATES if sr >= 32000}
    for rows in (1, 64, 512, 4096):
        assert framefft.plan_layout(t.step_samples, t.win_samples, nw, rows,
                                    132) == flagship
        assert framefft.plan_layout(t.step_samples, t.win_samples,
                                    t.segment_steps, rows, 132) == serving


# a small batch: where two warpgroups would stage the span in pieces, the
# first layout of one warpgroup takes their place when its blocks fill
# fewer waves of 132 SMs than theirs times 1.6 (64 rows x 3 s: 150 blocks
# of two warpgroups, 2 waves, against 300 of one, 3 waves; at 32 kHz that
# is the whole span); a corpus batch keeps two. Every mel bank of a rate
# takes the same layouts (before the banded epilogue, 256 filters kept two
# warpgroups at 64 rows)
@pytest.mark.parametrize("n_mel", LAYOUT_FILTERS)
@pytest.mark.parametrize("sr", RATES)
def test_layout_plan_by_batch(sr, n_mel):
    t, nw = _grid_windows(sr)
    geom = (t.step_samples, t.win_samples, nw)
    large = framefft.plan_layout(*geom)
    assert framefft.plan_layout(*geom, 512, 132) == large
    small = framefft.plan_layout(*geom, 64, 132)
    fits = framefft.layouts(*geom)
    if large.consumers == 2 and large.piece:
        assert small == next(lay for lay in fits if lay.consumers == 1)
        assert small.ring == 6
        assert small.piece == (0 if sr == 32000 else 64)
    else:
        assert small == large


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


PIECE_GEOMETRIES = [(48000, 64), (96000, 32), (44100, 80), (48000, 128), (88200, 64)]
PIECE_IDS = ["48k_64", "96k", "44k1_80", "48k_128", "88k2_64"]


@pytest.mark.parametrize("sr,n_mel", PIECE_GEOMETRIES, ids=PIECE_IDS)
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


@pytest.mark.parametrize("sr,n_mel", PIECE_GEOMETRIES, ids=PIECE_IDS)
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
    filters: each file's features and SndEnv.process of the file both
    within the float32 error model's bound of the float64 run."""
    from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav
    from tests.test_torch_sndenv import hold_f32

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
        keys = ("mel_fbank_segment", "gabor_kwta")
        hold_f32({"runner": {k: got[k][None] for k in keys},
                  "env": {k: getattr(want, k)[None] for k in keys}},
                 cfg, sr, sig[None], np.array([len(sig)]))
