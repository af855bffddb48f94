"""The PyTorch port's SndEnv against the JAX SndEnv on the same inputs (CPU),
and its float64 path against the frozen goldens."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu_torch.convert import constants_from_numpy
from tests.conftest import default_cfg_2d, tone

torch.set_num_threads(1)

SR = 16000

# f32 bounds of tests/test_pallas.py:34-56 (two f32 frontends of different
# summation order); kWTA: tests/test_batch_sharding.py:83
BOUNDS = {
    "power_segment": dict(rtol=1e-5, atol=1e-4),
    "log_power_segment": dict(rtol=1e-5, atol=1e-5),
    "mel_fbank_segment": dict(rtol=1e-5, atol=1e-4),
    "mel_fbank_global": dict(rtol=1e-5, atol=1e-4),
    "energy": dict(rtol=1e-4, atol=2e-3),
    "mfcc_segment": dict(rtol=1e-4, atol=2e-3),
    "mfcc_deltas": dict(rtol=1e-4, atol=2e-3),
    "mfcc_delta_deltas": dict(rtol=1e-4, atol=2e-3),
    "gabor_raw": dict(rtol=1e-4, atol=1e-3),
    "gabor_kwta": dict(rtol=0, atol=1e-4),
}

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDENS = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))


def _batch():
    """B=3 ragged batch: a 4-segment tone, and rows of 2500 and 900 true
    samples with one segment each (the 900-sample row only by SegCnt's Go
    truncating division)."""
    rng = np.random.default_rng(1)
    sig = at.SndEnv(default_cfg_2d(), SR).pad(tone(1234.0, 0.4, SR))
    n = sig.shape[0]
    rows = np.stack([
        sig,
        tone(440.0, n / SR, SR)[:n],
        0.1 * rng.standard_normal(n),
    ]).astype(np.float32)
    return rows, np.array([n, 2500, 900], dtype=np.int32)


def _compare(jax_out, torch_out, fields=None):
    for f in dataclasses.fields(jax_out):
        if fields is not None and f.name not in fields:
            continue
        a, b = getattr(jax_out, f.name), getattr(torch_out, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        if f.name == "step_valid":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, err_msg=f.name, **BOUNDS[f.name])


def _run_both(cfg, outputs=None, channels=1, feature_stats=False,
              signals=None, lengths=None):
    if signals is None:
        signals, lengths = _batch()
    kw = dict(outputs=outputs, channels=channels, feature_stats=feature_stats)
    jenv = JaxSndEnv(cfg, SR, dtype=jnp.float32, **kw)
    tenv = at.SndEnv(cfg, SR, dtype=torch.float32, **kw)
    jres = jenv.process_fn(signals.shape[-1])(
        jnp.asarray(signals), jnp.asarray(lengths)
    )
    tres = at.BatchedSndEnv(tenv).process(signals, lengths)
    return jres, tres


def test_slice_matches_jax_f32_flagship():
    (jo, jv, js), (to, tv, ts) = _run_both(default_cfg_2d(), feature_stats=True)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # row 2 (900 samples) has 1 segment only by truncating division
    assert tv.numpy().sum(axis=1).tolist() == [4, 1, 1]
    _compare(jo, to)
    assert float(js["count"]) == float(ts["count"])
    for k in ("sum", "sumsq"):
        np.testing.assert_allclose(
            ts[k].numpy(), np.asarray(js[k]), rtol=1e-5, atol=1e-3
        )


def test_signal_shorter_than_one_segment():
    cfg = default_cfg_2d()
    sig = tone(900.0, 0.05, SR).astype(np.float32)  # 800 samples
    jo = JaxSndEnv(cfg, SR, dtype=jnp.float32).process(sig)
    to = at.SndEnv(cfg, SR).process(sig)
    assert to.mel_fbank_segment.shape[0] == 1
    _compare(jo, to)


def test_channels_2():
    signals, _ = _batch()
    lengths = np.array([signals.shape[-1], 4000, 3000], dtype=np.int32)
    (jo, jv), (to, tv) = _run_both(
        default_cfg_2d(), channels=2, signals=signals, lengths=lengths
    )
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    _compare(jo, to)


@pytest.mark.parametrize(
    "outputs",
    [
        ("mel_fbank_segment", "gabor_raw", "step_valid"),
        ("mfcc_segment", "mel_fbank_global"),
        ("log_power_segment", "gabor_kwta"),
    ],
    ids=["melgabor", "mfcc_global", "logp_kwta"],
)
def test_outputs_selection(outputs):
    (jo, jv), (to, tv) = _run_both(default_cfg_2d(), outputs=outputs)
    for f in at.SndEnv.ALL_OUTPUTS:
        assert (getattr(to, f) is not None) == (f in outputs), f
    _compare(jo, to)


def test_constants_carried_across_perturbed_gabor():
    cfg = default_cfg_2d()
    jenv = JaxSndEnv(cfg, SR, dtype=jnp.float32)
    tenv = at.SndEnv(cfg, SR)
    rng = np.random.default_rng(7)
    bank = np.asarray(jenv.gabor_bank) + 0.05 * rng.standard_normal(
        jenv.gabor_bank.shape
    )
    jenv.gabor_bank = bank
    cos_m, sin_m = jenv.dft_basis  # rectangular window: the plain basis
    tenv.load_constants(constants_from_numpy(
        np.asarray(jenv.mel_des.weights), np.asarray(jenv.dct_mat), bank,
        np.asarray(cos_m), np.asarray(sin_m), jenv.analysis_win,
    ))
    signals, lengths = _batch()
    jo, jv = jenv.process_fn(signals.shape[-1])(
        jnp.asarray(signals), jnp.asarray(lengths)
    )
    to, tv = tenv(torch.as_tensor(signals), torch.as_tensor(lengths))
    _compare(jo, to)
    default = at.SndEnv(cfg, SR)(
        torch.as_tensor(signals), torch.as_tensor(lengths)
    )[0]
    assert not torch.allclose(default.gabor_raw, to.gabor_raw)


def test_load_constants_rejects_wrong_shape():
    env = at.SndEnv(default_cfg_2d(), SR)
    with pytest.raises(ValueError, match="dct"):
        env.load_constants({"dct": np.eye(5)})


@pytest.mark.parametrize(
    "path", GOLDENS, ids=[os.path.basename(p) for p in GOLDENS]
)
def test_f64_port_matches_golden(path):
    g = np.load(path)
    sr = int(g["sample_rate"])
    channels = int(g["channels"]) if "channels" in g.files else 1
    wfn = str(g["window_fn"]) if "window_fn" in g.files else ""
    cfg = default_cfg_2d()
    if wfn:
        cfg = dataclasses.replace(
            cfg, dft=dataclasses.replace(cfg.dft, window_fn=wfn)
        )
    env = at.SndEnv(cfg, sr, dtype=torch.float64, channels=channels)
    out = env.process(g["signal"])
    assert out.power_segment.shape[0] == int(g["n_segments"])
    for key in (
        "power_segment", "log_power_segment", "mel_fbank_segment", "energy",
        "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas",
    ):
        np.testing.assert_allclose(
            getattr(out, key).numpy(), g[key], atol=1e-5, rtol=1e-7,
            err_msg=f"{os.path.basename(path)}:{key}",
        )
    np.testing.assert_allclose(
        out.gabor_raw.numpy(), g["gabor_raw"], atol=1e-4, rtol=1e-5
    )


def test_goldens_all_present():
    assert len(GOLDENS) == 13


@pytest.mark.parametrize(
    "change",
    [
        dict(gbor_out_pools_x=4, gbor_out_pools_y=4),
        dict(dft=at.DFTParams(prev_smooth=0.5)),
        dict(params=at.WindowParams(stride_ms=105.0)),
    ],
    ids=["layout_4d", "prev_smooth", "off_grid"],
)
def test_unported_paths_raise(change):
    cfg = dataclasses.replace(default_cfg_2d(), **change)
    with pytest.raises(NotImplementedError):
        at.SndEnv(cfg, SR)


def test_cuda_device_refused_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        at.SndEnv(default_cfg_2d(), SR, device="cuda")


def test_precision_tier_sets_and_restores_tf32_flags():
    from auditory_tpu_torch.pipeline.sndenv import precision_tier

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    before = flags()
    with precision_tier("highest"):
        assert flags() == (False, False)
    assert flags() == before
    with precision_tier("default"):
        assert flags() == (True, True)
    assert flags() == before
    with pytest.raises(ValueError):
        at.SndEnv(default_cfg_2d(), SR, matmul_precision="bf16")


def test_design_constants_match_jax_env():
    jenv = JaxSndEnv(default_cfg_2d(), 44100, dtype=jnp.float32)
    tenv = at.SndEnv(default_cfg_2d(), 44100)
    np.testing.assert_array_equal(tenv.mel_des.weights, jenv.mel_des.weights)
    np.testing.assert_array_equal(tenv.gabor_bank, jenv.gabor_bank)
    np.testing.assert_array_equal(tenv.dct_mat, jenv.dct_mat)
    assert tenv.gabor_output_shape() == jenv.gabor_output_shape()
    assert tenv.seg_cnt(12345) == jenv.seg_cnt(12345)
    np.testing.assert_array_equal(tenv.pad(np.ones(5000)), jenv.pad(np.ones(5000)))
    w = tenv.timing.win_samples
    np.testing.assert_array_equal(
        tenv.dft_cos[:, : w // 2 + 1].numpy(),
        np.asarray(jenv.dft_basis[0], dtype=np.float32),
    )
