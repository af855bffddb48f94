"""The port's configurations beyond the flagship against the JAX package
(CPU): the 4-D pooled layout with neighbor inhibition, the off-grid gather
frontend (stride 95 ms, 22.05 kHz, a Hamming window) and prev_smooth > 0.

float32 runs, the port's and JAX SndEnv's, are held to the port's float64
run within the float32 error model's bound
(auditory_tpu_torch/utils/f32_bounds.py), and to each other within the sum
of their bounds (tests/test_torch_sndenv.py::hold_f32); float64 runs against the Go-semantics oracle
``SndEnvRef`` at the tolerances of tests/test_pipeline_parity.py, and at
22.05 kHz against JAX's own float64 gather path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.nn.neigh_inhib import inhib4 as jinhib4
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu.refemu.goref import SndEnvRef
from auditory_tpu_torch.nn.neigh_inhib import inhib4
from tests.conftest import default_cfg_2d, tone
from tests.test_torch_sndenv import hold_f32, jax_order

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000
ORACLE_TOL = 1e-5  # tests/test_pipeline_parity.py


def _cfg(**change):
    base = default_cfg_2d()
    for key in ("dft", "params", "neigh_inhib"):
        if isinstance(change.get(key), dict):
            change[key] = dataclasses.replace(getattr(base, key), **change[key])
    return dataclasses.replace(base, **change)


def _4d(inhib: bool, pool: bool):
    return _cfg(gbor_out_pools_y=8, gbor_out_pools_x=2, kwta_pool=pool,
                neigh_inhib=dict(on=inhib))


def _batch(sr, cfg):
    """B=2 ragged batch: a tone mix of 3+ segments and a shorter noise
    row."""
    env = at.SndEnv(cfg, sr, device=CPU)
    sig = env.pad(tone(1234.0, 0.4, sr) + tone(310.0, 0.4, sr, 0.2))
    n = sig.shape[0]
    rng = np.random.default_rng(4)
    rows = np.stack([sig, 0.1 * rng.standard_normal(n)]).astype(np.float32)
    return rows, np.array([n, n - int(0.09 * sr)], dtype=np.int32)


def _compare_jax_f32(cfg, sr, outputs=None, spectrum_method=None):
    signals, lengths = _batch(sr, cfg)
    jenv = JaxSndEnv(cfg, sr, dtype=jnp.float32, outputs=outputs,
                     spectrum_method=spectrum_method)
    jo, jv = jenv.process_fn(signals.shape[-1])(
        jnp.asarray(signals), jnp.asarray(lengths)
    )
    to, tv = at.SndEnv(cfg, sr, outputs=outputs, device=CPU)(
        torch.as_tensor(signals), torch.as_tensor(lengths)
    )
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert tv.numpy().sum() >= 4
    hold_f32({"jax": jo, "port": to}, cfg, sr, signals, lengths,
             any_order=jax_order(jenv))
    return to


@pytest.mark.parametrize(
    "inhib,pool",
    [(True, True), (False, True), (True, False), (False, False)],
    ids=["inhib-pool", "noinhib-pool", "inhib-layer", "noinhib-layer"],
)
def test_4d_layout_matches_jax_f32(inhib, pool):
    to = _compare_jax_f32(
        _4d(inhib, pool), SR,
        outputs=("mel_fbank_segment", "gabor_raw", "gabor_kwta", "step_valid"),
    )
    assert tuple(to.gabor_kwta.shape[2:]) == (8, 2, 2, 8)
    assert float(to.gabor_kwta.abs().max()) > 0.05


def test_4d_inhibition_changes_the_settle():
    out = {}
    for inhib in (True, False):
        signals, lengths = _batch(SR, _4d(inhib, True))
        out[inhib] = at.SndEnv(_4d(inhib, True), SR, device=CPU)(
            torch.as_tensor(signals), torch.as_tensor(lengths)
        )[0]
    torch.testing.assert_close(out[True].gabor_raw, out[False].gabor_raw)
    assert not torch.allclose(out[True].gabor_kwta, out[False].gabor_kwta)


@pytest.mark.parametrize(
    "orients", [(0.0, 45.0, 90.0, 135.0) * 2, (30.0, 200.0, -45.0)],
    ids=["processspeech", "odd_angles"],
)
def test_inhib4_matches_jax(orients):
    rng = np.random.default_rng(11)
    act = rng.random((2, 3, 5, 4, 2, len(orients))).astype(np.float32)
    act[act < 0.4] = 0.0
    params = at.NeighInhibParams(on=True, gi=0.7)
    from auditory_tpu.config import NeighInhibParams as JParams

    want = np.asarray(jinhib4(JParams(on=True, gi=0.7), jnp.asarray(act), orients))
    got = inhib4(params, torch.as_tensor(act), orients).numpy()
    np.testing.assert_array_equal(got, want)
    off = inhib4(at.NeighInhibParams(on=False), torch.as_tensor(act), orients)
    assert not off.any() and off.shape == act.shape
    with pytest.raises(ValueError, match="orientation"):
        inhib4(params, torch.as_tensor(act), orients[:-1])


# JAX's float32 frontend: its default DFT matmul (the port's formulation),
# except at 22.05 kHz with the rectangular window, where that matmul is
# itself off the float64 result by 2.6e-5 in log power near Nyquist (551
# terms; the port's is off by 3.9e-6), so its rfft frontend is the reference
@pytest.mark.parametrize(
    "cfg,sr,method",
    [
        (_cfg(params=dict(stride_ms=95.0)), SR, "matmul"),
        (_cfg(), 22050, "fft"),
        (_cfg(dft=dict(window_fn="hamming")), 22050, "matmul"),
        (_cfg(dft=dict(prev_smooth=0.4)), SR, "matmul"),
    ],
    ids=["stride95", "sr22050", "sr22050_hamming", "prev_smooth"],
)
def test_gather_frontend_matches_jax_f32(cfg, sr, method):
    env = at.SndEnv(cfg, sr, device=CPU)
    assert env._window_grid(3, 0)[1] is None  # no shared window grid
    to = _compare_jax_f32(cfg, sr, spectrum_method=method)
    assert to.mel_fbank_global is None


def test_gather_frontend_global_mel_is_none():
    env = at.SndEnv(_cfg(), 22050, outputs=("mel_fbank_global", "energy"), device=CPU)
    signals, lengths = _batch(22050, _cfg())
    out, _ = env(torch.as_tensor(signals), torch.as_tensor(lengths))
    assert out.mel_fbank_global is None and out.energy is not None


@pytest.mark.parametrize(
    "cfg",
    [
        _cfg(gbor_out_pools_y=8, gbor_out_pools_x=2, gbor_out_units_y=2,
             gbor_out_units_x=8),
        _cfg(params=dict(stride_ms=95.0)),
        _cfg(dft=dict(prev_smooth=0.4)),
    ],
    ids=["layout_4d", "stride95", "prev_smooth"],
)
def test_f64_matches_go_oracle(cfg):
    env = at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    sig = env.pad(tone(1200.0, 0.3, SR) + tone(300.0, 0.3, SR, 0.2))
    out = env.process(sig)
    ref = SndEnvRef(cfg)
    ref.init(sig, SR)
    assert out.power_segment.shape[0] == ref.seg_cnt >= 2
    for seg in range(ref.seg_cnt):
        ref.process_segment(seg)
        for key, rtol in (
            ("power_segment", 0), ("log_power_segment", 0),
            ("mel_fbank_segment", 0), ("energy", 1e-9),
            ("mfcc_segment", 1e-9), ("mfcc_deltas", 1e-9),
            ("mfcc_delta_deltas", 1e-9),
        ):
            np.testing.assert_allclose(
                getattr(out, key)[seg].numpy(), getattr(ref, key),
                atol=ORACLE_TOL, rtol=rtol, err_msg=f"{key} seg {seg}",
            )
        np.testing.assert_allclose(
            out.gabor_raw[seg].numpy(), ref.apply_gabor(), atol=1e-4,
            rtol=1e-5, err_msg=f"gabor seg {seg}",
        )


def test_22050_f64_matches_jax_gather_f64():
    sr = 22050
    cfg = _cfg()
    dur = 0.35
    sig = tone(1234.5, dur, sr) + 0.01 * np.random.default_rng(7).normal(
        size=int(dur * sr)
    )
    outs = ("power_segment", "log_power_segment", "mel_fbank_segment",
            "mfcc_segment", "step_valid")
    jenv = JaxSndEnv(cfg, sr, dtype=jnp.float64, spectrum_method="matmul",
                     outputs=outs)
    jo = jenv.process(jenv.pad(sig))
    assert jenv._frontend_structure == "gather"
    env = at.SndEnv(cfg, sr, dtype=torch.float64, outputs=outs, device=CPU)
    to = env.process(env.pad(sig))
    for key in outs[:-1]:
        np.testing.assert_allclose(
            getattr(to, key).numpy(), np.asarray(getattr(jo, key)),
            rtol=1e-11, atol=1e-11, err_msg=key,
        )
    np.testing.assert_array_equal(to.step_valid.numpy(), np.asarray(jo.step_valid))


@pytest.mark.parametrize(
    "cfg,sr",
    [(_cfg(), SR), (_cfg(), 22050), (_cfg(dft=dict(prev_smooth=0.4)), SR),
     (_cfg(params=dict(stride_ms=95.0)), SR)],
    ids=["uniform", "sr22050", "prev_smooth", "stride95"],
)
def test_global_grid_matches_jax(cfg, sr):
    jenv = JaxSndEnv(cfg, sr, dtype=jnp.float32)
    tenv = at.SndEnv(cfg, sr, device=CPU)
    for n in (0, 500, tenv.timing.segment_samples, 12345, 3 * sr + 17):
        for add_ms in (0, 7):
            (jm, je), (tm, te) = jenv.global_grid(n, add_ms), tenv.global_grid(n, add_ms)
            assert (jm is None) == (tm is None)
            if jm is not None:
                assert jm.dtype == tm.dtype
                np.testing.assert_array_equal(tm, jm)
            assert je.dtype == te.dtype
            np.testing.assert_array_equal(te, je)


def test_adjust_for_silence_matches_jax():
    jenv = JaxSndEnv(_cfg(), SR, dtype=jnp.float32)
    tenv = at.SndEnv(_cfg(), SR, device=CPU)
    sig = np.arange(1, 4001, dtype=np.float32)
    for add, existing in ((50.0, 100.0), (100.0, 50.0), (30.0, 30.0),
                          (-1.0, 20.0), (0.0, 12.5)):
        (js, jo), (ts, to) = (jenv.adjust_for_silence(sig, add, existing),
                              tenv.adjust_for_silence(sig, add, existing))
        assert jo == to and ts.dtype == js.dtype
        np.testing.assert_array_equal(ts, js)
