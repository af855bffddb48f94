"""Each plain PyTorch stage of the port against its JAX counterpart on the
same seeded inputs (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auditory_tpu.config import FFFBParams, KWTAParams
from auditory_tpu.dsp import design
from auditory_tpu.dsp import frame as jframe
from auditory_tpu.dsp import gabor as jgabor
from auditory_tpu.dsp import mel as jmel
from auditory_tpu.nn import fffb as jfffb
from auditory_tpu.nn import kwta as jkwta
from auditory_tpu_torch import config as tcfg
from auditory_tpu_torch.dsp import frame as tframe
from auditory_tpu_torch.dsp import gabor as tgabor
from auditory_tpu_torch.dsp import mel as tmel
from auditory_tpu_torch.nn import fffb as tfffb
from auditory_tpu_torch.nn import kwta as tkwta
from auditory_tpu_torch.utils import f32_bounds as fb
from tests.conftest import default_cfg_2d

torch.set_num_threads(1)

# elementwise stages and short sums: a few f32 ulps; the sums and matmul-fed
# stages (Energy, MFCC, deltas, gabor, kWTA) within the float32 error model's
# bound of the stage in float64 on the same input
ULP = dict(rtol=4e-7, atol=4e-7)


def _t(cls_obj):
    """The port's copy of a JAX config dataclass instance."""
    return getattr(tcfg, type(cls_obj).__name__)(**{
        f.name: (_t(v) if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cls_obj)
        for v in [getattr(cls_obj, f.name)]
    })


def _close(got, ref, bound):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, **bound)


def _model(got, ref, want, bound):
    """The port's and JAX's float32 stage (``got``, ``ref``) each within the
    float32 error model's ``bound`` of the stage run in float64 on the same
    input (``want``; auditory_tpu_torch/utils/f32_bounds.py), and of each
    other within the sum of their bounds; NaN positions equal."""
    ref = torch.as_tensor(np.array(ref))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    for g in (got, ref):
        assert fb.share(g, want, bound) <= 1.0
    assert fb.share(got, ref, 2 * bound) <= 1.0


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_extract_windows_matches_jax_inside_the_buffer():
    sig = _rng().standard_normal((2, 3000)).astype(np.float32)
    starts = np.array([[-320, -160, 0, 160], [1000, 1800, 2440, 2600]], np.int32)
    ref, _ = jframe.extract_windows(jnp.asarray(sig), jnp.asarray(starts), 400)
    got = tframe.extract_windows(torch.as_tensor(sig), torch.as_tensor(starts), 400)
    # JAX clamps reads past the end (its caller masks those windows);
    # the port zero-fills them: compare the windows that fit, check the rest
    np.testing.assert_array_equal(got[:, :, :3].numpy(), np.asarray(ref)[:, :, :3])
    np.testing.assert_array_equal(got[:, 1, 3].numpy(), sig[:, 2600:3000])
    over = tframe.extract_windows(torch.as_tensor(sig), torch.tensor([2800]), 400)
    np.testing.assert_array_equal(over[:, 0, :200].numpy(), sig[:, 2800:])
    assert torch.equal(over[:, 0, 200:], torch.zeros(2, 200))


def test_apply_mel_and_renorm_match_jax():
    rng = _rng(1)
    w = design.mel_design(tcfg.FilterBank(), 400, 16000).weights.astype(np.float32)
    power = (rng.random((3, 5, 201)) ** 4 * 50).astype(np.float32)
    power[0, 0] = 0.0  # exact-zero mel sums take the LogMin floor
    for fb in (tcfg.FilterBank(), tcfg.FilterBank(renorm_after_init=True)):
        ref = jmel.apply_mel(jnp.asarray(power), jnp.asarray(w), fb)
        got = tmel.apply_mel(torch.as_tensor(power), torch.as_tensor(w), fb)
        _close(got, ref, ULP)
        # LogMin -10 alone, or renormed: (-10 + 6) / 10 clipped to 0
        assert (got[0, 0] == (0.0 if fb.renorm_effective else -10.0)).all()


def test_apply_mel_propagates_nan_weights():
    w = design.mel_design(tcfg.FilterBank(n_filters=80, hi_hz=4000.0), 200, 8000).weights
    w = w.astype(np.float32)
    power = (_rng(2).random((2, 7, 101)) * 3).astype(np.float32)
    ref = jmel.apply_mel(jnp.asarray(power), jnp.asarray(w), tcfg.FilterBank(n_filters=80, hi_hz=4000.0))
    got = tmel.apply_mel(torch.as_tensor(power), torch.as_tensor(w), tcfg.FilterBank(n_filters=80, hi_hz=4000.0))
    assert np.isnan(got.numpy()).any()
    _close(got, ref, ULP)


def test_mfcc_dct_matches_jax():
    mel = (_rng(3).standard_normal((3, 2, 14, 32)) * 3).astype(np.float32)
    dct = design.dct1_matrix(32).astype(np.float32)
    ref = jmel.mfcc_dct(jnp.asarray(mel), jnp.asarray(dct), 13)
    got = tmel.mfcc_dct(torch.as_tensor(mel), torch.as_tensor(dct), 13)
    x = torch.as_tensor(mel, dtype=torch.float64)
    want = tmel.mfcc_dct(x, torch.as_tensor(dct, dtype=torch.float64), 13)
    a = torch.as_tensor(dct, dtype=torch.float64).abs()
    bound = fb.stage_bound(torch.zeros_like(x), x, lambda v: v @ a.T, 32)[..., :13]
    # c0 is ln(1 + c^2): its change is at most c's, plus ln's rounding
    bound[..., 0] += 3 * fb.U * (1 + want[..., 0].abs())
    _model(got, ref, want, bound)


@pytest.mark.parametrize("mode", ["sndenv", "gaborview", "spectral"])
def test_energy_matches_jax(mode):
    lp = (_rng(4).standard_normal((3, 2, 14, 201)) * 4).astype(np.float32)
    ref = jmel.energy(jnp.asarray(lp), mode)
    got = tmel.energy(torch.as_tensor(lp), mode)
    x = torch.as_tensor(lp, dtype=torch.float64)
    bound = fb.stage_bound(torch.zeros_like(x), x, lambda v: tmel.energy(v, mode),
                           x.shape[-1])
    _model(got, ref, tmel.energy(x, mode), bound)
    with pytest.raises(ValueError):
        tmel.energy(torch.as_tensor(lp), "bogus")


@pytest.mark.parametrize("mode", ["sndenv", "gaborview"])
def test_mfcc_deltas_with_nan_match_jax(mode):
    x = _rng(5).standard_normal((3, 14, 13)).astype(np.float32)
    x[0, 3, 2] = np.nan
    x[2, 13, 0] = np.nan
    ref = jmel.mfcc_deltas(jnp.asarray(x), npn=2, mode=mode)
    got = tmel.mfcc_deltas(torch.as_tensor(x), npn=2, mode=mode)
    assert np.isnan(got.numpy()).any() and not np.isnan(got.numpy()).all()
    x = torch.as_tensor(x, dtype=torch.float64)
    m = torch.as_tensor(tmel.delta_operator(14, 13, 2, mode)[0].reshape(182, 182)).abs()
    op = lambda v: (v.reshape(3, 182) @ m.T).reshape(v.shape)
    bound = fb.stage_bound(torch.zeros_like(x), x, op, 182)
    _model(got, ref, tmel.mfcc_deltas(x, npn=2, mode=mode), bound)


@pytest.mark.parametrize("by_time", [False, True])
def test_convolve_and_layout_2d_match_jax(by_time):
    cfg = default_cfg_2d()
    bank = design.gabor_filters(cfg.gabor).astype(np.float32)
    mel = (_rng(6).standard_normal((3, 2, 32, 14)) * 2).astype(np.float32)
    mel[1, 0, 5, 5] = np.nan  # gabor reads NaN as 0.5
    ref4 = jgabor.convolve(jnp.asarray(mel), jnp.asarray(bank), cfg.gabor)
    got4 = tgabor.convolve(torch.as_tensor(mel), torch.as_tensor(bank), _t(cfg.gabor))
    # the stage in float64 on the same input, and its bound: gain times the
    # convolution with |bank| of |mel| (NaN read as 0.5) on both channels
    x = torch.as_tensor(mel, dtype=torch.float64)
    x = torch.where(torch.isnan(x), torch.full_like(x, 0.5), x)
    k = torch.as_tensor(bank, dtype=torch.float64)
    gs = cfg.gabor

    def conv(v, kern):
        out = torch.nn.functional.conv2d(v.reshape(-1, 1, 32, 14), kern[:, None],
                                         stride=(gs.stride_y, gs.stride_x))
        return out.reshape((3, 2) + out.shape[1:]).permute(0, 1, 3, 4, 2)

    c = conv(x, k) * gs.gain
    want4 = torch.stack([c.clamp(min=0), (-c).clamp(min=0)], dim=-2)
    b = fb.stage_bound(torch.zeros_like(x), x, lambda v: conv(v, k.abs()) * gs.gain,
                       81)[..., None, :].expand(want4.shape)
    _model(got4, ref4, want4, b)
    ti = ref4.shape[-3]
    for t_max in (ti, ti + 2):
        ref = jgabor.to_layout_2d(ref4, by_time, t_max)
        got = tgabor.to_layout_2d(got4, by_time, t_max)
        _model(got, ref, tgabor.to_layout_2d(want4, by_time, t_max),
               tgabor.to_layout_2d(b, by_time, t_max))
    assert tgabor.gabor_out_counts((32, 14), cfg.gabor, (4, 3)) == \
        jgabor.gabor_out_counts((32, 14), cfg.gabor, (4, 3))


def test_convolve_refuses_narrow_mel():
    cfg = default_cfg_2d()
    bank = torch.as_tensor(design.gabor_filters(cfg.gabor))
    with pytest.raises(ValueError):
        tgabor.convolve(torch.zeros(32, 8), bank, cfg.gabor)
    with pytest.raises(ValueError):
        tgabor.convolve(torch.zeros(8, 14), bank, cfg.gabor)


@pytest.mark.parametrize("on", [True, False])
def test_fffb_matches_jax(on):
    p = FFFBParams(on=on, max_vs_avg=0.3)
    rng = _rng(7)
    avg, mx, act = (rng.random((3, 1, 1)).astype(np.float32) for _ in range(3))
    jffi = jfffb.fffb_ffi(p, jnp.asarray(avg), jnp.asarray(mx))
    tffi = tfffb.fffb_ffi(p, torch.as_tensor(avg), torch.as_tensor(mx))
    _close(tffi, jffi, ULP)
    js = jfffb.fffb_init((3, 1, 1), jnp.float32)
    ts = tfffb.fffb_init((3, 1, 1), torch.float32)
    for _ in range(3):
        js = jfffb.fffb_step(p, js, jnp.asarray(avg), jnp.asarray(mx), jnp.asarray(act))
        ts = tfffb.fffb_step(p, ts, torch.as_tensor(avg), torch.as_tensor(mx),
                             torch.as_tensor(act))
        _close(ts.fbi, js.fbi, ULP)
        _close(ts.gi, js.gi, ULP)


@pytest.mark.parametrize("nvar", [0.01, 0.0])
def test_xx1_matches_jax(nvar):
    p = KWTAParams(xx1_nvar=nvar)
    drive = np.linspace(-0.1, 0.5, 4001, dtype=np.float32)
    ref = jkwta.xx1(p, jnp.asarray(drive))
    got = tkwta.xx1(_t(p), torch.as_tensor(drive))
    _close(got, ref, ULP)


def test_kwta_layer_matches_jax():
    p = KWTAParams()
    rng = _rng(8)
    raw = (rng.random((3, 16, 16)) ** 3).astype(np.float32)
    ext = (0.05 * rng.random((3, 16, 16))).astype(np.float32)
    ref = jax.vmap(lambda g, e: jkwta.kwta_layer(p, g, e))(
        jnp.asarray(raw), jnp.asarray(ext))
    got = tkwta.kwta_layer(_t(p), torch.as_tensor(raw), torch.as_tensor(ext),
                           batch_ndim=1)
    # the settle in float64 on the same input, within the settle's bound
    want = tkwta._settle(_t(p), torch.as_tensor(raw, dtype=torch.float64),
                         torch.as_tensor(ext, dtype=torch.float64), 1, None)
    _model(got, ref, want, torch.full_like(want, fb.settle_bound(
        _t(p), torch.as_tensor(raw))))
    assert 0.0 < float((got > 0.1).float().mean()) < 0.9
    off = dataclasses.replace(_t(p), on=False)
    assert torch.equal(tkwta.kwta_layer(off, torch.as_tensor(raw)),
                       torch.as_tensor(raw))


def test_kwta_pool_matches_jax():
    p = KWTAParams()
    raw = (_rng(9).random((3, 4, 4, 2, 8)) ** 3).astype(np.float32)
    ref = jax.vmap(lambda g: jkwta.kwta_pool(p, g))(jnp.asarray(raw))
    got = tkwta.kwta_pool(_t(p), torch.as_tensor(raw), batch_ndim=1)
    x = torch.as_tensor(raw, dtype=torch.float64)
    want = tkwta._settle(_t(p), x, torch.zeros_like(x), 1, (3, 4))
    _model(got, ref, want, torch.full_like(want, fb.settle_bound(_t(p), x)))
