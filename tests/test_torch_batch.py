"""The port's batch packing and transfer tiers (CPU): PackedBatch round
trips, int8 quantization against the JAX package's, the int16 upload, the
float16 saturation, and inert pad rows."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.pipeline.batch import _quantize_int8 as jquantize
from auditory_tpu_torch.pipeline.batch import (
    PackedBatch,
    _pad_batch_rows,
    _quantize_int8,
    _saturate_cast,
    bucket_length,
)
from tests.conftest import default_cfg_2d, tone
from tests.test_torch_sndenv import BOUNDS

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000
KEYS = ("mel_fbank_segment", "gabor_kwta")
CFG_4D = dataclasses.replace(
    default_cfg_2d(), gbor_out_pools_y=8, gbor_out_pools_x=2
)


def _batch(env, durations=(0.25, 0.4, 0.15), amp=0.5):
    """Padded float32 batch of tones with true (padded) lengths."""
    sigs = [
        env.pad(tone(500.0 + 300 * i, d, SR, amp=amp))
        for i, d in enumerate(durations)
    ]
    blen = bucket_length(max(len(s) for s in sigs), env.timing)
    batch = np.zeros((len(sigs), blen), np.float32)
    lengths = np.array([len(s) for s in sigs], np.int32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    return batch, lengths


@pytest.mark.parametrize("cfg", [default_cfg_2d(), CFG_4D], ids=["2d", "4d"])
def test_packed_roundtrip_bitwise(cfg):
    env = at.SndEnv(cfg, SR, outputs=KEYS + ("step_valid",), device=CPU)
    batch, lengths = _batch(env)
    out, _ = at.BatchedSndEnv(env).process(batch, lengths)
    (pb,) = at.BatchedSndEnv(env, pack_keys=KEYS).process(batch, lengths)
    assert isinstance(pb, PackedBatch) and pb.data.ndim == 2
    host = pb.unpack()
    for k in KEYS:
        np.testing.assert_array_equal(host[k], getattr(out, k).numpy(), err_msg=k)
    # the on/off fold halves the gabor payload in the buffer
    ge = next(e for e in pb.entries if e.key == "gabor_kwta")
    assert ge.row_cols * 2 == int(np.prod(host["gabor_kwta"].shape[2:]))
    # trim is a pure slice, and a no-op at the full row count
    assert pb.trim(host["mel_fbank_segment"].shape[1]) is pb
    host2 = pb.trim(2).unpack()
    for k in KEYS:
        np.testing.assert_array_equal(host2[k], host[k][:, :2], err_msg=k)


def test_packed_global_grid_trim():
    env = at.SndEnv(default_cfg_2d(), SR, outputs=("mel_fbank_global",), device=CPU)
    batch, lengths = _batch(env)
    out, _ = at.BatchedSndEnv(env).process(batch, lengths)
    (pb,) = at.BatchedSndEnv(
        env, pack_keys=("mel_fbank_global",)
    ).process(batch, lengths)
    np.testing.assert_array_equal(
        pb.unpack()["mel_fbank_global"], out.mel_fbank_global.numpy()
    )
    rows = (2 - 1) * pb.sps + pb.steps  # the global windows of 2 segments
    np.testing.assert_array_equal(
        pb.trim(2).unpack()["mel_fbank_global"],
        out.mel_fbank_global.numpy()[:, :rows],
    )


@pytest.mark.parametrize(
    "chan_ax,symmetric,per_row",
    [(0, False, False), (0, True, False), (1, False, True), (None, True, True)],
    ids=["affine", "symmetric", "affine_per_row", "symmetric_per_row"],
)
def test_quantize_int8_matches_jax(chan_ax, symmetric, per_row):
    r = np.random.default_rng(5)
    a = (r.standard_normal((3, 4, 6, 10)) * 3.0 + 1.0).astype(np.float32)
    a[0, 1, 2, 3] = np.nan
    a[1, 0, 0, :] = 0.0
    a[2, :, 5, :] = np.inf  # a channel with no finite values in row 2
    want = [np.asarray(x) for x in jquantize(jnp.asarray(a), chan_ax, symmetric, per_row)]
    got = [x.numpy() for x in _quantize_int8(torch.as_tensor(a), chan_ax, symmetric, per_row)]
    for g, w, name in zip(got, want, ("q", "scale", "offset")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_int8_packed_within_half_a_step():
    cfg = dataclasses.replace(default_cfg_2d(), kwta=at.KWTAParams(on=True))
    keys = ("mel_fbank_segment", "mfcc_segment", "energy", "gabor_kwta")
    env = at.SndEnv(cfg, SR, outputs=keys + ("step_valid",), device=CPU)
    batch, lengths = _batch(env)
    (qb,) = at.BatchedSndEnv(env, transfer_dtype="int8", pack_keys=keys).process(
        batch, lengths
    )
    (fb,) = at.BatchedSndEnv(env, pack_keys=keys).process(batch, lengths)
    assert qb.data.dtype == torch.int8 and qb.entries[-1].key == "__qmeta__"
    qh, fh = qb.unpack(), fb.unpack()
    for k in keys:
        a, b = qh[k], fh[k]
        assert a.shape == b.shape, k
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin), k
        # per row: the affine step is that row's range/254 at most
        for i in range(b.shape[0]):
            f = fin[i]
            tol = max((np.nanmax(b[i]) - np.nanmin(b[i])) / 254.0, 1e-6)
            assert np.max(np.abs(a[i][f] - b[i][f])) <= tol, (k, i)
    # the symmetric gabor grid keeps exact zeros
    assert np.all(qh["gabor_kwta"][fh["gabor_kwta"] == 0] == 0)
    # trim keeps the scales trailer
    np.testing.assert_array_equal(
        qb.trim(2).unpack()["mel_fbank_segment"], qh["mel_fbank_segment"][:, :2]
    )


def test_int8_requires_pack_keys():
    env = at.SndEnv(default_cfg_2d(), SR, device=CPU)
    with pytest.raises(ValueError, match="int8"):
        at.BatchedSndEnv(env, transfer_dtype="int8")
    with pytest.raises(ValueError, match="transfer dtype"):
        at.BatchedSndEnv(env, transfer_dtype="float17")


def test_int16_tier_matches_float_path():
    env = at.SndEnv(default_cfg_2d(), SR, feature_stats=True, device=CPU)
    batch, lengths = _batch(env)
    sig16 = np.round(batch * 32767.0).astype(np.int16)
    div = np.array([32767.0, 32768.0, 128.0], dtype=np.float32)
    benv = at.BatchedSndEnv(env)
    res16 = benv.process(sig16, lengths, divisors=div)
    # the on-device divide equals the same float32 division done beforehand
    f32 = torch.as_tensor(sig16).to(torch.float32) / torch.as_tensor(div)[:, None]
    ref = benv.process(f32, lengths)
    for f in ("mel_fbank_segment", "mfcc_segment", "gabor_kwta"):
        torch.testing.assert_close(
            getattr(res16[0], f), getattr(ref[0], f), rtol=0, atol=0
        )
    torch.testing.assert_close(res16[2]["sum"], ref[2]["sum"], rtol=0, atol=0)
    # and the host float64 normalization within the f32 bounds
    host = (sig16.astype(np.float64) / div[:, None]).astype(np.float32)
    out_host = benv.process(host, lengths)[0]
    for f in ("mel_fbank_segment", "mfcc_segment", "gabor_kwta"):
        np.testing.assert_allclose(
            getattr(res16[0], f).numpy(), getattr(out_host, f).numpy(),
            err_msg=f, **BOUNDS[f],
        )
    with pytest.raises(ValueError, match="divisors"):
        benv.process(sig16, lengths)


def test_float16_saturates():
    x = torch.tensor([7e4, -7e4, float("nan"), 1.5, 65504.0])
    y = _saturate_cast(x, torch.float16)
    assert y.dtype == torch.float16
    np.testing.assert_array_equal(
        y.float().numpy(), [65504.0, -65504.0, np.nan, 1.5, 65504.0]
    )
    assert _saturate_cast(torch.tensor([3, 70000]), torch.float16).tolist() == [3.0, float("inf")]
    # tones on a DC offset of 0.8: the DC bin's power (400 * 0.8)^2 passes
    # the float16 maximum
    env = at.SndEnv(default_cfg_2d(), SR, outputs=("power_segment", "mel_fbank_segment"), device=CPU)
    batch, lengths = _batch(env, amp=0.15)
    batch = np.where(batch != 0, batch + 0.8, 0.0).astype(np.float32)
    out32, _ = at.BatchedSndEnv(env).process(batch, lengths)
    out16, _ = at.BatchedSndEnv(env, transfer_dtype=torch.float16).process(
        batch, lengths
    )
    assert float(out32.power_segment.max()) > 65504.0
    assert out16.power_segment.dtype == torch.float16
    assert torch.isfinite(out16.power_segment).all()
    assert float(out16.power_segment.max()) == 65504.0
    np.testing.assert_allclose(
        out16.mel_fbank_segment.float().numpy(),
        out32.mel_fbank_segment.numpy(), rtol=1e-3, atol=1e-2,
    )


def test_pad_rows_are_inert():
    env = at.SndEnv(default_cfg_2d(), SR, feature_stats=True, device=CPU)
    batch, lengths = _batch(env)
    sig = torch.as_tensor(batch)
    padded, plens, pdiv, pad = _pad_batch_rows(sig, lengths, None, 4, min_rows=5)
    assert pad == 5 and padded.shape[0] == 8 and pdiv is None
    assert plens.dtype == torch.int32 and plens[3:].eq(0).all()
    out, valid, stats = env(sig, torch.as_tensor(lengths))
    pout, pvalid, pstats = env(padded, plens)
    assert not pvalid[3:].any()
    torch.testing.assert_close(pvalid[:3], valid, rtol=0, atol=0)
    for f in ("mel_fbank_segment", "mfcc_segment", "gabor_kwta"):
        torch.testing.assert_close(getattr(pout, f)[:3], getattr(out, f))
        assert not getattr(pout, f)[3:].any(), f
    for k in ("sum", "sumsq", "count"):
        torch.testing.assert_close(pstats[k], stats[k])
    _, _, ddiv, dpad = _pad_batch_rows(sig, lengths, np.full(3, 2.0), 2)
    assert dpad == 1 and ddiv.tolist() == [2.0, 2.0, 2.0, 1.0]
