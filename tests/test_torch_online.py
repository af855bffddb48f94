"""The port's online paths (OnlineSndEnv, MultiStreamOnline) against the JAX
package's on the same seeded inputs and the same chunking (CPU), and against
the port's own offline run.

Tolerances:

- float64 port vs float64 JAX or offline: spectra, mel and MFCC (deltas
  included) within rtol=atol=1e-9 (tests/test_online.py; the port's float64
  DFT is a matmul, JAX's an FFT, ~1e-11 apart); gabor_raw within atol=1e-5
  (tests/test_online.py; both convolve in float32); gabor_kwta within
  BOUNDS["gabor_kwta"] (both settle kWTA in float32);
- float32 runs: BOUNDS of tests/test_torch_sndenv.py;
- transfer tiers: float16 within float16 rounding (2^-11 relative, plus
  the float32 BOUNDS when held against JAX's tier); int8 within half a
  quantization step per stream and channel of the float32 poll, plus one
  step when held against JAX's int8 (a value on a rounding boundary may
  round to the neighbouring code) -- the bounds of tests/test_online.py
  (range/254 is one step).

The two mesh tests (``test_multistream_mesh_sharded``,
``test_multistream_mesh_with_transfer_tier``) have counterparts here over a
local ``[cpu] * n`` mesh, held against the port without a mesh and against
JAX's MultiStreamOnline on its 8-device mesh. JAX's
``test_online_spectrum_method_plumbs_through`` has none (the frontend probe
routes, ROADMAP item 8, are not ported)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.config import WindowParams as JWindowParams
from auditory_tpu.pipeline.online import MultiStreamOnline as JMultiStream
from auditory_tpu.pipeline.online import OnlineSndEnv as JOnline
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu_torch.convert import constants_from_numpy
from auditory_tpu_torch.dsp import design
from tests.conftest import default_cfg_2d, tone
from tests.test_torch_sndenv import BOUNDS

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")


def on_cpu(cls):
    """``device=CPU`` for a port class; the JAX classes take no device."""
    return {"device": CPU} if cls.__module__.startswith("auditory_tpu_torch") else {}

torch.set_num_threads(1)

SR = 16000
F64 = dict(rtol=1e-9, atol=1e-9)
GABOR_RAW = dict(rtol=0.0, atol=1e-5)
KEYS = ("mel_fbank_segment", "gabor_kwta", "step_valid")


def f64_bound(key):
    if key == "gabor_raw":
        return GABOR_RAW
    if key == "gabor_kwta":
        return BOUNDS["gabor_kwta"]
    return F64


def chunks_of(sig, rng, lo=160, hi=7000):
    i = 0
    while i < len(sig):
        n = int(rng.integers(lo, hi))
        yield sig[i : i + n]
        i += n


def to_np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def run_online(online, sig, seed, lo=160, hi=7000):
    """{seg_idx: outputs} of one stream fed in seeded random chunks."""
    got = {}
    for chunk in chunks_of(sig, np.random.default_rng(seed), lo, hi):
        for k, out in online.feed(chunk):
            assert k not in got
            got[k] = out
    for k, out in online.flush():
        assert k not in got
        got[k] = out
    return got


def assert_segments(got, ref, keys, bound=f64_bound, label=""):
    """Per-segment outputs ``got`` against ``ref`` (dataclasses or dicts,
    tensors or arrays) for ``keys``."""
    assert sorted(got) == sorted(ref), (label, sorted(got), sorted(ref))
    for k in ref:
        for key in keys:
            g, r = got[k], ref[k]
            a = to_np(g[key] if isinstance(g, dict) else getattr(g, key))
            b = to_np(r[key] if isinstance(r, dict) else getattr(r, key))
            assert a.shape == b.shape, (label, k, key, a.shape, b.shape)
            if key == "step_valid":
                np.testing.assert_array_equal(a, b, err_msg=f"{label} {k}")
            else:
                np.testing.assert_allclose(
                    a.astype(np.float64), b.astype(np.float64),
                    err_msg=f"{label} segment {k} {key}", **bound(key),
                )


def offline_segments(env, sig):
    out = env.process(env.pad(sig))
    n = out.mel_fbank_segment.shape[0]
    return {k: {f.name: getattr(out, f.name)[k]
                for f in dataclasses.fields(out)
                if getattr(out, f.name) is not None}
            for k in range(n)}


# ---------------------------------------------------------------------------
# (a) SndEnv.forward with the online add offset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr,add_ms", [(SR, 0), (SR, 20), (22050, 1000 * 442 / 22050)],
                         ids=["16k_add0", "16k_add20", "22k05_add20.045"])
def test_forward_add_ms_matches_jax_f64(sr, add_ms):
    """A full row and a ragged row through the port's forward with the
    border offset ``add_ms`` against JAX's program for the same offset."""
    cfg = default_cfg_2d()
    tenv = at.SndEnv(cfg, sr, dtype=torch.float64, device=CPU)
    jenv = JaxSndEnv(cfg, sr, dtype=jnp.float64)
    n = tenv.pad(np.zeros(int(0.43 * sr))).shape[0]
    rng = np.random.default_rng(3)
    sig = np.stack([tone(1234.0, n / sr, sr)[:n],
                    0.1 * rng.standard_normal(n)])
    lens = np.array([n, n - int(0.07 * sr)])
    jo, jv = jenv.process_fn(n, add_ms)(jnp.asarray(sig), jnp.asarray(lens))
    to, tv = tenv(torch.as_tensor(sig), torch.as_tensor(lens), add_ms=add_ms)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not to.step_valid.numpy()[1].all()  # the ragged row
    for f in dataclasses.fields(jo):
        a, b = getattr(jo, f.name), getattr(to, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        if f.name == "step_valid":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, err_msg=f.name, **f64_bound(f.name))


# ---------------------------------------------------------------------------
# (b) OnlineSndEnv against JAX and against the offline run
# ---------------------------------------------------------------------------

ONLINE_KEYS = ("mel_fbank_segment", "mfcc_deltas", "gabor_raw", "gabor_kwta",
               "step_valid")


@pytest.mark.parametrize("dur", [0.25, 0.4, 1.13])
def test_online_matches_jax_and_offline(dur):
    cfg = default_cfg_2d()
    sig = tone(1234.0, dur, SR)
    got = run_online(at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig, 1)
    jgot = run_online(JOnline(cfg, SR, dtype=jnp.float64), sig, 1)
    off = offline_segments(at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig)
    assert_segments(got, jgot, ONLINE_KEYS, label="vs jax")
    assert_segments(got, off, ONLINE_KEYS, label="vs offline")


def test_online_single_sample_chunks():
    """Pathological chunking (1..17 samples) still matches."""
    cfg = default_cfg_2d()
    sig = tone(700.0, 0.22, SR)
    got = run_online(at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig, 2,
                     lo=1, hi=17)
    jgot = run_online(JOnline(cfg, SR, dtype=jnp.float64), sig, 2, lo=1, hi=17)
    assert_segments(got, jgot, ONLINE_KEYS, label="vs jax")
    off = offline_segments(at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig)
    assert_segments(got, off, ONLINE_KEYS, label="vs offline")


def test_online_bounded_memory():
    online = at.OnlineSndEnv(default_cfg_2d(), SR, device=CPU)
    sig = tone(500.0, 2.0, SR)
    n_out = 0
    for chunk in np.array_split(sig, 40):
        for _ in online.feed(chunk):
            n_out += 1
    # buffer never exceeds one segment span + one chunk
    assert len(online._buf) <= online._span + len(sig) // 40 + 1
    assert n_out >= 18


def test_online_edge_stream_3210():
    """3210 samples give the offline segment count (2); flush is idempotent
    and closes the stream."""
    cfg = default_cfg_2d()
    sig = tone(640.0, 3210 / SR, SR)[:3210]
    online = at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    got = dict(online.feed(sig))
    got.update(dict(online.flush()))
    jo = JOnline(cfg, SR, dtype=jnp.float64)
    jgot = dict(jo.feed(sig))
    jgot.update(dict(jo.flush()))
    assert len(got) == len(jgot) == 2
    assert_segments(got, jgot, ONLINE_KEYS)
    assert_segments(got, offline_segments(
        at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig), ONLINE_KEYS)
    assert list(online.flush()) == []
    with pytest.raises(RuntimeError):
        list(online.feed(np.zeros(10)))


def test_online_feed_eager_append():
    """Samples are buffered even when the iterator is not consumed."""
    cfg = default_cfg_2d()
    sig = tone(500.0, 0.4, SR)
    online = at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    online.feed(sig[:3000])  # iterator dropped on purpose
    got = dict(online.feed(sig[3000:]))
    got.update(dict(online.flush()))
    assert_segments(got, offline_segments(
        at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig), ONLINE_KEYS)


def test_online_flush_closes_eagerly():
    """flush() closes the stream at call time: a dropped iterator still
    ends it, and the un-iterated generator drains the frozen stream."""
    cfg = default_cfg_2d()
    sig = tone(500.0, 0.15, SR)
    online = at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    online.feed(sig)
    it = online.flush()  # NOT iterated yet
    with pytest.raises(RuntimeError):
        list(online.feed(np.zeros(100)))
    assert_segments(dict(it), offline_segments(
        at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig), ONLINE_KEYS)


@pytest.mark.parametrize("n", [0, 100, 1500])
def test_online_short_stream_matches_offline(n):
    """Streams shorter than one segment (including empty) emit exactly the
    offline segments of the padded signal: SegCnt's Go truncation yields
    ONE masked segment, not zero."""
    cfg = default_cfg_2d()
    sig = tone(700.0, 1.0, SR)[:n]
    off = offline_segments(at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig)
    online = at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    if n:
        assert sum(1 for _ in online.feed(sig)) == 0
    got = dict(online.flush())
    assert len(got) == len(off) == 1
    assert_segments(got, off, ONLINE_KEYS)
    ms = at.MultiStreamOnline(cfg, SR, n_streams=1, dtype=torch.float64, device=CPU)
    if n:
        ms.feed(0, sig)
    ms.close(0)
    assert len(list(ms.drain())) == len(off)


# ---------------------------------------------------------------------------
# (c) refusals, and 22.05 kHz (fractional border offset, gather frontend)
# ---------------------------------------------------------------------------


def test_online_refusals():
    with pytest.raises(ValueError, match="mel_fbank_global"):
        at.OnlineSndEnv(default_cfg_2d(), SR,
                        outputs=("mel_fbank_global", "step_valid"), device=CPU)
    with pytest.raises(ValueError, match="feature_stats"):
        at.OnlineSndEnv(default_cfg_2d(), SR, feature_stats=True, device=CPU)
    with pytest.raises(ValueError, match="feature_stats"):
        at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=2,
                             feature_stats=True, device=CPU)


def test_online_22050_matches_jax():
    """At 22.05 kHz the border offset is 442 samples = 20.045 ms (it round-
    trips, so JAX accepts it), and the stride 2205 is no multiple of the
    221-sample step: the port runs the gather frontend."""
    sr = 22050
    cfg = default_cfg_2d()
    online = at.OnlineSndEnv(cfg, sr, dtype=torch.float64, device=CPU)
    assert online._pre == 442 and online._add_ms != int(online._add_ms)
    assert online.env._window_grid(1, online._add_ms)[1] is None
    sig = tone(987.0, 0.61, sr)
    got = run_online(online, sig, 5)
    jgot = run_online(JOnline(cfg, sr, dtype=jnp.float64), sig, 5)
    assert len(got) >= 5
    assert_segments(got, jgot, ONLINE_KEYS, label="vs jax")
    assert_segments(got, offline_segments(
        at.SndEnv(cfg, sr, dtype=torch.float64, device=CPU), sig), ONLINE_KEYS,
        label="vs offline")


# ---------------------------------------------------------------------------
# (d) MultiStreamOnline on an interleaved schedule
# ---------------------------------------------------------------------------


def interleaved(ms, sigs, seed, lo=200, hi=4000, on_poll=None):
    """Feed ``sigs`` to ``ms`` in a seeded interleaved random schedule,
    polling after every feed, then close and drain; returns {(i, k): out}
    and whether some poll returned nothing with calls in flight."""
    rng = np.random.default_rng(seed)
    cursors = [0] * len(sigs)
    got, deferred = {}, 0

    def collect(res):
        for i, k, out in res:
            assert (i, k) not in got, f"duplicate emit {(i, k)}"
            got[(i, k)] = out

    while any(c < len(s) for c, s in zip(cursors, sigs)):
        i = int(rng.integers(0, len(sigs)))
        if cursors[i] >= len(sigs[i]):
            continue
        n = int(rng.integers(lo, hi))
        ms.feed(i, sigs[i][cursors[i] : cursors[i] + n])
        cursors[i] += n
        res = ms.poll()
        if on_poll is not None:
            on_poll(res)
        if not res and ms._inflight:
            deferred += 1
        collect(res)
    for i in range(len(sigs)):
        ms.close(i)
    collect(list(ms.drain()))
    assert not ms._inflight and not ms._inflight_segs.any()
    return got, deferred


MS_KEYS = ("mel_fbank_segment", "gabor_raw", "gabor_kwta", "step_valid")


def test_multistream_matches_jax_and_offline():
    cfg = default_cfg_2d()
    durs = [0.33, 0.21, 0.57]
    sigs = [tone(500.0 + 400 * i, d, SR) for i, d in enumerate(durs)]
    got, _ = interleaved(
        at.MultiStreamOnline(cfg, SR, n_streams=3, dtype=torch.float64, device=CPU), sigs, 7)
    jgot, _ = interleaved(
        JMultiStream(cfg, SR, n_streams=3, dtype=jnp.float64), sigs, 7)
    assert_segments(got, jgot, MS_KEYS, label="vs jax")
    env = at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    off = {(i, k): v for i, s in enumerate(sigs)
           for k, v in offline_segments(env, s).items()}
    assert_segments(got, off, MS_KEYS, label="vs offline")


def test_multistream_feed_after_close_raises():
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=2, device=CPU)
    ms.feed(0, np.zeros(100, np.float32))
    ms.close(0)
    with pytest.raises(RuntimeError):
        ms.feed(0, np.zeros(10, np.float32))
    ms.feed(1, np.zeros(100, np.float32))  # the other stream is unaffected


# ---------------------------------------------------------------------------
# (e) the float16 and int8 poll tiers
# ---------------------------------------------------------------------------


def tier_run(cls, td, k=1, dur=0.5, gains=(1.0, 0.5)):
    sig = tone(900.0, dur, SR).astype(np.float32)
    ms = cls(default_cfg_2d(), SR, n_streams=len(gains), outputs=KEYS,
             transfer_dtype=td, max_segments_per_poll=k, **on_cpu(cls))
    for s, g in enumerate(gains):
        ms.feed(s, sig * g)
        ms.close(s)
    return {(i, j): out for i, j, out in ms.drain()}, ms


def assert_tier(tier, ref, td, ms, steps=1.0):
    """``tier`` within float16 rounding (or ``steps`` int8 quantization
    steps of its stream and channel, taken from the poll's scales) of the
    float32 ``ref``; same NaN positions and step validity."""
    assert set(tier) == set(ref) and ref
    for sk, rout in ref.items():
        tout = tier[sk]
        np.testing.assert_array_equal(tout["step_valid"], rout["step_valid"])
        for key in ("mel_fbank_segment", "gabor_kwta"):
            a, b = tout[key].astype(np.float64), rout[key].astype(np.float64)
            assert a.shape == b.shape
            fin = np.isfinite(b)
            assert np.array_equal(np.isfinite(a), fin), (sk, key)
            if td == "float16":
                assert tout[key].dtype == np.float16
                lim = 2.0**-11 * np.abs(b) + 2.0**-24
            else:
                # one step per (stream, channel): range/254 of the float32
                # values the quantizer saw in this stream's poll
                step = int8_steps(ms, key, b)
                lim = steps * step + f32_slack(b, step)
            err = np.abs(a - b)[fin]
            assert np.all(err <= np.broadcast_to(lim, b.shape)[fin]), (sk, key)


def int8_steps(ms, key, b):
    """One int8 quantization step per channel of one segment's float32
    values ``b`` (range/254 over the segment's finite values of each
    channel). At K=1 a poll quantizes each (stream, channel) over exactly
    one segment, so this is the quantizer's own step, up to float32
    rounding."""
    chan_ax = ms._layout[key][4]
    fin = np.where(np.isfinite(b), b, np.nan)
    axes = tuple(i for i in range(b.ndim) if i != chan_ax)
    return (np.nanmax(fin, axis=axes, keepdims=True)
            - np.nanmin(fin, axis=axes, keepdims=True)) / 254.0


def f32_slack(b, step):
    """float32 rounding of the scale, offset and dequantization."""
    return 8 * 2.0**-24 * (np.abs(b) + np.nanmax(np.abs(b)) + 127 * step)


@pytest.mark.parametrize("td", ["float16", "int8"])
def test_multistream_transfer_tiers(td):
    """The port's tiers against the port's float32 poll (half a step for
    int8: K=1 polls quantize each segment alone), and against JAX's tier."""
    ref, _ = tier_run(at.MultiStreamOnline, None)
    tier, ms = tier_run(at.MultiStreamOnline, td)
    assert_tier(tier, ref, td, ms, steps=0.5)
    jtier, _ = tier_run(JMultiStream, td)
    assert set(jtier) == set(tier)
    for sk in tier:
        np.testing.assert_array_equal(tier[sk]["step_valid"],
                                      jtier[sk]["step_valid"])
        for key in ("mel_fbank_segment", "gabor_kwta"):
            a = tier[sk][key].astype(np.float64)
            b = jtier[sk][key].astype(np.float64)
            fin = np.isfinite(b)
            assert np.array_equal(np.isfinite(a), fin)
            if td == "float16":
                lim = (2.0**-10 * np.abs(b) + BOUNDS[key]["atol"]
                       + BOUNDS[key]["rtol"] * np.abs(b))
            else:
                # each side within half a step of its own float32 values,
                # which are BOUNDS apart
                step = int8_steps(ms, key, ref[sk][key].astype(np.float64))
                lim = (step + f32_slack(b, step) + BOUNDS[key]["atol"]
                       + BOUNDS[key]["rtol"] * np.abs(b))
            assert np.all(np.abs(a - b)[fin] <= np.broadcast_to(lim, b.shape)[fin])


def test_multistream_f16_saturates_instead_of_inf():
    """float16 poll copies saturate (DC power at full scale is win^2 =
    160,000 > 65504), never ship inf."""
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=1,
                              outputs=("power_segment", "step_valid"),
                              transfer_dtype=torch.float16, device=CPU)
    ms.feed(0, np.ones(ms._post + ms.env.timing.stride_samples, np.float32))
    res = ms.poll()
    assert res
    p = res[0][2]["power_segment"]
    assert np.isfinite(p).all()
    assert p.max() == np.float16(65504.0)


# ---------------------------------------------------------------------------
# (f) overflow policies
# ---------------------------------------------------------------------------


def test_multistream_overflow_error_backpressure():
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=2,
                              max_buffer_seconds=0.0, overflow="error", device=CPU)
    assert ms._cap == ms._span
    ms.feed(0, np.zeros(ms._cap, np.float32))
    with pytest.raises(at.BufferOverflow, match="stream 0"):
        ms.feed(0, np.ones(1, np.float32))
    assert ms.pending_samples(0) == ms._cap
    assert ms.dropped_segments(0) == 0
    got = ms.poll()
    assert [i for i, _, _ in got] == [0]
    assert ms.pending_samples(0) < ms._cap
    ms.feed(0, np.zeros(ms._cap - ms.pending_samples(0), np.float32))
    ms.feed(1, np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="overflow"):
        at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=1,
                             overflow="block", device=CPU)


def drop_oldest_run(chunks):
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=1,
                              dtype=torch.float64, max_buffer_seconds=0.0,
                              overflow="drop_oldest", device=CPU)
    for c in chunks:
        ms.feed(0, c)
        assert ms.pending_samples(0) <= ms._cap
    got = {}
    while True:
        res = ms.poll()
        if not res:
            break
        got.update({k: out for _, k, out in res})
    ms.close(0)
    got.update({k: out for _, k, out in ms.drain()})
    return ms, got


def test_multistream_drop_oldest_skips_exact_segments():
    """Oldest audio goes in whole-segment strides; survivors keep their TRUE
    indices and equal the offline segments of those indices; one giant
    chunk drops exactly what small chunks of the same audio drop; JAX
    counts the same drops."""
    sig = tone(800.0, 1.5, SR)
    off = offline_segments(at.SndEnv(default_cfg_2d(), SR, dtype=torch.float64, device=CPU), sig)
    ms, got = drop_oldest_run(np.array_split(sig, 23))
    dropped = ms.dropped_segments(0)
    assert dropped > 0
    assert sorted(got) == list(range(dropped, len(off)))
    assert_segments(got, {k: off[k] for k in got}, ("mel_fbank_segment",))
    ms1, got1 = drop_oldest_run([sig])  # one chunk several times the ring
    assert ms1._cap < len(sig) / 3
    assert ms1.dropped_segments(0) == dropped and sorted(got1) == sorted(got)
    assert_segments(got1, {k: off[k] for k in got1}, ("mel_fbank_segment",))
    jms = JMultiStream(default_cfg_2d(), SR, n_streams=1, dtype=jnp.float64,
                       max_buffer_seconds=0.0, overflow="drop_oldest")
    for c in np.array_split(sig, 23):
        jms.feed(0, c)
    assert jms.dropped_segments(0) == dropped


def test_multistream_unbounded_ring_growth():
    """max_buffer_seconds=None: the ring grows (every stream re-laid-out)
    and results still match offline."""
    cfg = default_cfg_2d()
    sigs = [tone(600.0, 1.0, SR), tone(900.0, 0.3, SR)]
    env = at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    ms = at.MultiStreamOnline(cfg, SR, n_streams=2, dtype=torch.float64,
                              max_buffer_seconds=None, device=CPU)
    init_cap = ms._cap
    ms.feed(1, sigs[1])       # stream 1 mid-fill when the ring grows
    ms.feed(0, sigs[0])       # 16000 samples > 2*span forces growth
    assert ms._cap > init_cap
    ms.close(0)
    ms.close(1)
    got = {(i, k): out for i, k, out in ms.drain()}
    off = {(i, k): v for i, s in enumerate(sigs)
           for k, v in offline_segments(env, s).items()}
    assert_segments(got, off, ("mel_fbank_segment", "step_valid"))


# ---------------------------------------------------------------------------
# (g) K segments per poll
# ---------------------------------------------------------------------------


def test_multistream_poll_k_matches_k1():
    cfg = default_cfg_2d()
    sigs = [tone(500.0 + 350 * i, d, SR) for i, d in enumerate([0.53, 0.21, 0.77])]
    ref, _ = interleaved(at.MultiStreamOnline(cfg, SR, n_streams=3,
                                              dtype=torch.float64, device=CPU), sigs, 11,
                         hi=6000)
    polls = []
    k4, _ = interleaved(at.MultiStreamOnline(cfg, SR, n_streams=3,
                                             dtype=torch.float64,
                                             max_segments_per_poll=4, device=CPU),
                        sigs, 11, hi=6000, on_poll=polls.append)
    assert any(sum(1 for i_, _, _ in res if i_ == s) > 1
               for res in polls for s in range(3))
    assert_segments(k4, ref, MS_KEYS)
    jk4, _ = interleaved(JMultiStream(cfg, SR, n_streams=3, dtype=jnp.float64,
                                      max_segments_per_poll=4), sigs, 11,
                         hi=6000)
    assert_segments(k4, jk4, MS_KEYS, label="vs jax")


def test_multistream_poll_k_int8_layout():
    """K=3 with int8: the (K,)+view layout and the per-stream scales shared
    over the K seg axis dequantize within one step of the K=3 float32 poll
    (the K segments of a poll share their stream's range), and match JAX's
    K=3 int8 layout."""
    ref, _ = tier_run(at.MultiStreamOnline, None, k=3, dur=0.61, gains=(1.0, 0.4))
    q, ms = tier_run(at.MultiStreamOnline, "int8", k=3, dur=0.61, gains=(1.0, 0.4))
    assert ms._layout["mel_fbank_segment"][0][0] == 3
    assert "__qmeta__" in ms._layout
    # the stream's range over all its segments bounds each poll's range
    for s in (0, 1):
        sub = {sk: v for sk, v in ref.items() if sk[0] == s}
        for key in ("mel_fbank_segment", "gabor_kwta"):
            allv = np.stack([v[key] for v in sub.values()])
            step = (np.nanmax(allv) - np.nanmin(allv)) / 254.0
            for sk, v in sub.items():
                a, b = q[sk][key], v[key]
                fin = np.isfinite(b)
                assert np.array_equal(np.isfinite(a), fin)
                lim = 0.5 * step + f32_slack(b, step)
                assert np.all(np.abs(a - b)[fin] <= np.broadcast_to(lim, b.shape)[fin])
    jq, jms = tier_run(JMultiStream, "int8", k=3, dur=0.61, gains=(1.0, 0.4))
    assert set(jq) == set(q)
    assert jms._layout["mel_fbank_segment"][:3] == ms._layout["mel_fbank_segment"][:3]


def test_multistream_poll_k_drains_backlog_in_one_call():
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=2,
                              outputs=("mel_fbank_segment", "step_valid"),
                              max_segments_per_poll=4, device=CPU)
    t = ms.env.timing
    need = 3 * t.stride_samples + ms._post  # backs exactly segments 0..3
    rng = np.random.default_rng(3)
    for s in range(2):
        ms.feed(s, rng.standard_normal(need).astype(np.float32))
    res = ms.poll()
    for s in (0, 1):
        assert sorted(k for i, k, _ in res if i == s) == [0, 1, 2, 3]
    assert ms.poll() == []


def test_multistream_validation():
    cfg = default_cfg_2d()
    with pytest.raises(ValueError, match="max_segments_per_poll"):
        at.MultiStreamOnline(cfg, SR, n_streams=1, max_segments_per_poll=0, device=CPU)
    with pytest.raises(ValueError, match="pipeline_depth"):
        at.MultiStreamOnline(cfg, SR, n_streams=1, pipeline_depth=0, device=CPU)
    with pytest.raises(ValueError, match="n_streams"):
        at.MultiStreamOnline(cfg, SR, n_streams=0, device=CPU)
    with pytest.raises(TypeError):
        at.MultiStreamOnline(cfg, SR, n_streams=2, mesh=object(), device=CPU)


# ---------------------------------------------------------------------------
# (h) overlapping segments
# ---------------------------------------------------------------------------


def test_multistream_overlapping_segments_geometry():
    """stride_ms=50: the single-segment poll span backs 2 grid segments;
    the poll emits only the first K, and matches OnlineSndEnv and JAX."""
    cfg = default_cfg_2d(params=JWindowParams(stride_ms=50.0))
    sig = tone(700.0, 0.83, SR)
    got_ref = run_online(at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig, 3)
    assert len(got_ref) >= 3

    def run(cls, dtype, k, depth=1):
        ms = cls(cfg, SR, n_streams=2, dtype=dtype, max_segments_per_poll=k,
                 pipeline_depth=depth, **on_cpu(cls))
        assert ms._prog_segs > ms._k or k > 1
        for s in range(2):
            ms.feed(s, sig)
            ms.close(s)
        return {(i, j): out for i, j, out in ms.drain()}

    k1 = run(at.MultiStreamOnline, torch.float64, 1)
    assert sorted(j for (i, j) in k1 if i == 0) == sorted(got_ref)
    assert_segments({j: v for (i, j), v in k1.items() if i == 1}, got_ref,
                    ("mel_fbank_segment", "gabor_raw", "step_valid"))
    assert_segments(run(at.MultiStreamOnline, torch.float64, 2), k1, MS_KEYS)
    assert_segments(run(at.MultiStreamOnline, torch.float64, 1, depth=2), k1,
                    MS_KEYS)
    assert_segments(k1, run(JMultiStream, jnp.float64, 1), MS_KEYS,
                    label="vs jax")


# ---------------------------------------------------------------------------
# (i)-(k) the pipeline: depth, rollback, flush, drop_oldest accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [2, 3])
def test_multistream_pipelined_matches_sync(depth):
    """pipeline_depth=D: every emitted (stream, seg_idx, value) equals the
    synchronous run, nothing is emitted twice or skipped, the pipeline
    actually fills, and it composes with K=3."""
    cfg = default_cfg_2d()
    sigs = [tone(500.0 + 350 * i, d, SR) for i, d in enumerate([0.53, 0.21, 0.77])]

    def run(d, k=1):
        return interleaved(at.MultiStreamOnline(
            cfg, SR, n_streams=3, dtype=torch.float64, pipeline_depth=d,
            max_segments_per_poll=k, device=CPU), sigs, 11, hi=6000)

    ref, _ = run(1)
    pipe, deferred = run(depth)
    assert deferred > 0
    assert_segments(pipe, ref, MS_KEYS, bound=lambda key: dict(rtol=0, atol=0))
    pk, _ = run(depth, k=3)
    assert_segments(pk, ref, MS_KEYS)


def test_multistream_pipelined_failure_rolls_back():
    """A failure at harvest (here: the host read of the packed copy) rolls
    back EVERY in-flight claim; the next polls re-emit each segment once."""
    cfg = default_cfg_2d()
    sig = tone(660.0, 0.53, SR)
    sync = at.MultiStreamOnline(cfg, SR, n_streams=1, dtype=torch.float64, device=CPU)
    sync.feed(0, sig)
    sync.close(0)
    ref = {k: out for _, k, out in sync.drain()}
    assert len(ref) >= 2

    ms = at.MultiStreamOnline(cfg, SR, n_streams=1, dtype=torch.float64,
                              pipeline_depth=2, device=CPU)
    ms.feed(0, sig)
    ms.close(0)
    assert ms.poll() == []  # call A in flight
    assert len(ms._inflight) == 1 and ms._inflight_segs[0] >= 1

    class Boom:
        def numpy(self):
            raise RuntimeError("injected device failure")

    ms._inflight[0] = dict(ms._inflight[0], host=Boom())
    with pytest.raises(RuntimeError, match="injected"):
        ms.poll()  # dispatches call B, then harvests the poisoned A
    assert ms._inflight == [] and not ms._inflight_segs.any()
    got = {}
    for _, k, out in ms.drain():
        assert k not in got
        got[k] = out
    assert_segments(got, ref, ("mel_fbank_segment", "step_valid"))


def test_multistream_flush_pipeline():
    """flush_pipeline() harvests in-flight calls without dispatching new
    work, even when backlog would make poll() dispatch again."""
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=1,
                              dtype=torch.float64, pipeline_depth=2, device=CPU)
    assert ms.flush_pipeline() == []
    ms.feed(0, tone(440.0, 0.9, SR))
    assert ms.poll() == []
    assert len(ms._inflight) == 1
    got = ms.flush_pipeline()
    assert got and not ms._inflight
    assert ms._ready_streams().size == 1  # backlog still buffered
    assert [k for _, k, _ in got] == list(range(len(got)))


def test_multistream_pipelined_drop_oldest_accounting():
    """drop_oldest with a pipelined call in flight: the in-flight segments
    are emitted (never counted dropped), emitted and dropped partition the
    offline range, and survivors equal the offline segments."""
    sig = tone(820.0, 1.7, SR)
    off = offline_segments(at.SndEnv(default_cfg_2d(), SR, dtype=torch.float64, device=CPU), sig)
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=1,
                              dtype=torch.float64, max_buffer_seconds=0.0,
                              overflow="drop_oldest", pipeline_depth=2, device=CPU)
    got = {}
    need = ms._post + ms.env.timing.stride_samples
    ms.feed(0, sig[:need])
    assert ms.poll() == []
    claimed = int(ms._inflight_segs[0])
    seg0_a = int(ms._inflight[0]["seg0"][0])
    assert claimed >= 1
    for chunk in np.array_split(sig[need:], 5):
        ms.feed(0, chunk)
    assert ms._next_seg[0] >= claimed
    assert ms.dropped_segments(0) > 0
    for _, k, out in ms.poll() + ms.flush_pipeline():
        assert k not in got
        got[k] = out
    ms.close(0)
    for _, k, out in ms.drain():
        assert k not in got
        got[k] = out
    assert not ms._inflight and not ms._inflight_segs.any()
    for j in range(claimed):
        assert seg0_a + j in got
    assert len(got) + ms.dropped_segments(0) == len(off)
    assert_segments(got, {k: off[k] for k in got}, ("mel_fbank_segment",))


@pytest.mark.parametrize("depth", [1, 2])
def test_multistream_profile_phases(depth):
    """profile=True records the seven phases once per harvested poll."""
    ms = at.MultiStreamOnline(default_cfg_2d(), SR, n_streams=2,
                              outputs=KEYS, profile=True,
                              pipeline_depth=depth, device=CPU)
    for s in range(2):
        ms.feed(s, tone(300.0, 0.4, SR))
        ms.close(s)
    got = list(ms.drain())
    assert got
    counts = {k: len(v) for k, v in ms.poll_phases.items()}
    assert set(counts) == {"gather", "h2d", "dispatch", "compute", "d2h",
                           "unpack", "emit"}
    n_dispatch = counts["dispatch"]
    assert n_dispatch == counts["gather"] == counts["h2d"] >= 1
    # every harvest inside poll() marks compute..emit
    assert counts["compute"] == counts["emit"] == n_dispatch
    assert all(x >= 0 for v in ms.poll_phases.values() for x in v)


# ---------------------------------------------------------------------------
# (l) an analysis window, (m) constants carried across
# ---------------------------------------------------------------------------


def test_online_window_fn_matches_jax_and_offline():
    cfg = default_cfg_2d()
    hcfg = dataclasses.replace(cfg, dft=dataclasses.replace(cfg.dft,
                                                            window_fn="hamming"))
    sig = tone(987.0, 0.45, SR)
    got = run_online(at.OnlineSndEnv(hcfg, SR, dtype=torch.float64, device=CPU), sig, 7)
    jgot = run_online(JOnline(hcfg, SR, dtype=jnp.float64), sig, 7)
    assert_segments(got, jgot, ONLINE_KEYS, label="vs jax")
    off = offline_segments(at.SndEnv(hcfg, SR, dtype=torch.float64, device=CPU), sig)
    assert_segments(got, off, ONLINE_KEYS, label="vs offline")
    rect = offline_segments(at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig)
    assert not np.allclose(got[0].mel_fbank_segment.numpy(),
                           rect[0]["mel_fbank_segment"].numpy())


def test_online_load_constants_perturbed_gabor():
    """A perturbed gabor bank loaded into the port's online env and set on
    JAX's computes the same thing in both packages."""
    cfg = default_cfg_2d()
    sig = tone(1100.0, 0.4, SR)
    online = at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    jo = JOnline(cfg, SR, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    bank = np.asarray(jo.env.gabor_bank) + 0.05 * rng.standard_normal(
        jo.env.gabor_bank.shape)
    jo.env.gabor_bank = bank
    env = online.env
    online.env.load_constants(constants_from_numpy(
        env.mel_des.weights, env.dct_mat, bank,
        *design.dft_matrices(env.timing.win_samples), env.analysis_win,
    ))
    got = run_online(online, sig, 9)
    jgot = run_online(jo, sig, 9)
    assert_segments(got, jgot, ONLINE_KEYS, label="vs jax")
    plain = run_online(at.OnlineSndEnv(cfg, SR, dtype=torch.float64, device=CPU), sig, 9)
    assert not np.allclose(got[0].gabor_raw.numpy(), plain[0].gabor_raw.numpy())


def test_online_float32_matches_jax_float32():
    """The float32 online path (the serving dtype) against JAX's float32
    online path at the BOUNDS."""
    cfg = default_cfg_2d()
    sig = tone(1234.0, 0.4, SR).astype(np.float32)
    got = run_online(at.OnlineSndEnv(cfg, SR, device=CPU), sig, 4)
    jgot = run_online(JOnline(cfg, SR), sig, 4)
    assert_segments(got, jgot, ONLINE_KEYS, bound=lambda key: BOUNDS[key])


# ---------------------------------------------------------------------------
# (k) the stream axis over a local mesh
# ---------------------------------------------------------------------------


def _mesh_run(cls, n, mesh_arg, sigs, keys, **kw):
    ms = cls(cfg_mesh(), SR, n_streams=n, outputs=keys, mesh=mesh_arg, **kw,
             **on_cpu(cls))
    for s in range(n):
        ms.feed(s, sigs[s % len(sigs)])
        ms.close(s)
    return {(i, k): out for i, k, out in ms.drain()}


def cfg_mesh():
    return default_cfg_2d()


def test_multistream_mesh_sharded():
    """Stream-axis data parallelism over a 4-shard local mesh: the results
    of the port without a mesh, and of JAX's MultiStreamOnline on its
    8-device mesh (float64), and the batch-multiple validation."""
    from auditory_tpu.parallel.mesh import make_mesh as jmake_mesh
    from auditory_tpu_torch.parallel.mesh import make_mesh

    keys = ("mel_fbank_segment", "gabor_raw", "step_valid")
    n = 8
    sigs = [tone(400.0 + 130 * i, 0.4, SR).astype(np.float32) for i in range(n)]
    mesh = make_mesh([CPU] * 4)
    ref = _mesh_run(at.MultiStreamOnline, n, None, sigs, keys, dtype=torch.float64)
    shd = _mesh_run(at.MultiStreamOnline, n, mesh, sigs, keys, dtype=torch.float64)
    jax_shd = _mesh_run(JMultiStream, n, jmake_mesh(), sigs, keys, dtype=jnp.float64)
    assert set(ref) == set(shd) == set(jax_shd) and len(ref) > 0
    for sk in ref:
        np.testing.assert_array_equal(shd[sk]["step_valid"], ref[sk]["step_valid"])
        np.testing.assert_array_equal(shd[sk]["step_valid"], jax_shd[sk]["step_valid"])
        for key in ("mel_fbank_segment", "gabor_raw"):
            np.testing.assert_allclose(shd[sk][key], ref[sk][key], rtol=1e-12,
                                       atol=1e-12, err_msg=f"{sk} {key}")
            np.testing.assert_allclose(shd[sk][key], jax_shd[sk][key],
                                       err_msg=f"{sk} {key}", **f64_bound(key))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        at.MultiStreamOnline(cfg_mesh(), SR, n_streams=n + 1, mesh=mesh, device=CPU)


@pytest.mark.parametrize("td", ["float16", "int8"])
def test_multistream_mesh_with_transfer_tier(td):
    """Mesh sharding composes with the float16 and int8 poll tiers, K=2 and
    pipeline depth 2: the sharded polls equal the unsharded ones within one
    step of the tier (the tiers quantize per stream, so only float32
    rounding can move a value across a rounding boundary), and the float16
    tier stays within one float16 step of JAX's sharded float16 tier."""
    from auditory_tpu.parallel.mesh import make_mesh as jmake_mesh
    from auditory_tpu_torch.parallel.mesh import make_mesh

    keys = ("mel_fbank_segment", "step_valid")
    sigs = [tone(1000.0 + 90 * i, 0.4, SR).astype(np.float32) for i in range(8)]
    kw = dict(transfer_dtype=td, max_segments_per_poll=2, pipeline_depth=2)
    ref = _mesh_run(at.MultiStreamOnline, 8, None, sigs, keys, **kw)
    shd = _mesh_run(at.MultiStreamOnline, 8, make_mesh([CPU] * 2), sigs, keys, **kw)
    assert set(ref) == set(shd) and len(ref) > 0
    for sk in ref:
        np.testing.assert_array_equal(shd[sk]["step_valid"], ref[sk]["step_valid"])
        a, b = shd[sk]["mel_fbank_segment"], ref[sk]["mel_fbank_segment"]
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin)
        step = (1e-2 if td == "float16"
                else max(float(np.ptp(b[fin])) / 254.0, 1e-6) if fin.any() else 1e-6)
        assert np.max(np.abs(a[fin] - b[fin]), initial=0.0) <= step, sk
    if td == "float16":
        jshd = _mesh_run(JMultiStream, 8, jmake_mesh(), sigs, keys,
                         transfer_dtype="float16")
        assert set(jshd) == set(shd)
        for sk in shd:
            np.testing.assert_allclose(
                shd[sk]["mel_fbank_segment"], jshd[sk]["mel_fbank_segment"],
                # one float16 ulp at log-mel magnitude ~10 (0.0078): float32
                # rounding may flip the float16 rounding side
                atol=1e-2)


def test_multistream_mesh_overload_policy():
    """drop_oldest under overload on a 2-shard mesh drops and emits exactly
    the unsharded run's segments."""
    from auditory_tpu_torch.parallel.mesh import make_mesh

    sig = tone(700.0, 1.5, SR).astype(np.float32)

    def run(mesh_arg):
        ms = at.MultiStreamOnline(
            cfg_mesh(), SR, n_streams=4, outputs=("mel_fbank_segment",),
            max_buffer_seconds=0.5, overflow="drop_oldest", mesh=mesh_arg,
            device=CPU)
        for s in range(4):
            ms.feed(s, sig[: (s + 2) * 4000])
        got = {(i, k): out for i, k, out in ms.poll()}
        return got, [ms.dropped_segments(s) for s in range(4)]

    (ref, ref_drop), (shd, shd_drop) = run(None), run(make_mesh([CPU] * 2))
    assert ref_drop == shd_drop and sum(ref_drop) > 0
    assert set(ref) == set(shd)
    for sk in ref:
        np.testing.assert_array_equal(shd[sk]["mel_fbank_segment"],
                                      ref[sk]["mel_fbank_segment"])
