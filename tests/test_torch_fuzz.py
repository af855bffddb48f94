"""Randomized configurations through the port (CPU): the counterpart of
tests/test_fuzz_parity.py, on the configurations its four families draw
under their own seeds.

The draws are kept as data in tests/data/torch_fuzz_configs.json, because
chip_smoke.py runs them on the card, whose machine has no JAX to run the
sampler. :func:`draw_entries` replays every family's draws through
``sample_cfg`` and ``config_is_runnable``, imported unchanged, and
:func:`test_fuzz_file_is_the_samplers_draws` holds the file equal to it
(regenerate with ``python -m tests.test_torch_fuzz``). Each case reads its
entry through chip_smoke.py's loader (``fuzz_entries``), so the loader is
held too.

For every entry of the families "config" and "layout" (the 4-D pooled and
byTime layouts):

- float64: the port on every ``segment_frontend`` route against the Go
  oracle at tests/test_pipeline_parity.py::assert_segments_match's
  tolerances, and against JAX's float64 run on the entry's drawn frontend;
- float32: the port at ``kernel_passes`` 6 and 3 (on the kernel's route:
  the uniform grid under ``'auto'``, the segment spans under
  ``'per_segment'`` off it) and JAX's float32 run, each within the float32
  error model's bound of the port's float64 run
  (tests/test_torch_sndenv.py::hold_f32; JAX's XLA frontend ``any_order``).

Family "online": OnlineSndEnv fed the entry's drawn chunk sizes against the
offline run (segment counts equal, mel within the JAX test's 1e-9). Family
"segment": SegmentPipeline against JAX's and the literal per-step Go
oracle at the JAX test's tolerances, and its float32 run within the
model's bound.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu.pipeline.segments as jseg
import auditory_tpu_torch as at
from auditory_tpu.config import GaborSet as JGaborSet
from auditory_tpu.config import KWTAParams as JKWTAParams
from auditory_tpu.config import MelParams as JMelParams
from auditory_tpu.config import SndEnvConfig as JSndEnvConfig
from auditory_tpu.config import msec_to_samples
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu.refemu import goref
from auditory_tpu.refemu.goref import SndEnvRef
from auditory_tpu_torch.utils import f32_bounds as fb
from chip_smoke import FUZZ_JSON, from_dict, fuzz_entries, fuzz_tone
from tests.conftest import tone
from tests.test_fuzz_parity import config_is_runnable, sample_cfg
from tests.test_pipeline_parity import TOL
from tests.test_torch_segments import F64, F64_GABOR
from tests.test_torch_sndenv import hold_f32, jax_order

CPU = torch.device("cpu")

torch.set_num_threads(1)

# (family, first seed, seeds): tests/test_fuzz_parity.py's parametrizations
FAMILIES = (("config", 1000, 20), ("layout", 5000, 8), ("online", 9000, 6),
            ("segment", 12000, 6))
METHODS = ["fft", "matmul", "conv", "frames", "windowed", "sliced"]
ROUTES = ("auto", "per_segment", "gather")
# float64 against JAX's float64 run: tests/test_torch_segments.py's bounds
# (the gabor stages, float32 by contract on both sides, at F64_GABOR)
GABOR_KEYS = ("gabor_raw", "gabor_kwta")


def _runnable(rng, online=False):
    """The first runnable draw of 50, as the fuzz tests loop (the online
    family also skips a border offset OnlineSndEnv refuses)."""
    from auditory_tpu.pipeline.online import OnlineSndEnv

    for _ in range(50):
        cfg, sr = sample_cfg(rng)
        if not config_is_runnable(cfg, sr):
            continue
        if online:
            try:
                OnlineSndEnv(cfg, sr, dtype=jnp.float64)
            except ValueError:
                continue
        return cfg, sr
    raise AssertionError("no runnable config sampled")


def _sndenv_entry(family, seed, rng):
    """Families "config", "layout" and "online": the config, the rate, the
    tone and the signal's length, and what each family draws after them
    (the frontend, the layout change, the chunk sizes)."""
    from auditory_tpu.dsp.gabor import gabor_out_counts

    cfg, sr = _runnable(rng, online=family == "online")
    t = cfg.params.derive(sr)
    extra = {}
    if family == "config":
        tail, lo, hi = 321, 200, min(3500, sr / 2 - 500)
    elif family == "layout":
        if rng.random() < 0.5:
            fc, tc = gabor_out_counts(
                (cfg.mel.fbank.n_filters, t.segment_steps), cfg.gabor, None)
            cfg = dataclasses.replace(
                cfg, gbor_out_pools_y=fc, gbor_out_pools_x=tc,
                gbor_out_units_y=2, gbor_out_units_x=cfg.gabor.n_filters)
        else:
            cfg = dataclasses.replace(cfg, by_time=True)
        tail, lo, hi = 123, 300, min(3000, sr / 2 - 600)
    else:
        tail, lo, hi = 77, 300, min(3000, sr / 2 - 600)
    strides = 3 if family == "online" else 2
    dur = (t.segment_samples + strides * t.stride_samples + tail) / sr
    freq = float(rng.uniform(lo, hi))
    n = int(dur * sr)
    if family == "config":
        extra["method"] = str(rng.choice(METHODS))
    elif family == "online":
        chunks, i = [], 0
        while i < n:
            chunks.append(int(rng.integers(100, 4000)))
            i += chunks[-1]
        extra["chunks"] = chunks
    return dict(family=family, seed=seed, sample_rate=sr,
                config=dataclasses.asdict(cfg), tone_hz=freq, dur_s=dur,
                n_samples=n, **extra)


def _segment_entry(seed, rng):
    """Family "segment": the SegmentPipeline's rate, gabor bank, window
    parameters, tone and slice (test_fuzzed_segment_pipeline's draws)."""
    from auditory_tpu.config import GaborSet, default_gabor_specs

    sr = int(rng.choice([16000, 22050]))
    gsize = int(rng.choice([6, 8]))
    gset = GaborSet(
        size_x=gsize, size_y=gsize,
        stride_x=int(rng.integers(2, gsize + 1)),
        stride_y=int(rng.integers(2, gsize + 1)),
        gain=1.5, specs=default_gabor_specs(phases=(0.0,)),
    )
    wp = jseg.SegmentWindowParams(resize=bool(rng.random() < 0.7),
                                  border_steps=int(rng.integers(0, 3)))
    freq = float(rng.uniform(300, 3000))
    a = float(rng.uniform(30, 300))
    b = a + float(rng.uniform(40, 250))
    return dict(family="segment", seed=seed, sample_rate=sr,
                gabor=dataclasses.asdict(gset), wparams=dataclasses.asdict(wp),
                tone_hz=freq, dur_s=0.8, n_samples=int(0.8 * sr),
                start_ms=a, end_ms=b)


def draw_entries():
    """Every family's draws, in order, as JSON-ready dicts."""
    entries = []
    for family, base, n in FAMILIES:
        for seed in range(n):
            rng = np.random.default_rng(base + seed)
            entries.append(_segment_entry(seed, rng) if family == "segment"
                           else _sndenv_entry(family, seed, rng))
    return json.loads(json.dumps(entries))


ENTRIES = fuzz_entries(at)


def _cases(*families):
    return pytest.mark.parametrize(
        "e", [e for e in ENTRIES if e["family"] in families],
        ids=lambda e: f"{e['family']}{e['seed']}")


def test_fuzz_file_is_the_samplers_draws():
    with open(FUZZ_JSON) as f:
        assert json.load(f) == draw_entries()
    assert [(f, n) for f, _, n in FAMILIES] == [
        (f, sum(e["family"] == f for e in ENTRIES)) for f, _, _ in FAMILIES]
    for e in ENTRIES:
        # the loader's port objects carry every field of the draw
        if e["family"] == "segment":
            got = {"gabor": e["gset"], "wparams": e["wp"]}
        else:
            got = {"config": e["cfg"]}
            assert dataclasses.asdict(from_dict(JSndEnvConfig, e["config"])) \
                == dataclasses.asdict(e["cfg"])
        for key, obj in got.items():
            assert json.loads(json.dumps(dataclasses.asdict(obj))) == e[key]
        np.testing.assert_array_equal(
            fuzz_tone(e), tone(e["tone_hz"], e["dur_s"], e["sample_rate"]))


def _oracle(jcfg, signal, sr):
    """The Go oracle's segments of ``signal``: a list of dicts."""
    ref = SndEnvRef(jcfg)
    ref.init(signal, sr)
    segs = []
    for seg in range(max(ref.seg_cnt, 0)):
        ref.process_segment(seg, 0)
        segs.append({k: np.array(getattr(ref, k)) for k in (
            "power_segment", "log_power_segment", "mel_fbank_segment", "energy",
            "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas") if hasattr(ref, k)})
        segs[-1]["gabor_raw"] = np.array(ref.apply_gabor())
    return segs


def _assert_oracle(cfg, out, segs, label):
    """assert_segments_match's checks on the port's float64 ``out``."""
    assert out.power_segment.shape[0] == len(segs), label
    for seg, ref in enumerate(segs):
        checks = [("power_segment", 0), ("log_power_segment", 0),
                  ("mel_fbank_segment", 0), ("energy", 1e-9)]
        if cfg.mel.mfcc:
            checks.append(("mfcc_segment", 1e-9))
            if cfg.mel.deltas:
                checks += [("mfcc_deltas", 1e-9), ("mfcc_delta_deltas", 1e-9)]
        for key, rtol in checks:
            np.testing.assert_allclose(
                getattr(out, key)[seg].numpy(), ref[key], atol=TOL, rtol=rtol,
                err_msg=f"{label}: {key} seg {seg}")
        np.testing.assert_allclose(out.gabor_raw[seg].numpy(), ref["gabor_raw"],
                                   atol=1e-4, rtol=1e-5,
                                   err_msg=f"{label}: gabor seg {seg}")


def _assert_jax_f64(out, jout, label):
    for f in dataclasses.fields(out):
        got, want = getattr(out, f.name), getattr(jout, f.name)
        assert (got is None) == (want is None), (label, f.name)
        if got is None:
            continue
        want = np.asarray(want)
        if f.name == "step_valid":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
            continue
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{label}: {f.name}",
                                   **(F64_GABOR if f.name in GABOR_KEYS else F64))


def _rows(e, padded):
    """B=2 float32 rows: the padded tone, and a noise row of a ragged true
    length."""
    n = padded.shape[0]
    rng = np.random.default_rng(e["seed"])
    rows = np.stack([padded, 0.1 * rng.standard_normal(n)]).astype(np.float32)
    stride = e["cfg"].params.derive(e["sample_rate"]).stride_samples
    return rows, np.array([n, n - stride // 2], dtype=np.int32)


@_cases("config", "layout")
def test_fuzzed_config(e):
    cfg, sr = e["cfg"], e["sample_rate"]
    jcfg = from_dict(JSndEnvConfig, e["config"])
    env64 = {r: at.SndEnv(cfg, sr, dtype=torch.float64, segment_frontend=r,
                          device=CPU) for r in ROUTES}
    padded = env64["auto"].pad(tone(e["tone_hz"], e["dur_s"], sr))
    n = padded.shape[0]
    segs = _oracle(jcfg, padded, sr)
    jout = JaxSndEnv(jcfg, sr, dtype=jnp.float64,
                     spectrum_method=e.get("method", "fft")).process(padded)
    kernel_route = None
    for route, env in env64.items():
        label = f"{e['family']}{e['seed']} {route} ({env.route(n)})"
        out = env.process(padded)
        _assert_oracle(cfg, out, segs, label)
        _assert_jax_f64(out, jout, label)
        if env.route(n) in ("kernel", "per_segment") and kernel_route is None:
            kernel_route = route
    assert kernel_route is not None  # the uniform grid, or segment spans

    rows, lengths = _rows(e, padded)
    sig_t, len_t = torch.as_tensor(rows), torch.as_tensor(lengths)
    jenv = JaxSndEnv(jcfg, sr, dtype=jnp.float32)
    jo, _ = jenv.process_fn(rows.shape[-1])(jnp.asarray(rows), jnp.asarray(lengths))

    def port(passes, route):
        return at.SndEnv(cfg, sr, kernel_passes=passes, segment_frontend=route,
                         device=CPU)(sig_t, len_t)[0]

    hold_f32({"jax": jo, "port": port(6, "auto")}, cfg, sr, rows, lengths,
             any_order=jax_order(jenv))
    if kernel_route != "auto":
        hold_f32({"port": port(6, kernel_route)}, cfg, sr, rows, lengths,
                 segment_frontend=kernel_route)
    hold_f32({"port": port(3, kernel_route)}, cfg, sr, rows, lengths, passes=3,
             segment_frontend=kernel_route)


@_cases("online")
def test_fuzzed_online_matches_offline(e):
    cfg, sr = e["cfg"], e["sample_rate"]
    sig = tone(e["tone_hz"], e["dur_s"], sr)
    env = at.SndEnv(cfg, sr, dtype=torch.float64, device=CPU)
    offline = env.process(env.pad(sig))
    online = at.OnlineSndEnv(cfg, sr, dtype=torch.float64, device=CPU)
    got, i = {}, 0
    for n in e["chunks"]:
        got.update(dict(online.feed(sig[i:i + n])))
        i += n
    assert i >= len(sig)
    got.update(dict(online.flush()))
    assert sorted(got) == list(range(offline.power_segment.shape[0]))
    for k, out in got.items():
        np.testing.assert_allclose(
            out.mel_fbank_segment.numpy(), offline.mel_fbank_segment[k].numpy(),
            atol=1e-9, rtol=0, err_msg=f"online{e['seed']} segment {k}")


def _segment_oracle(pipe, sig, start_ms, steps):
    """test_fuzzed_segment_pipeline's literal per-step oracle (goref
    building blocks): the mel segment and the energy."""
    wp, mel_params = pipe.wparams, pipe.mel
    n_bins, nf = pipe.win_samples // 2 + 1, mel_params.fbank.n_filters
    power, logpow = np.zeros(n_bins), np.zeros(n_bins)
    power_seg, logpow_seg = np.zeros((n_bins, steps)), np.zeros((n_bins, steps))
    fbank, mel_seg = np.zeros(nf), np.zeros((nf, steps))
    bin_pts, _, tri = goref.init_filters(mel_params.fbank, pipe.win_samples,
                                         pipe.sample_rate)
    start_sample = msec_to_samples(start_ms, pipe.sample_rate)
    for s in range(steps):
        st = start_sample + pipe.step_samples * (s - wp.border_steps)
        en = st + pipe.win_samples
        if en > len(sig):
            break
        window = np.concatenate([np.zeros(-st), sig[:en]]) if st < 0 else sig[st:en]
        goref.dft_filter(pipe.dft, s, window, pipe.win_samples, power, logpow,
                         power_seg, logpow_seg)
        goref.filter_dft(mel_params, s, power, mel_seg, fbank, tri, bin_pts)
    return mel_seg, logpow_seg[:steps, :].sum(axis=0)


@_cases("segment")
def test_fuzzed_segment_pipeline(e):
    sr, a, b = e["sample_rate"], e["start_ms"], e["end_ms"]
    jp = jseg.SegmentPipeline(
        sr, jseg.SegmentWindowParams(**e["wparams"]), mel=JMelParams(),
        gabor=from_dict(JGaborSet, e["gabor"]),
        kwta=JKWTAParams(on=False), dtype=jnp.float64, spectrum_method="fft")
    kw = dict(mel=at.MelParams(), gabor=e["gset"], kwta=at.KWTAParams(on=False),
              device=CPU)
    tp = at.SegmentPipeline(sr, e["wp"], dtype=torch.float64, **kw)
    sig = tone(e["tone_hz"], e["dur_s"], sr)
    start_ms, _, steps = tp.setup(a, b)
    assert (start_ms, steps) == jp.setup(a, b)[::2]
    out, jout = tp.process(sig, a, b), jp.process(sig, a, b)
    assert set(out) == set(jout)
    for key, got in out.items():
        if got is None:
            assert jout[key] is None, key
            continue
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jout[key]), err_msg=key,
            **(F64_GABOR if key.startswith("gabor") else F64))
    mel_seg, energy = _segment_oracle(tp, sig, start_ms, steps)
    np.testing.assert_allclose(out["mel_fbank_segment"].numpy(), mel_seg,
                               atol=1e-5, rtol=0, err_msg=f"segment{e['seed']}")
    np.testing.assert_allclose(out["energy"].numpy(), energy, atol=1e-6, rtol=1e-9)

    # float32 (the kernel's plain version on the CPU) within the model
    t32 = at.SegmentPipeline(sr, e["wp"], **kw)
    got = {k: v for k, v in t32.process(sig.astype(np.float32), a, b).items()
           if v is not None}
    ref = tp.process(sig.astype(np.float32).astype(np.float64), a, b)
    fb.hold(got, ref, fb.segment_bounds(tp, sig.astype(np.float32), a, b), tp,
            batch_ndim=0)


if __name__ == "__main__":
    with open(FUZZ_JSON, "w") as f:
        json.dump(draw_entries(), f, indent=1)
        f.write("\n")
    print(f"wrote {FUZZ_JSON}")
