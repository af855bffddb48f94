"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and the final
``{"ok": true, ...}`` line is never printed):

1. device  -- the card's name and power limit; the 'highest' precision tier
              switches TF32 off for both matmul and cuDNN convolution.
2. build   -- compile the fused frontend kernel (csrc/framefft.cu) from the
              checkout's sources.
3. kernel  -- the CUDA kernel against its plain PyTorch version on the card
              (float32, TF32 off) on six geometries: the flagship B=512 x 3 s
              16 kHz batch, 44.1 kHz, a Hamming window, an unpadded signal,
              mel-only output, and a mel bank with NaN triangles.
4. slice   -- a WAV written and read back with the port's io, then
              SndEnv.process and BatchedSndEnv.process (B=512 x 3 s, ragged
              lengths, every output, kWTA on) on the card; the kernel's
              launch count must rise; shapes, finiteness, the tone's mel
              band, agreement with the same run in float64 on the CPU at
              B=8, and the deltas equal to the delta operator applied to
              the run's own MFCC.
5. timing  -- kernel vs plain version at the flagship shapes, and the whole
              batch's real-time factor with kWTA on and off.
6. configs -- three more configurations at B=512 x 3 s, each held against
              itself in float64 on the CPU at B=8 and timed: (a) the 4-D
              pooled layout with neighbor inhibition and pool kWTA, whose
              path launches the kernel; (b) 22.05 kHz and (c) prev_smooth
              0.4 at 16 kHz, off the uniform window grid, where the window
              gather runs and the kernel must not launch.
7. corpus  -- 512 int16 WAVs of 2-4 s through CorpusRunner with its defaults
              (int16 upload, mel dedup, packed transfer, feature stats): the
              manifest, the kernel's launches per batch, 32 files against
              BatchedSndEnv.process, the stats' step count, resume; the
              float16 and int8 tiers on 64 files; the corpus RTF of run()
              and of iter_device_features.

The last three lines are a JSON list of the kernels with their launch counts
(phases 4, 6 and 7), errors and times, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

SR = 16000
BATCH = 512
SECONDS = 3.0
# tests/test_pallas.py:34-45 (power, log power, log mel)
KERNEL_BOUNDS = (dict(rtol=1e-5, atol=1e-4), dict(rtol=1e-5, atol=1e-5),
                 dict(rtol=1e-5, atol=1e-4))
# GPU float32 run vs the CPU float64 run of the whole slice:
# tests/test_pallas.py:34-56, and tests/test_batch_sharding.py:83 for kWTA
SLICE_BOUNDS = {
    "power_segment": dict(rtol=1e-5, atol=1e-4),
    "log_power_segment": dict(rtol=1e-5, atol=1e-5),
    "mel_fbank_segment": dict(rtol=1e-5, atol=1e-4),
    "energy": dict(rtol=1e-4, atol=2e-3),
    "mfcc_segment": dict(rtol=1e-4, atol=2e-3),
    "gabor_raw": dict(rtol=1e-4, atol=1e-3),
    "gabor_kwta": dict(rtol=0.0, atol=1e-4),
}
# The deltas are the linear delta operator M applied once and twice to the
# MFCC. M has row sums of |M| up to ~19, so the MFCC's float32 rounding
# (held above at the MFCC bound) reaches the delta-deltas amplified up to
# ~360-fold, and no bound of the MFCC's size can hold them against another
# float32 run. They are held instead to be M applied to the run's own input,
# within the float32 error bound of a dot product (see delta_stage_ratio).
DELTA_STAGES = (("mfcc_segment", "mfcc_deltas"),
                ("mfcc_deltas", "mfcc_delta_deltas"))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def flagship_cfg(at, kwta_on=True):
    cfg = at.SndEnvConfig(gabor=at.GaborSet(
        size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
        specs=at.default_gabor_specs(phases=(0.0, 1.5708)),
    ))
    return dataclasses.replace(
        cfg, kwta=dataclasses.replace(cfg.kwta, on=kwta_on)
    )


def bench_batch(rng, n, sr, batch):
    """bench.py's synthetic batch: speech-band tones + noise, true lengths
    0.8-1.0 of the buffer, zero past each true length."""
    t = np.arange(n) / sr
    base = 0.1 * np.sin(2 * np.pi * 180 * t) + 0.05 * np.sin(2 * np.pi * 1200 * t)
    sig = (base[None] + 0.02 * rng.standard_normal((batch, n))).astype(np.float32)
    lengths = rng.integers(int(0.8 * n), n + 1, size=batch).astype(np.int64)
    sig[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    return sig, lengths


def cuda_ms(fn, reps=10, warmup=3):
    """Median device time of one call (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def wall_ms(fn, reps=10, warmup=3):
    """Median wall time of one call ending in a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def compare(got, ref, bounds, label):
    """Max |got - ref| per output; raises outside ``bounds`` or when the NaN
    positions differ."""
    errs = []
    for name, g, r, b in zip(("power", "log_power", "log_mel"), got, ref, bounds):
        check((g is None) == (r is None), f"{label}: {name} emitted by one side only")
        if g is None:
            errs.append(0.0)
            continue
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        check(g.shape == r.shape, f"{label}: {name} shape {g.shape} != {r.shape}")
        check(np.array_equal(np.isnan(g), np.isnan(r)),
              f"{label}: {name} NaN positions differ")
        ok = np.isclose(g, r, equal_nan=True, **b)
        d = np.abs(g - r)
        d = d[~np.isnan(d)]
        errs.append(float(d.max()) if d.size else 0.0)
        check(ok.all(), f"{label}: {name} off by {errs[-1]} ({int((~ok).sum())} "
                        f"elements outside rtol={b['rtol']}, atol={b['atol']})")
    return errs


def delta_stage_ratio(env, res, src, dst):
    """Largest |dst - M src| / bound over the run ``res``, with the delta
    operator M applied in float64 on the host to the run's own ``src`` and the
    bound gamma_K |M| |src| (K = steps * n_coefs terms, gamma_K = K u / (1 - K u),
    u = 2^-24) that holds for a float32 dot product in any summation order.
    Above 1 the delta stage is wrong."""
    from auditory_tpu_torch.dsp.mel import delta_operator

    steps, n_coefs = env.timing.segment_steps, env.cfg.mel.n_coefs
    k = steps * n_coefs
    m = delta_operator(steps, n_coefs, 2, env.cfg.delta_mode)[0].reshape(k, k)
    gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
    # outputs are [.., n_coefs, steps]; the operator's layout is step-major
    flat = lambda f: (getattr(res, f).double().transpose(-1, -2).cpu().numpy()
                      .reshape(-1, k))
    x, y = flat(src), flat(dst)
    d = np.abs(y - x @ m.T)
    lim = gamma * (np.abs(x) @ np.abs(m).T)
    check(np.all(d <= lim), f"{dst} differs from the delta operator applied "
                            f"to {src}: max {float(d.max())}")
    return float(np.max(d / np.where(lim > 0, lim, 1.0)))


def hold_to_cpu_f64(at, env, res, seg_valid, sig, lengths):
    """The GPU float32 run ``res`` of ``env`` against the same configuration
    in float64 on the CPU on the batch's first 8 rows: equal validity, every
    SLICE_BOUNDS field within its bound, and each delta stage equal to the
    delta operator applied to its input. Returns the worst deviations."""
    cpu_env = at.SndEnv(env.cfg, env.sample_rate, dtype=torch.float64)
    cpu_res, cpu_valid = cpu_env(torch.as_tensor(sig[:8], dtype=torch.float64),
                                 torch.as_tensor(lengths[:8]))
    check(torch.equal(seg_valid[:8].cpu(), cpu_valid), "seg_valid differs from CPU")
    check(torch.equal(res.step_valid[:8].cpu(), cpu_res.step_valid),
          "step_valid differs from CPU")
    worst = {}
    for f, b in SLICE_BOUNDS.items():
        g = getattr(res, f)[:8].double().cpu().numpy()
        r = getattr(cpu_res, f).numpy()
        worst[f] = float(np.abs(g - r).max())
        ratio = float((np.abs(g - r) / (b["atol"] + b["rtol"] * np.abs(r))).max())
        check(ratio <= 1.0, f"{f}: GPU vs CPU off by {worst[f]} "
                            f"({ratio:.3g} of the bound)")
        worst[f] = f"{worst[f]:.3g} ({ratio:.2g} of bound)"
    for src, dst in DELTA_STAGES:
        worst[dst] = f"{delta_stage_ratio(env, res, src, dst):.2g} of bound"
    return worst


def write_corpus(corpus_dir, n, sr, rng):
    """``n`` int16 mono WAVs of uniform 2.0-4.0 s, like TIMIT utterances:
    tone mixes, harmonic series with a gliding pitch, and noise bursts over
    a weak tone, each with a little noise."""
    from auditory_tpu_torch.io.wav import float_to_wave, write_wav

    corpus_dir.mkdir(parents=True)
    paths = []
    for i in range(n):
        m = int(rng.uniform(2.0, 4.0) * sr)
        t = np.arange(m) / sr
        kind = i % 3
        if kind == 0:
            freqs = rng.uniform(150.0, 3500.0, size=3)
            sig = sum(0.15 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.3))
                      for f in freqs)
        elif kind == 1:
            f0 = rng.uniform(90.0, 250.0) * (1.0 + 0.1 * t / t[-1])
            phase_ = 2 * np.pi * np.cumsum(f0) / sr
            sig = sum(0.3 / k * np.sin(k * phase_) for k in range(1, 9))
        else:
            env_ = (np.sin(np.pi * t * rng.uniform(1.0, 4.0)) ** 2)
            sig = (0.2 * env_ * rng.standard_normal(m)
                   + 0.05 * np.sin(2 * np.pi * rng.uniform(300, 2000) * t))
        sig = np.clip(sig + 0.005 * rng.standard_normal(m), -1.0, 1.0)
        p = corpus_dir / f"utt{i:03d}.wav"
        write_wav(str(p), float_to_wave(sig, sr))
        paths.append(str(p))
    return paths


def folded_views(pb, host):
    """Per packed entry of ``pb`` (not the scales trailer): the unpacked
    ``host[key]`` in the entry's folded view [B, rows, *view_shape] (on -
    off for a folded on/off pair)."""
    out = {}
    for e in pb.entries:
        if e.key == "__qmeta__":
            continue
        v = host[e.key]
        v = v.reshape(v.shape[:2] + tuple(e.view_shape))
        if e.fold_ax is not None:
            on, off = np.split(v, 2, axis=2 + e.fold_ax)
            v = on - off
        out[e.key] = v
    return out


def int8_step_ratio(q, f):
    """The int8 PackedBatch ``q`` against the float32 PackedBatch ``f`` of
    the same batch: NaN positions equal, the symmetric (folded gabor) grid's
    exact zeros kept, every value inside its row-channel's quantization
    range, and every error within half its row-channel's quantization step
    (the scale in the buffer's trailer), both up to float32 rounding.
    Returns the largest error over half a step."""
    qh, fh = folded_views(q, q.unpack()), folded_views(f, f.unpack())
    host = q.data.cpu().numpy()
    scales = np.ascontiguousarray(host[:, host.shape[1] - q.entries[-1].cols:])
    scales = scales.view(np.float32)
    qoff, worst = 0, 0.0
    for e in q.entries[:-1]:
        a, r = qh[e.key], fh[e.key].astype(np.float32)
        s = scales[:, qoff:qoff + e.n_chan]
        o = scales[:, qoff + e.n_chan:qoff + 2 * e.n_chan]
        qoff += 2 * e.n_chan
        bshape = [a.shape[0]] + [1] * (a.ndim - 1)
        if e.qchan_ax is not None:
            bshape[2 + e.qchan_ax] = e.n_chan
        s, o = s.reshape(bshape), o.reshape(bshape)
        fin = np.isfinite(r)
        check(np.array_equal(np.isfinite(a), fin), f"int8 {e.key}: NaN positions")
        # float32 rounding of the scale and offset (the card divides by a
        # scalar as a multiply by its reciprocal) and of the dequantization
        slack = 8 * 2.0**-24 * (np.abs(r) + np.abs(o) + 127 * s)
        check(np.all(~fin | (np.abs(r - o) <= 127 * s + slack)),
              f"int8 {e.key}: a value outside its channel's range")
        err = np.where(fin, np.abs(a - r), 0.0)
        half = np.broadcast_to(s / 2, err.shape)
        check(np.all(err <= half + slack), f"int8 {e.key}: error beyond half a step")
        worst = max(worst, float(np.max(np.where(half > 0, err / half, 0.0))))
        if e.fold_ax is not None:
            check(np.all(a[r == 0] == 0), f"int8 {e.key}: fold zeros not kept")
    return worst


def configs_phase(at, dev, rng, name_limit, batch=BATCH):
    """Phase 6: the 4-D pooled layout, 22.05 kHz and prev_smooth at
    ``batch`` x 3 s on ``dev``, each held against float64 on the CPU and
    timed. Returns the kernel's launches on the kernel's path."""
    from auditory_tpu_torch.ops import framefft
    from auditory_tpu_torch.pipeline.batch import bucket_length

    base = flagship_cfg(at)
    configs = (
        # (label, config, rate, whether the path runs the kernel)
        ("4d_pooled_16k", dataclasses.replace(
            base, gbor_out_pools_y=8, gbor_out_pools_x=2, kwta_pool=True,
            neigh_inhib=dataclasses.replace(base.neigh_inhib, on=True)),
         SR, True),
        ("off_grid_22k05", base, 22050, False),
        ("prev_smooth_16k", dataclasses.replace(
            base, dft=dataclasses.replace(base.dft, prev_smooth=0.4)),
         SR, False),
    )
    launches_6 = 0
    for label, cfg, sr, on_grid in configs:
        env6 = at.SndEnv(cfg, sr, device=dev)
        n = bucket_length(int(SECONDS * sr), env6.timing)
        sig, lens = bench_batch(rng, n, sr, batch)
        sig_d = torch.as_tensor(sig, device=dev)
        len_d = torch.as_tensor(lens, device=dev)
        b6 = at.BatchedSndEnv(env6)
        framefft.LAUNCHES = 0
        res6, valid6 = b6.process(sig_d, len_d)
        torch.cuda.synchronize()
        count = framefft.LAUNCHES
        if on_grid:
            check(count >= 1, f"{label}: the kernel was launched {count} times")
            launches_6 += count
            why = f"{count} kernel launch(es)"
        else:
            t6 = env6.timing
            check(count == 0, f"{label}: the kernel was launched {count} times "
                              "off the uniform window grid")
            why = (f"0 kernel launches, as it must: stride {t6.stride_samples} "
                   f"and step {t6.step_samples} samples"
                   + (f", prev_smooth {cfg.dft.prev_smooth}"
                      if cfg.dft.prev_smooth else "")
                   + " give no shared window grid, and the JAX package has no "
                   "Pallas path there either (the window gather runs)")
        n_seg = env6.seg_cnt(n)
        check(tuple(res6.gabor_kwta.shape) == (batch, n_seg) + env6.gabor_output_shape(),
              f"{label}: gabor shape {tuple(res6.gabor_kwta.shape)}")
        for f in (*SLICE_BOUNDS, *(dst for _, dst in DELTA_STAGES)):
            check(bool(torch.isfinite(getattr(res6, f)).all()), f"{label}: {f} not finite")
        worst6 = hold_to_cpu_f64(at, env6, res6, valid6, sig, lens)
        ms = wall_ms(lambda: b6.process(sig_d, len_d))
        audio6 = float(lens.sum()) / sr
        phase(6, f"{label}: {why}; gabor {tuple(res6.gabor_kwta.shape)}; GPU "
                 "float32 vs CPU float64 (B=8) max abs: "
                 + ", ".join(f"{k} {v}" for k, v in worst6.items()))
        phase(6, f"[{name_limit}] {label} BatchedSndEnv.process B={batch} x "
                 f"{SECONDS:g} s at {sr} Hz, kWTA on: {ms:.3f} ms/batch, RTF "
                 f"{audio6 / (ms / 1e3):.1f} audio s per wall s (median of 10)")
        del res6, valid6, sig_d, len_d, b6, env6
    return launches_6


def corpus_phase(at, dev, name_limit, corpus_root, n_files=512):
    """Phase 7: ``n_files`` WAVs through CorpusRunner on ``dev`` with its
    defaults, then the float16 and int8 tiers on 64 of them, and the corpus
    RTFs. Returns the kernel's launches in the default run."""
    from auditory_tpu_torch.io.wav import load_wav
    from auditory_tpu_torch.ops import framefft
    from auditory_tpu_torch.pipeline.batch import bucket_length

    shutil.rmtree(corpus_root, ignore_errors=True)
    paths = write_corpus(corpus_root / "wavs", n_files, SR, np.random.default_rng(7))
    cfg7 = flagship_cfg(at)
    runner = at.CorpusRunner(cfg7, SR, device=dev)
    env7 = runner.env
    padded = {p: len(env7.pad(load_wav(p).sound_to_tensor(np.float32)))
              for p in paths}
    buckets = {}
    for p in paths:
        key = bucket_length(padded[p], env7.timing, quantum=SR)
        buckets[key] = buckets.get(key, 0) + 1
    n_batches = sum(-(-c // runner.batch_size) for c in buckets.values())
    out7 = str(corpus_root / "out")
    framefft.LAUNCHES = 0
    stats7 = runner.run(paths, out7)
    torch.cuda.synchronize()
    launches_7 = framefft.LAUNCHES
    check(launches_7 >= n_batches,
          f"corpus: {launches_7} kernel launches for {n_batches} batches")
    with open(corpus_root / "out" / "manifest.jsonl") as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == n_files and all(r["status"] == "ok" for r in recs),
          f"corpus manifest: {sum(r['status'] == 'ok' for r in recs)} ok of "
          f"{len(recs)} records")
    steps_valid = 0
    for p in paths:
        _, ends = env7.global_grid(padded[p])
        steps_valid += int((ends <= padded[p]).sum())
    with open(corpus_root / "out" / "feature_stats.json") as f:
        fstats = json.load(f)
    check(fstats["count_steps"] == steps_valid,
          f"feature_stats count_steps {fstats['count_steps']} != {steps_valid}")
    # 32 files against BatchedSndEnv.process, unpacked, on their float signals
    sample = sorted(np.random.default_rng(8).choice(n_files, min(32, n_files),
                                                    replace=False))
    benv7 = at.BatchedSndEnv(at.SndEnv(cfg7, SR, device=dev,
                                       outputs=("mel_fbank_segment", "gabor_kwta")))
    floats = [env7.pad(load_wav(paths[i]).sound_to_tensor(np.float32)) for i in sample]
    blen = max(bucket_length(len(s), env7.timing) for s in floats)
    batch7 = np.zeros((len(floats), blen), np.float32)
    for j, s in enumerate(floats):
        batch7[j, :len(s)] = s
    ref7, valid7 = benv7.process(batch7, np.array([len(s) for s in floats]))
    worst7 = {k: 0.0 for k in runner.save_keys}
    for j, i in enumerate(sample):
        n_seg = int(valid7[j].sum())
        with np.load(corpus_root / "out" / f"utt{i:03d}.npz") as z:
            for k in runner.save_keys:
                g, r = z[k], getattr(ref7, k)[j, :n_seg].double().cpu().numpy()
                check(g.shape == r.shape, f"corpus {k} shape {g.shape} != {r.shape}")
                b = SLICE_BOUNDS[k]
                ratio = float((np.abs(g - r) / (b["atol"] + b["rtol"] * np.abs(r))).max())
                check(ratio <= 1.0, f"corpus utt{i:03d} {k}: {ratio:.3g} of the bound")
                worst7[k] = max(worst7[k], ratio)
    again = at.CorpusRunner(cfg7, SR, device=dev).run(paths, out7)
    check(again.files_done == 0, f"resumed run did {again.files_done} files")
    phase(7, f"corpus ok: {n_files} files in {n_batches} batches, {launches_7} kernel "
             f"launches; count_steps {steps_valid}; {len(sample)} files vs "
             "BatchedSndEnv.process: "
             + ", ".join(f"{k} {v:.2g} of bound" for k, v in worst7.items())
             + "; resumed run did 0 files")
    # the float16 and int8 tiers on 64 files, against float32 on the same
    # batches
    tiers, pairs, few = {}, [], paths[:64]
    for td in (None, torch.float16, "int8"):
        tag = str(td).replace("torch.", "")
        tier = at.CorpusRunner(cfg7, SR, device=dev, transfer_dtype=td)
        if td == "int8":
            # each batch also packed in float32 on the card, to hold the int8
            # buffer against what the quantizer saw
            f32_pack = at.BatchedSndEnv(tier.env, pack_keys=tier.batched.pack_keys)
            real = tier.batched.process

            def both(signals, lengths, add_ms=0, divisors=None):
                res = real(signals, lengths, add_ms, divisors=divisors)
                ref = f32_pack.process(signals, lengths, add_ms, divisors=divisors)
                pairs.append((res[0], ref[0]))
                return res

            tier.batched.process = both
        done = tier.run(few, str(corpus_root / f"out_{tag}")).files_done
        check(done == len(few), f"{tag} corpus run did {done} files")
        tiers[tag] = {p: dict(np.load(corpus_root / f"out_{tag}" / f"utt{i:03d}.npz"))
                      for i, p in enumerate(few)}
    f16_worst = 0.0
    for p, ref in tiers["None"].items():
        for k, r in ref.items():
            g = tiers["float16"][p][k]
            check(g.dtype == np.float16 and g.shape == r.shape
                  and np.array_equal(np.isnan(g), np.isnan(r)), f"float16 {k}")
            err = np.nan_to_num(np.abs(g.astype(np.float64) - r))
            lim = 2.0**-11 * np.abs(r) + 2.0**-24
            check(np.all(err <= lim), f"float16 {k}: beyond float16 rounding")
            f16_worst = max(f16_worst, float((err / lim).max()))
            q = tiers["int8"][p][k]
            check(q.shape == r.shape and np.array_equal(np.isnan(q), np.isnan(r)),
                  f"int8 {k}: shape or NaN positions")
    int8_worst = max(int8_step_ratio(q, f) for q, f in pairs)
    phase(7, f"float16 within float16 rounding of float32 ({f16_worst:.2g} of "
             f"it); int8 within half a quantization step per row-channel "
             f"({int8_worst:.2g} of it; {len(pairs)} batches), NaN positions "
             "and fold zeros kept")
    # throughput: run() above, and the device-resident path over the same files
    true_s = sum(load_wav(p).num_frames for p in paths) / SR
    t0 = time.perf_counter()
    n_dev = 0
    for batch_paths, _, _, _ in runner.iter_device_features(paths):
        n_dev += len(batch_paths)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    check(n_dev == n_files, f"iter_device_features yielded {n_dev} files")
    phase(7, f"[{name_limit}] CorpusRunner.run over {n_files} files "
             f"({stats7.audio_seconds:.1f} s of audio): {stats7.wall_seconds:.3f} "
             f"s wall, RTF {stats7.rtf:.1f}; iter_device_features over the same "
             f"files: {dev_s:.3f} s wall, RTF {true_s / dev_s:.1f} audio s per "
             "wall s")
    return launches_7


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import auditory_tpu_torch as at
    from auditory_tpu_torch.convert import constants_from_numpy
    from auditory_tpu_torch.dsp import design
    from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav
    from auditory_tpu_torch.ops import _build, framefft
    from auditory_tpu_torch.pipeline.batch import bucket_length
    from auditory_tpu_torch.pipeline.sndenv import precision_tier

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # 1. device
    name_limit = card()
    phase(1, f"card: {name_limit}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}")
    with precision_tier("highest"):
        check(not torch.backends.cuda.matmul.allow_tf32
              and not torch.backends.cudnn.allow_tf32,
              "TF32 still on inside the 'highest' tier")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("framefft")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in Path(str(lib) + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    phase(2, f"built {lib.name} in {build_s:.2f} s; {'; '.join(ptxas)}")

    # 3. kernel against its plain version
    def geometry(sr, fbank=at.FilterBank(), window_fn=None):
        t = at.WindowParams().derive(sr)
        mel = design.mel_design(fbank, t.win_samples, sr)
        c = constants_from_numpy(
            mel.weights, np.eye(1), np.zeros((1, 1, 1)),
            *design.dft_matrices(t.win_samples),
            design.analysis_window(window_fn, t.win_samples),
        )
        consts = [torch.as_tensor(c[k], dtype=torch.float32, device=dev)
                  for k in ("dft_cos", "dft_sin", "mel_w")]
        return t, consts, fbank

    def kernel_args(t, consts, fbank, sig, emit=(True, True)):
        seg = t.seg_cnt(sig.shape[-1])
        n_windows = (seg - 1) * (t.stride_samples // t.step_samples) + t.segment_steps
        args = (torch.as_tensor(sig, device=dev), t.step_samples,
                t.step_offsets[0], n_windows, *consts)
        kw = dict(n_bins=t.n_bins, n_mel=fbank.n_filters, dft=at.DFTParams(),
                  fbank=fbank, emit=emit)
        return args, kw

    n16 = bucket_length(int(SECONDS * SR), at.WindowParams().derive(SR))
    flag_sig, flag_len = bench_batch(rng, n16, SR, BATCH)
    t44 = at.WindowParams().derive(44100)
    cases = {
        "flagship_16k_B512": (geometry(SR), flag_sig, (True, True)),
        "44k1_B32": (geometry(44100), bench_batch(
            rng, bucket_length(int(SECONDS * 44100), t44), 44100, 32)[0],
            (True, True)),
        "hamming_16k_B64": (geometry(SR, window_fn="hamming"), flag_sig[:64],
                            (True, True)),
        "unpadded_16k_B8": (geometry(SR), flag_sig[:8, :3472], (True, True)),
        "mel_only_16k_B512": (geometry(SR), flag_sig, (False, False)),
        "nan_mel_8k_B16": (
            geometry(8000, at.FilterBank(n_filters=80, lo_hz=0.0, hi_hz=4000.0)),
            bench_batch(rng, 24000, 8000, 16)[0], (True, True)),
    }
    errs = {"power": 0.0, "log_power": 0.0, "log_mel": 0.0}
    with precision_tier("highest"):
        for label, ((t, consts, fbank), sig, emit) in cases.items():
            args, kw = kernel_args(t, consts, fbank, sig, emit)
            got = framefft.fused_frame_power_mel(*args, **kw)
            torch.cuda.synchronize()
            ref = framefft.fused_frame_power_mel_reference(*args, **kw)
            e = compare(got, ref, KERNEL_BOUNDS, label)
            nans = int(torch.isnan(got[2]).sum())
            phase(3, f"{label}: max |kernel - plain| power {e[0]:.3g}, "
                     f"log_power {e[1]:.3g}, log_mel {e[2]:.3g}; NaN log_mel "
                     f"{nans} (identical positions)")
            for k, v in zip(errs, e):
                errs[k] = max(errs[k], v)

    # 4. the slice end to end, through the user's entry points
    env = at.SndEnv(flagship_cfg(at), SR, device=dev)
    benv = at.BatchedSndEnv(env)
    wav_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    wav_dir.mkdir(parents=True, exist_ok=True)
    tt = np.arange(int(SECONDS * SR)) / SR
    tone = 0.5 * np.sin(2 * np.pi * 2000.0 * tt) + 0.01 * rng.standard_normal(tt.shape)
    write_wav(str(wav_dir / "tone2000.wav"), float_to_wave(tone, SR))
    wave = load_wav(str(wav_dir / "tone2000.wav"))
    check(wave.sample_rate == SR and wave.num_frames == tt.shape[0],
          "WAV did not read back")

    framefft.LAUNCHES = 0
    one = env.process(env.pad(wave.sound_to_tensor()))
    res, seg_valid = benv.process(flag_sig, flag_len)
    torch.cuda.synchronize()
    launches = framefft.LAUNCHES
    check(launches >= 2, f"the slice launched the kernel {launches} times")

    mel0 = one.mel_fbank_segment[0].cpu().numpy()
    band = int(np.argmax(mel0.mean(axis=1)))
    check(env.mel_des.hz_pts[band] <= 2000 <= env.mel_des.hz_pts[band + 2],
          f"hottest mel band {band} does not bracket the 2 kHz tone")
    n_seg = env.seg_cnt(n16)
    steps = env.timing.segment_steps
    check(tuple(res.gabor_kwta.shape) == (BATCH, n_seg) + env.gabor_output_shape()
          and tuple(one.gabor_raw.shape[1:]) == env.gabor_output_shape(),
          f"gabor shape {tuple(res.gabor_kwta.shape)} vs "
          f"{env.gabor_output_shape()}")
    check(tuple(res.mel_fbank_segment.shape) == (BATCH, n_seg, 32, steps),
          f"mel shape {tuple(res.mel_fbank_segment.shape)}")
    for out in (one, res):
        for f in (*SLICE_BOUNDS, *(dst for _, dst in DELTA_STAGES)):
            check(bool(torch.isfinite(getattr(out, f)).all()), f"{f} not finite")

    worst = hold_to_cpu_f64(at, env, res, seg_valid, flag_sig, flag_len)
    phase(4, f"slice ok: {launches} kernel launches; WAV tone band {band} "
             f"({env.mel_des.hz_pts[band]:.0f}-{env.mel_des.hz_pts[band + 2]:.0f} Hz); "
             f"GPU float32 vs CPU float64 (B=8) max abs: "
             + ", ".join(f"{k} {v}" for k, v in worst.items()))

    # 5. times on the card
    with precision_tier("highest"):
        args, kw = kernel_args(*geometry(SR), flag_sig)
        kernel_ms = cuda_ms(lambda: framefft.fused_frame_power_mel(*args, **kw))
        plain_ms = cuda_ms(
            lambda: framefft.fused_frame_power_mel_reference(*args, **kw))
    phase(5, f"[{name_limit}] frontend at B={BATCH} x {SECONDS:g} s 16 kHz: "
             f"kernel {kernel_ms:.4f} ms, plain PyTorch {plain_ms:.4f} ms "
             f"(median of 10, CUDA events)")
    sig_d = torch.as_tensor(flag_sig, device=dev)
    len_d = torch.as_tensor(flag_len, device=dev)
    audio_s = float(flag_len.sum()) / SR
    for kwta_on in (True, False):
        b = at.BatchedSndEnv(at.SndEnv(flagship_cfg(at, kwta_on), SR, device=dev))
        ms = wall_ms(lambda: b.process(sig_d, len_d))
        phase(5, f"[{name_limit}] BatchedSndEnv.process B={BATCH} x "
                 f"{SECONDS:g} s, kWTA {'on' if kwta_on else 'off'}: "
                 f"{ms:.3f} ms/batch, RTF {audio_s / (ms / 1e3):.1f} "
                 f"audio s per wall s (median of 10)")

    # 6. the other configurations at B=512 x 3 s on the card
    launches_6 = configs_phase(at, dev, rng, name_limit)

    # 7. the corpus: CorpusRunner over 512 WAV files, with its defaults
    launches_7 = corpus_phase(at, dev, name_limit, wav_dir / "corpus")

    print(json.dumps({"kernels": [{
        "name": "fused_frame_power_mel",
        "route": "cuda",
        "source": "auditory_tpu_torch/csrc/framefft.cu",
        "replaces": "auditory_tpu/ops/framefft.py:715",
        "launches": launches + launches_6 + launches_7,
        "max_abs_err": errs["log_mel"],
        "max_abs_err_power": errs["power"],
        "max_abs_err_log_power": errs["log_power"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
