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

The last two lines are a JSON list of the kernels with their launch counts,
errors and times, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
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

    cpu_env = at.SndEnv(flagship_cfg(at), SR, dtype=torch.float64)
    cpu_res, cpu_valid = cpu_env(torch.as_tensor(flag_sig[:8], dtype=torch.float64),
                                 torch.as_tensor(flag_len[:8]))
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

    print(json.dumps({"kernels": [{
        "name": "fused_frame_power_mel",
        "route": "cuda",
        "source": "auditory_tpu_torch/csrc/framefft.cu",
        "replaces": "auditory_tpu/ops/framefft.py:715",
        "launches": launches,
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
