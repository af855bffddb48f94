"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and the final
``{"ok": true, ...}`` line is never printed):

1. device  -- the card's name and power limit; the 'highest' precision tier
              switches TF32 off for both matmul and cuDNN convolution.
2. build   -- compile the fused frontend kernel (csrc/framefft.cu) from the
              checkout's sources; ptxas's registers and spills, and the
              blocks' warpgroups, basis stages, piece ring and dynamic
              shared memory at B=64 and 512; the bytes of every layout the
              picker (ops/framefft.py::plan_layout) weighs at 7 rates equal
              to the library's framefft_shared_bytes (no layout depends on
              the mel bank), and the band table's size to the library's at
              7 mel banks; the native WAV decoder (csrc/auditory_io.cpp).
3. kernel  -- the CUDA kernel (passes=6, the exact grade) against its plain
              PyTorch version on the card in float64 on the same inputs,
              within the float32 error model's bound (see below), on
              bench_batch's tone rows: the flagship B=512 x 3 s 16 kHz
              batch, 44.1 kHz, a Hamming window, an unpadded signal,
              mel-only output, a mel bank with NaN triangles, the serving
              poll's (N=512 rows of 2480 samples, 14 windows each, offset
              0), which is also timed, the span in pieces (44.1 kHz with 32
              and 80 filters, 48 kHz with 64 and 128, 88.2 kHz with 64, 96
              kHz with 32 and 320), many filters (16 kHz with 256), a dense
              random bank of 320 filters (past the carry slots and the
              staged band table), a bank with an empty filter and a step of
              8 samples, each call launching the kernel once; the worst
              share of the bound per geometry, the plain version's float32
              run's beside it, and where a window sums more than 400 terms
              the plain version with TF32 on, which must fail the bound;
              44.1 kHz through the whole span and in pieces with two and
              with one warpgroup, bit for bit equal; rows with a NaN
              sample, an inf sample and an overflowing tone
              (nonfinite_phase): the plain version's NaN and inf positions;
              16 kHz with 256 filters and every piece geometry timed at
              B=64 and 512 x 3 s against its bound (the mel sum counted as
              the bank's nonzero weights), the plain version, one FP32
              torch.matmul of the frames and the whole function in plain
              calls on the frames; the per-segment route's geometry
              (22.05 kHz segment spans of 3 s rows, 14 windows a span from
              offset 0, B=64 and 512) held and timed the same way; the
              flagship, serving and per-segment geometries and two tone
              rows at 16 kHz and as 22.05 kHz spans at passes 3 and 1: the
              kernel within the bound
              of two sum orders of the plain version's limb emulation (the
              same products), each within the grade's bound of float64,
              and the grade visible (passes=1 outside the exact grade's
              bound in every output, passes=3 on the 16 kHz tone rows in
              power, log power and log mel, on the 22.05 kHz ones in power
              and log power); the prologue's
              basis limbs bit-equal to the plain packing and its band table
              to band_table.
4. slice   -- a WAV written and read back with the port's io, then
              SndEnv.process and BatchedSndEnv.process (B=512 x 3 s, ragged
              lengths, every output, kWTA on) on the card; the kernel's
              launch count must rise; shapes, finiteness, the tone's mel
              band, and every output within the model's bound of the same
              run in float64 on the CPU at B=8.
5. timing  -- the kernel at passes 1, 3 and 6 against its bound, the plain
              version, one FP32 torch.matmul of prebuilt frames by the
              basis and the whole function in plain calls on them, at the
              flagship and serving shapes; and the whole batch's real-time
              factor with kWTA on and off.
6. configs -- more configurations at B=512 x 3 s, kWTA on, each held
              against itself in float64 on the CPU at B=8 and timed: (a)
              the 4-D pooled layout with neighbor inhibition and pool kWTA,
              whose path launches the kernel; (b) 22.05 kHz and (c)
              prev_smooth 0.4 at 16 kHz, off the uniform window grid: under
              segment_frontend='auto' the window gather runs and the kernel
              must not launch, under 'per_segment' the route is
              "per_segment" and the kernel launches once a call on the
              segment spans; (b) and (c) timed again on both routes with
              kWTA off.
7. corpus  -- 512 int16 WAVs of 2-4 s through CorpusRunner with its defaults
              (int16 upload, mel dedup, packed transfer, feature stats): the
              manifest, the kernel's launches per batch, 32 files against
              BatchedSndEnv.process, the stats' step count, resume; the
              float16 and int8 tiers on 64 files; the corpus RTF of run()
              and of iter_device_features.
8. serving -- the flagship (kWTA on) with the serving outputs (mel, kWTA,
              step validity): (a) OnlineSndEnv over one 3 s stream in 100 ms
              chunks against SndEnv.process, its per-chunk latency, and a
              22.05 kHz stream (gather frontend, no kernel launch); (b)
              MultiStreamOnline over 512 streams of 2-3 s fed in 100 ms
              chunks, closed at their end and drained: every (stream,
              segment) emitted once and held against one offline
              BatchedSndEnv.process, one kernel launch per dispatched poll,
              poll times, RTF, packed bytes, and a profile=True pass; (c)
              pipeline depth 2, bit-equal to (b); (d) K=4 under 4x
              overload; (e) the float16 and int8 poll tiers.
9. stream  -- the processspeech StreamingProcessor over a stereo 3 s
              signal, every segment against the same processor in float64
              on the CPU; no kernel launch (a window gather and a matmul).
10. train  -- (a) the gradient w.r.t. the signals of a loss over power, log
              power and mel at the flagship batch, through the kernel and its
              autograd Function against the plain version's autograd, and
              both fwd+bwd times; (b) SndEnv forward + backward at B=512 x
              3 s, kWTA on (kernel launches, a finite nonzero gradient, time,
              peak memory), and a mel-loss gradient on 2 rows against the CPU
              float64 run; (c) the phone classifier (BatchedSndEnv features,
              200 MLP steps, test accuracy > 0.5) and (d) the learnable
              frontend (300 steps, loss < 0.7x, filter drift > 0.01) through
              their entry points; (e) SegmentPipeline over the phase-4 WAV and
              a [64, S] batch against CPU float64, and compare_segments; (f)
              FeatureDataset over phase 7's corpus, bit-equal to the npz files
              on the card.
11. routes -- SndEnv at 48 kHz with 64 filters, 88.2 kHz with 64 and 96 kHz
              (the signal span staged in pieces), and
              SegmentPipeline at 96 kHz, each launching the kernel once,
              against CPU float64 within the model's bound, and the window
              gather with TF32 on failing that bound as the control; 44.1
              kHz with 32 filters, and its
              frontend alone in the layout picked for B=64, the whole span
              and pieces with two warpgroups.
12. ranks  -- (a) process_local and gather_local_rows in a one-rank NCCL
              group at B=512 x 3 s against BatchedSndEnv.process; (b) two
              gloo ranks on the one card (256 rows each), then three (511
              rows); (c) a 60 s utterance's segments over two ranks; (d)
              run_distributed over phase 7's files against phase 7's run;
              (e) a rank whose run raises makes every rank raise; (f)
              MultiStreamOnline on a two-shard mesh against phase 8. The
              ranks are processes of this script (``--rank``), each with a
              time limit; a rank's failure fails the run.
13. native -- the native WAV decoder built and used; phase 7's corpus through
              run() with it and with io/wav; the CLI's process, corpus,
              corpus --coordinator, segment --compare and info as
              subprocesses on the card.
14. fuzz   -- the 40 configurations tests/test_fuzz_parity.py draws (read
              from tests/data/torch_fuzz_configs.json: 8, 16 and 22.05
              kHz, 5-12.5 ms steps, 16-25 ms windows, 24-40 filters, band
              edges, Hamming and Hann windows, prev_smooth, power-only, the
              ==0 log floors, the 4-D and byTime layouts): SndEnv at 8 rows
              of the entry's length plus a ragged row on 'auto' where the
              grid is uniform and 'per_segment' where it is not,
              OnlineSndEnv fed the entry's chunks, SegmentPipeline over 8
              rows, each launching the kernel and held against CPU float64;
              every kernel call held against the plain version in float64
              (passes 6) and against the limb emulation and its grade
              (passes 3); the worst share and the block layout by entry.
15. examples -- serve_streams at its defaults (16 streams, 2 s) in the
              float32 and float16 tiers, held against one offline run and
              the float32 tier; the median poll; process_speech on phase
              4's WAV (no kernel launch), its segments' hottest bands equal
              to its CPU run's.

Every float32 output is held to the float32 error model of
auditory_tpu_torch/utils/f32_bounds.py, the CPU tests' model with the same
constants: an elementwise bound on its distance from the float64 run of
the same inputs, and two float32 runs of the same inputs within the sum of
their bounds. A share (|error| / bound) above 1 fails the run.

The last three lines are a JSON list of the kernels with their launch counts
(phases 4, 6, 7, 8 and 10-15), errors, times, bounds and library times (and
by block layout: launches, and the times of phases 3 and 5), the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import typing
from pathlib import Path

import numpy as np
import torch

SR = 16000
BATCH = 512
SECONDS = 3.0
# the slice's float outputs (besides step_valid), held finite in phase 4
FLOAT_FIELDS = ("power_segment", "log_power_segment", "mel_fbank_segment",
                "energy", "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas",
                "gabor_raw", "gabor_kwta")
# what a serving poll returns (tools/bench_online.py::SERVING_OUTPUTS)
SERVING_KEYS = ("mel_fbank_segment", "gabor_kwta", "step_valid")
# the kernel's grades (JAX's pallas_passes); 6 is the default and exact one
PASSES = (6, 3, 1)
# the sample rates of the port's WindowParams and mel bank sizes users run:
# phase 2 holds the layout picker's Python mirror to the library on them
RATES = (8000, 16000, 32000, 44100, 48000, 88200, 96000)
LAYOUT_FILTERS = (32, 40, 64, 80, 128, 256)
# (rate, filters) timed in phase 3 at B=64 and 512: the geometries whose
# span the kernel stages in pieces, and the banks of many filters (16 kHz
# with 256 takes the whole span)
TIMED_GEOMETRIES = ((16000, 256), (44100, 80), (48000, 64), (48000, 128),
                    (88200, 64), (96000, 32), (96000, 320))
# the published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


# the kernel's launches on the main path by block layout (Layout.kind): the
# runs that count toward the kernels line's "launches", in this process and
# in the ranks of phase 12
MAIN_LAYOUT_LAUNCHES = {}


def reset_launches(framefft):
    """Set the kernel's launch counts (in all and by layout) to 0."""
    framefft.LAUNCHES = 0
    framefft.LAUNCHES_BY_LAYOUT.clear()


def add_layout_launches(counts):
    for kind, n in counts.items():
        MAIN_LAYOUT_LAUNCHES[kind] = MAIN_LAYOUT_LAUNCHES.get(kind, 0) + n


def main_launches(framefft):
    """The kernel's launches since reset_launches, a run of the main path:
    added by layout to MAIN_LAYOUT_LAUNCHES."""
    add_layout_launches(framefft.LAUNCHES_BY_LAYOUT)
    return framefft.LAUNCHES


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def forced_layout(framefft, layout):
    """Launch the kernel in ``layout`` inside the block, whatever the
    library would pick."""
    real = framefft.launch_shape
    framefft.launch_shape = lambda *args: layout
    try:
        yield
    finally:
        framefft.launch_shape = real


def picked_layout(framefft, args, win):
    """The block layout the wrapper launches for these kernel arguments."""
    sig, step, _, n_windows = args[:4]
    return framefft.launch_shape(step, win, n_windows, sig.shape[0],
                                 framefft.sm_count(sig.device))


def bit_equal(a, b):
    """Equal bits, NaN included."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)))


def grid_windows(t, n):
    """Windows a row of ``n`` samples holds on the uniform grid of the
    timing ``t`` (as SndEnv's whole-signal grid)."""
    return (t.seg_cnt(n) - 1) * (t.stride_samples // t.step_samples) + t.segment_steps


def flagship_cfg(at, kwta_on=True):
    cfg = at.SndEnvConfig(gabor=at.GaborSet(
        size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
        specs=at.default_gabor_specs(phases=(0.0, 1.5708)),
    ))
    return dataclasses.replace(
        cfg, kwta=dataclasses.replace(cfg.kwta, on=kwta_on)
    )


# the configurations tests/test_fuzz_parity.py's four families draw, as data
# (tests/test_torch_fuzz.py regenerates the file with the sampler and holds
# it equal)
FUZZ_JSON = Path(__file__).resolve().parent / "tests" / "data" / "torch_fuzz_configs.json"


def from_dict(cls, d):
    """The dataclass ``cls`` from its ``dataclasses.asdict`` ``d``: nested
    dataclasses by their fields' types, a tuple of them (GaborSet.specs)
    by its item type."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v, tp = d[f.name], hints[f.name]
        if dataclasses.is_dataclass(tp):
            v = from_dict(tp, v)
        elif typing.get_origin(tp) is tuple:
            item = typing.get_args(tp)[0]
            v = tuple(from_dict(item, x) if dataclasses.is_dataclass(item) else x
                      for x in v)
        kw[f.name] = v
    return cls(**kw)


def fuzz_entries(at):
    """The fuzz file's entries, each with its port objects: ``cfg`` (an
    SndEnvConfig) for the families "config", "layout" and "online";
    ``gset`` and ``wp`` (GaborSet, SegmentWindowParams) for "segment"."""
    entries = json.loads(FUZZ_JSON.read_text())
    for e in entries:
        if e["family"] == "segment":
            e["gset"] = from_dict(at.GaborSet, e["gabor"])
            e["wp"] = from_dict(at.SegmentWindowParams, e["wparams"])
        else:
            e["cfg"] = from_dict(at.SndEnvConfig, e["config"])
    return entries


def fuzz_tone(e):
    """The entry's signal: tests/conftest.py::tone at its frequency and
    length (amplitude 0.5, a 1e-4 dither seeded by frequency and rate)."""
    sr, n = e["sample_rate"], e["n_samples"]
    t = np.arange(n, dtype=np.float64) / sr
    r = np.random.default_rng(int(e["tone_hz"]) * 7919 + sr)
    return 0.5 * np.sin(2 * np.pi * e["tone_hz"] * t) + 1e-4 * r.standard_normal(n)


def bench_batch(rng, n, sr, batch):
    """bench.py's synthetic batch: speech-band tones + noise, true lengths
    0.8-1.0 of the buffer, zero past each true length."""
    t = np.arange(n) / sr
    base = 0.1 * np.sin(2 * np.pi * 180 * t) + 0.05 * np.sin(2 * np.pi * 1200 * t)
    sig = (base[None] + 0.02 * rng.standard_normal((batch, n))).astype(np.float32)
    lengths = rng.integers(int(0.8 * n), n + 1, size=batch).astype(np.int64)
    sig[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    return sig, lengths


def noise_batch(rng, n, batch):
    """White noise rows (0.3 RMS) with bench_batch's true lengths: the clean
    rows beside the non-finite ones of nonfinite_phase."""
    sig, lengths = bench_batch(rng, n, 16000, batch)
    sig = (0.3 * rng.standard_normal(sig.shape)).astype(np.float32)
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


def model_bounds(args, kw, power, passes=6, pair=False):
    """The float32 error model's (power, log power, log mel) bounds of the
    kernel's call ``args``/``kw`` at grade ``passes``, around the float64
    ``power`` of the same windows (f32_bounds.frontend_bounds; the analysis
    window read off the basis's bin-0 column, where it is folded in). With
    ``pair``: the bounds of two runs of that grade's products in other sum
    orders around each other, ``power`` one run's float32 power
    (f32_bounds.pair_frontend_bounds)."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    sig, step, offset0, n_windows, cos_b = args[:5]
    starts = offset0 + step * torch.arange(n_windows, device=sig.device)
    w = args[6][:kw["n_bins"], :kw["n_mel"]].double()
    bounds = fb.pair_frontend_bounds if pair else fb.frontend_bounds
    return bounds(sig, starts, cos_b.shape[0], power, w, dft=kw["dft"],
                  fbank=kw["fbank"], passes=passes, window_fn=cos_b[:, 0].double())


def frontend_model(framefft, args, kw, passes=6):
    """(the plain version in float64 on the same inputs, model_bounds at
    ``passes`` around it)."""
    ref = plain_f64(framefft, args, kw)
    power = ref[0] if ref[0] is not None else plain_f64(
        framefft, args, dict(kw, emit=(True, True)))[0]
    return ref, model_bounds(args, kw, power, passes)


def model_share(got, ref, bounds):
    """Largest share of the model's bound over the outputs both emit (inf
    where the NaN or inf positions differ)."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    worst = 0.0
    for g, r, b in zip(got, ref, bounds):
        if g is None or r is None:
            continue
        try:
            worst = max(worst, fb.share(g, r, b))
        except ValueError:
            return float("inf")
    return worst


def compare(got, ref, bounds, label):
    """Max |got - ref| per output, held within the model's ``bounds`` (their
    share at most 1, NaN and inf positions equal); returns (the max abs
    errors, the largest share)."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    errs, worst = [], 0.0
    for name, g, r, b in zip(("power", "log_power", "log_mel"), got, ref, bounds):
        check((g is None) == (r is None), f"{label}: {name} emitted by one side only")
        if g is None:
            errs.append(0.0)
            continue
        check(g.shape == r.shape, f"{label}: {name} shape {tuple(g.shape)} != "
                                  f"{tuple(r.shape)}")
        try:
            sh = fb.share(g, r, b)
        except ValueError as e:
            raise RuntimeError(f"chip_smoke: {label}: {name}: {e}") from None
        d = (g.double() - r.double()).abs()
        d = d[torch.isfinite(d)]
        errs.append(float(d.max()) if d.numel() else 0.0)
        check(sh <= 1.0, f"{label}: {name} at {sh:.3g} of its float32 bound (max "
                         f"|diff| {errs[-1]})")
        worst = max(worst, sh)
    return errs, worst


def mel_terms(mel_w, n_bins, n_mel):
    """The mel sum's terms a window: the bank's nonzero (or NaN) weights,
    what the banded sum needs (every other term adds +-0)."""
    return int((mel_w[:n_bins, :n_mel] != 0).sum())


def frontend_bound(b, s, n_windows, win, n_bins, n_mel, passes, emit, terms):
    """(ms, 'operations' or 'bytes'): the least time the card could take for
    one call: the DFT's ``passes`` bf16 products at the bf16 peak plus the
    mel sum's ``terms`` FMAs a window (mel_terms) at the FP32 peak, against
    the signal, the basis and mel weights read once and the outputs written
    once at the memory rate."""
    dft = passes * 2.0 * b * n_windows * win * 2 * n_bins
    mel = 2.0 * b * n_windows * terms
    ops_ms = 1e3 * (dft / PEAK_BF16 + mel / PEAK_FP32)
    nbytes = 4.0 * (b * s + 2 * win * n_bins + n_bins * n_mel
                    + b * n_windows * (n_bins * sum(emit) + n_mel))
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def library_times(args, kw):
    """(DFT alone, whole function) in ms of plain PyTorch calls on prebuilt
    frames (CUDA events, median of 10; call it with TF32 off): one FP32
    torch.matmul by the [win, 2 n_bins] basis; and that matmul, re^2 +
    im^2, the log power where emitted, the FP32 matmul by the mel weights
    and the log mel. The port calls neither."""
    from auditory_tpu_torch.dsp.dft import floored_log
    from auditory_tpu_torch.dsp.frame import extract_windows

    sig, step, off, nw, cos_b, sin_b, mel_w = args[:7]
    nb, dft, fbank = kw["n_bins"], kw["dft"], kw["fbank"]
    starts = off + step * torch.arange(nw, device=sig.device)
    frames = extract_windows(sig, starts, cos_b.shape[0]).reshape(-1, cos_b.shape[0])
    basis = torch.cat([cos_b[:, :nb], sin_b[:, :nb]], 1).contiguous()
    w = mel_w[:nb, :kw["n_mel"]].contiguous()

    def whole():
        y = torch.matmul(frames, basis)
        p = y[:, :nb] * y[:, :nb] + y[:, nb:] * y[:, nb:]
        logp = floored_log(p, dft.log_offset, dft.log_min) if kw["emit"][1] else None
        return p, logp, floored_log(torch.matmul(p, w), fbank.log_off, fbank.log_min)

    return cuda_ms(lambda: torch.matmul(frames, basis)), cuda_ms(whole)


def time_frontend(framefft, args, kw):
    """The kernel at ``passes`` 6 against its bound, its plain version and
    the library_times (call it with TF32 off), in ms (CUDA events, median
    of 10)."""
    sig, _, _, nw, cos_b, _, mel_w = args[:7]
    row = {"ms": cuda_ms(lambda: framefft.fused_frame_power_mel(*args, **kw)),
           "plain_ms": cuda_ms(
               lambda: framefft.fused_frame_power_mel_reference(*args, **kw))}
    row["bound_ms"], row["bound_by"] = frontend_bound(
        sig.shape[0], sig.shape[1], nw, cos_b.shape[0], kw["n_bins"], kw["n_mel"], 6,
        kw["emit"], mel_terms(mel_w, kw["n_bins"], kw["n_mel"]))
    row["library_ms"], row["library_function_ms"] = library_times(args, kw)
    return row


def per_segment_args(at, dev, t, consts, fbank, sig):
    """The kernel's arguments on SndEnv's per-segment route
    (``segment_frontend='per_segment'``, SndEnv._per_segment): each
    segment's span of the rows ``sig`` [B, S] one row of a contiguous
    [B * seg, span] tensor, ``segment_steps`` windows a row from offset 0."""
    from auditory_tpu_torch.dsp.dft import segment_spans

    span = (t.segment_steps - 1) * t.step_samples + t.win_samples
    rows = segment_spans(torch.as_tensor(sig, device=dev), t.stride_samples, span,
                         t.step_offsets[0], t.seg_cnt(sig.shape[-1]))
    args = (rows.reshape(-1, span).contiguous(), t.step_samples, 0, t.segment_steps,
            *consts)
    kw = dict(n_bins=t.n_bins, n_mel=fbank.n_filters, dft=at.DFTParams(), fbank=fbank,
              emit=(True, True))
    return args, kw


def band_table_equal(framefft, got, ref, n_bins, n_mel):
    """The card's band table against band_table's, on the words the kernel
    reads: each pass's header, entries and weights (the rest is left
    unwritten on the card)."""
    e_stride = framefft._table_strides(n_mel)[0]
    n_pass = -(-n_bins // framefft.BINS_PER_PASS)
    n_ent = n_pass * e_stride * 4
    ge, re = (t[:n_ent].view(n_pass, e_stride, 4) for t in (got, ref.to(got.device)))
    gw, rw = (t[n_ent:].view(n_pass, -1) for t in (got, ref.to(got.device)))
    return all(torch.equal(ge[q, :1 + int(re[q, 0, 0])], re[q, :1 + int(re[q, 0, 0])])
               and torch.equal(gw[q, :int(re[q, 0, 2])], rw[q, :int(re[q, 0, 2])])
               for q in range(n_pass))


def nonfinite_phase(framefft, geometry, kernel_args, rate_batch, dense_bank):
    """Rows that meet a non-finite power beside clean noise rows, at 16 kHz
    with 32 filters and with the dense random bank and at 96 kHz with 320
    filters, against the plain version on the card: a NaN sample, an inf
    sample and an overflowing tone (1e30 at 1234.5 Hz: finite samples, every
    bin of a window it reaches past float32). The kernel's mel has the NaN and inf
    positions of the plain version's float32 run (power @ W: a zero weight
    at an inf bin gives NaN), and every output is finite where that run's
    is. The power of a window that holds an
    inf sample is NaN in the kernel (the bf16 limb split leaves inf - inf,
    as JAX's _limb_dot does) where the plain version's is mostly inf, so
    only its finiteness is held there. The finite windows are held to the
    float32 error model's bound of the float64 run."""
    import auditory_tpu_torch as at

    for label, sr, fbank, weights in (
            ("16 kHz, 32 filters", SR, at.FilterBank(), None),
            ("16 kHz, dense random bank", SR, at.FilterBank(n_filters=320), dense_bank),
            ("96 kHz, 320 filters", 96000, at.FilterBank(n_filters=320), None)):
        t, consts, fb = geometry(sr, fbank, weights=weights)
        sig = rate_batch(sr, 8, noise=True)
        n = sig.shape[1]
        sig[0, n // 2] = np.nan
        sig[1, n // 3] = np.inf
        # (off every bin: a bin-centred tone leaves the other bins rounding
        # noise, whose square overflows in one sum order and not another)
        sig[2] = (1e30 * np.sin(2 * np.pi * 1234.5 * np.arange(n) / sr)).astype(np.float32)
        args, kw = kernel_args(t, consts, fb, sig)
        before = framefft.LAUNCHES
        got = framefft.fused_frame_power_mel(*args, **kw)
        torch.cuda.synchronize()
        check(framefft.LAUNCHES == before + 1, f"non-finite rows, {label}: no launch")
        plain = framefft.fused_frame_power_mel_reference(*args, **kw)
        starts = args[2] + args[1] * np.arange(args[3])
        # the windows that hold the inf sample
        inf_win = torch.zeros(plain[0].shape[:2], dtype=torch.bool, device=args[0].device)
        inf_win[1] = torch.as_tensor((starts <= n // 3) & (n // 3 < starts + t.win_samples))
        for name, g, r in zip(("power", "log power", "log mel"), got, plain):
            check(torch.equal(torch.isfinite(g), torch.isfinite(r)),
                  f"non-finite rows, {label}: {name} is finite elsewhere than the "
                  "plain version's")
            same = (~inf_win[..., None] if name != "log mel"
                    else torch.ones_like(g, dtype=torch.bool))
            for mask in (torch.isnan, torch.isinf):
                check(torch.equal(mask(g) & same, mask(r) & same),
                      f"non-finite rows, {label}: {name} {mask.__name__} positions "
                      "differ from the plain version's")
        check(bool(torch.isnan(got[0][inf_win]).all()),
              f"non-finite rows, {label}: the inf sample's windows are not NaN")
        clean = torch.isfinite(plain[0]).all(-1)
        ref, bounds = frontend_model(framefft, args, kw)
        sk = model_share(tuple(x[clean] for x in got), tuple(x[clean] for x in ref),
                         tuple(b[clean] for b in bounds))
        check(sk <= 1.0, f"non-finite rows, {label}: clean windows at {sk:.3g} of "
                         "their float32 bound")
        phase(3, f"non-finite rows, {label}: log mel NaN {int(torch.isnan(got[2]).sum())}, "
                 f"inf {int(torch.isinf(got[2]).sum())} at the plain version's positions; "
                 f"{int((~clean).sum())} of {clean.numel()} windows non-finite; the "
                 f"{int(clean.sum())} finite at {sk:.2g} of their float32 bound")


def device_kernels(framefft, args, kw):
    """The device kernels one call of the wrapper launches, by torch.profiler:
    the prologue and the kernel, two as before the band table (the table is
    built by the prologue's last block and its tensor is torch.empty), so
    a serving poll launches as many as before. Raises on another count;
    says so where the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        framefft.fused_frame_power_mel(*args, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    if not names:
        return "not measured (torch.profiler saw no device activity)"
    check(len(names) == 2, f"one call launched {len(names)} device kernels: {names}")
    short = [m.group(0) if (m := re.search(r"framefft_\w+(<[^>]*>)?", n)) else n
             for n in names]
    return f"2 device kernels ({', '.join(short)})"


def plain_f64(framefft, args, kw):
    """The plain version on the card in float64 on the float32 inputs: the
    exact grade's reference."""
    sig, step, offset0, n_windows, *consts = args
    return framefft.fused_frame_power_mel_reference(
        sig.double(), step, offset0, n_windows, *(c.double() for c in consts), **kw)


def f64_consts(at, env, dev):
    """``env``'s configuration with its constants in float64 on ``dev``:
    what the model's bounds read (f32_bounds.slice_bounds, on ``env``'s
    route). It runs no forward on the card, where the kernel takes float32
    only."""
    return at.SndEnv(env.cfg, env.sample_rate, dtype=torch.float64,
                     channels=env.channels, device=dev,
                     segment_frontend=env.segment_frontend)


def held(x, dev):
    """An output (tensor or array) as a tensor on ``dev``."""
    return torch.as_tensor(x).to(dev) if torch.is_tensor(x) else torch.as_tensor(
        np.asarray(x), device=dev)


def kwta_share(env64, run, batch_ndim):
    """A run's gabor_kwta (``run``: a mapping with it and gabor_raw, or the
    log mel) against the float64 settle of its own gabor_raw, or of the
    gabor stage of its own mel, as a share of the settle's bound."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    dev = env64.device
    raw = run.get("gabor_raw")
    raw = (held(raw, dev) if raw is not None
           else fb.gabor_reference(env64, held(run["mel_fbank_segment"], dev)))
    want = fb.settle_reference(env64, raw, batch_ndim)
    return fb.share(held(run["gabor_kwta"], dev), want,
                    torch.full_like(want, fb.settle_bound(env64.cfg.kwta, raw)))


def hold_pair(env64, a, b, bounds, label, batch_ndim=2):
    """Two float32 runs of the same inputs (mappings key -> array or
    tensor, the same keys) within the sum of their float32 bounds
    (``bounds``: f32_bounds.slice_bounds of those inputs, or the same
    selection of it): seg_valid and step_valid equal, gabor_kwta each by
    :func:`kwta_share`. Returns the worst share per key."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    dev = env64.device
    worst = {}
    for k in a:
        if k in ("seg_valid", "step_valid"):
            check(torch.equal(held(a[k], dev).bool(), held(b[k], dev).bool()),
                  f"{label}: {k} differs")
            continue
        if k == "gabor_kwta":
            sh = max(kwta_share(env64, run, batch_ndim) for run in (a, b))
        else:
            ga, gb = held(a[k], dev), held(b[k], dev)
            check(ga.shape == gb.shape, f"{label}: {k} shape {tuple(ga.shape)} != "
                                        f"{tuple(gb.shape)}")
            try:
                sh = fb.share(ga, gb, 2.0 * bounds[k])
            except ValueError as e:
                raise RuntimeError(f"chip_smoke: {label}: {k}: {e}") from None
        check(sh <= 1.0, f"{label}: {k} at {sh:.3g} of the sum of the float32 bounds")
        worst[k] = sh
    return worst


def hold_corpus_dirs(at, env, dev, paths, dir_a, dir_b, label, stats=None):
    """Two corpus runs' npz files (``dir_a``, ``dir_b``) of ``paths`` within
    the sum of their float32 bounds, file by file (hold_pair on each file's
    float signal, the kWTA through its own mel), and, with ``stats`` (the
    two runs' feature_stats dicts), their mel_mean and mel_std within the
    sum of f32_bounds.mean_std_bounds over every file's valid steps (read at
    the first run's values). Returns the worst share."""
    from auditory_tpu_torch.io.wav import load_wav
    from auditory_tpu_torch.utils import f32_bounds as fb

    env64 = f64_consts(at, env, dev)
    worst, bmel, mel = 0.0, [], []
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        sig = env.pad(load_wav(p).sound_to_tensor(np.float32))
        with np.load(Path(dir_a) / f"{stem}.npz") as a, \
                np.load(Path(dir_b) / f"{stem}.npz") as b:
            check(set(a.files) == set(b.files), f"{label}: {stem} keys")
            ga, gb = ({k: z[k][None] for k in z.files} for z in (a, b))
        bounds = fb.slice_bounds(env64, sig[None], [len(sig)])
        n_seg = ga["mel_fbank_segment"].shape[1]
        bounds = {k: v[:, :n_seg] for k, v in bounds.items() if k in ga}
        worst = max(worst, *hold_pair(env64, ga, gb, bounds, f"{label} {stem}").values())
        _, ends = env.global_grid(len(sig))
        steps = torch.as_tensor(ends[:n_seg] <= len(sig), device=dev).reshape(-1)
        flat = lambda x: torch.as_tensor(x, device=dev).double()[0].transpose(
            -1, -2).reshape(-1, x.shape[2])[steps]
        bmel.append(flat(bounds["mel_fbank_segment"]))
        mel.append(flat(ga["mel_fbank_segment"]))
    if stats is not None:
        bmel, mel = torch.cat(bmel), torch.cat(mel)
        b_mean, b_std = fb.mean_std_bounds(bmel, mel, torch.ones(
            mel.shape[0], dtype=torch.bool, device=dev))
        for key, b in (("mel_mean", b_mean), ("mel_std", b_std)):
            sa, sb = (torch.as_tensor(st[key], dtype=torch.float64, device=dev)
                      for st in stats)
            sh = fb.share(sa, sb, 2.0 * b)
            check(sh <= 1.0, f"{label}: {key} at {sh:.3g} of the sum of its bounds")
            worst = max(worst, sh)
    return worst


def hold_to_cpu_f64(at, env, res, seg_valid, sig, lengths):
    """:func:`cpu_f64_shares`, each output's as text."""
    return {f: f"{d:.3g} ({sh:.2g} of bound)"
            for f, (d, sh) in cpu_f64_shares(at, env, res, seg_valid, sig,
                                             lengths).items()}


def cpu_f64_shares(at, env, res, seg_valid, sig, lengths):
    """The GPU float32 run ``res`` of ``env`` against the same configuration
    in float64 on the CPU on the batch's first 8 rows: equal validity, and
    every output within the float32 error model's bound
    (f32_bounds.slice_bounds at the run's kernel grade on its route; gabor_kwta against
    the float64 settle of the run's own gabor_raw). Returns each output's
    (max abs difference, share of its bound)."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    cpu_env = at.SndEnv(env.cfg, env.sample_rate, dtype=torch.float64,
                        outputs=at.SndEnv.ALL_OUTPUTS, device="cpu",
                        segment_frontend=env.segment_frontend)
    sig8 = torch.as_tensor(sig[:8], dtype=torch.float64)
    len8 = torch.as_tensor(lengths[:8])
    cpu_res, cpu_valid = cpu_env(sig8, len8)
    check(torch.equal(seg_valid[:8].cpu(), cpu_valid), "seg_valid differs from CPU")
    bounds = fb.slice_bounds(cpu_env, sig8, len8, passes=env.kernel_passes)
    got = {f: getattr(res, f)[:8].cpu() for f in (*FLOAT_FIELDS, "step_valid")
           if getattr(res, f) is not None}
    try:
        shares = fb.hold(got, cpu_res, bounds, cpu_env)
    except AssertionError as e:
        raise RuntimeError(f"chip_smoke: GPU float32 vs CPU float64: {e}") from None
    worst = {}
    for f, sh in shares.items():
        d = (got[f].double() - getattr(cpu_res, f)).abs()
        d = d[torch.isfinite(d)]
        worst[f] = (float(d.max()) if d.numel() else 0.0, sh)
    return worst


def synth_utterance(rng, kind, m, sr):
    """``m`` samples of one of three speech-band mixes (``kind`` 0-2): tone
    mixes, a harmonic series with a gliding pitch, and noise bursts over a
    weak tone, each with a little noise, in [-1, 1]."""
    t = np.arange(m) / sr
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
    return np.clip(sig + 0.005 * rng.standard_normal(m), -1.0, 1.0)


def write_corpus(corpus_dir, n, sr, rng):
    """``n`` int16 mono WAVs of uniform 2.0-4.0 s, like TIMIT utterances
    (:func:`synth_utterance`)."""
    from auditory_tpu_torch.io.wav import float_to_wave, write_wav

    corpus_dir.mkdir(parents=True)
    paths = []
    for i in range(n):
        m = int(rng.uniform(2.0, 4.0) * sr)
        sig = synth_utterance(rng, i % 3, m, sr)
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
    ``batch`` x 3 s on ``dev``, kWTA on, each held against float64 on the
    CPU and timed. 22.05 kHz and prev_smooth run on both routes off the
    uniform grid: 'auto' (the window gather, no launch) and 'per_segment'
    (one launch a call on the segment spans); both are timed again with
    kWTA off. Returns the kernel's launches on the kernel's paths."""
    from auditory_tpu_torch.ops import framefft
    from auditory_tpu_torch.pipeline.batch import bucket_length

    base = flagship_cfg(at)
    smooth = dataclasses.replace(base, dft=dataclasses.replace(base.dft, prev_smooth=0.4))
    configs = (
        # (label, config, rate, segment_frontend, the route it must take)
        ("4d_pooled_16k", dataclasses.replace(
            base, gbor_out_pools_y=8, gbor_out_pools_x=2, kwta_pool=True,
            neigh_inhib=dataclasses.replace(base.neigh_inhib, on=True)),
         SR, "auto", "kernel"),
        ("off_grid_22k05", base, 22050, "auto", "gather"),
        ("prev_smooth_16k", smooth, SR, "auto", "gather"),
        ("off_grid_22k05_per_segment", base, 22050, "per_segment", "per_segment"),
        ("prev_smooth_16k_per_segment", smooth, SR, "per_segment", "per_segment"),
    )
    # one batch a rate and configuration, the same for both routes
    batches = {}
    launches_6 = 0
    for label, cfg, sr, frontend, route in configs:
        env6 = at.SndEnv(cfg, sr, device=dev, segment_frontend=frontend)
        t6 = env6.timing
        n = bucket_length(int(SECONDS * sr), t6)
        check(env6.route(n) == route, f"{label}: route {env6.route(n)}, not {route}")
        key = label.removesuffix("_per_segment")
        if key not in batches:
            batches[key] = bench_batch(rng, n, sr, batch)
        sig, lens = batches[key]
        sig_d = torch.as_tensor(sig, device=dev)
        len_d = torch.as_tensor(lens, device=dev)
        b6 = at.BatchedSndEnv(env6)
        reset_launches(framefft)
        res6, valid6 = b6.process(sig_d, len_d)
        torch.cuda.synchronize()
        count = main_launches(framefft)
        n_seg = env6.seg_cnt(n)
        if route == "kernel":
            check(count >= 1, f"{label}: the kernel was launched {count} times")
            launches_6 += count
            why = f"{count} kernel launch(es)"
        elif route == "per_segment":
            check(count == 1, f"{label}: the kernel was launched {count} times in one "
                              "call, not once")
            launches_6 += count
            span = (t6.segment_steps - 1) * t6.step_samples + t6.win_samples
            lay = framefft.launch_shape(t6.step_samples, t6.win_samples,
                                        t6.segment_steps, batch * n_seg,
                                        framefft.sm_count(sig_d.device))
            why = (f"route per_segment, 1 kernel launch on {batch * n_seg} segment "
                   f"spans of {span} samples, {t6.segment_steps} windows a span from "
                   f"offset 0 (layout {tuple(lay[:4])}, {lay.kind})")
        else:
            check(count == 0, f"{label}: the kernel was launched {count} times "
                              "off the uniform window grid under 'auto'")
            why = (f"route gather, 0 kernel launches, as it must under 'auto': stride "
                   f"{t6.stride_samples} and step {t6.step_samples} samples"
                   + (f", prev_smooth {cfg.dft.prev_smooth}"
                      if cfg.dft.prev_smooth else "")
                   + " give no shared window grid (the window gather runs)")
        check(tuple(res6.gabor_kwta.shape) == (batch, n_seg) + env6.gabor_output_shape(),
              f"{label}: gabor shape {tuple(res6.gabor_kwta.shape)}")
        for f in FLOAT_FIELDS:
            check(bool(torch.isfinite(getattr(res6, f)).all()), f"{label}: {f} not finite")
        worst6 = hold_to_cpu_f64(at, env6, res6, valid6, sig, lens)
        gabor_shape = tuple(res6.gabor_kwta.shape)
        del res6, valid6
        ms = wall_ms(lambda: b6.process(sig_d, len_d))
        audio6 = float(lens.sum()) / sr
        phase(6, f"{label}: {why}; gabor {gabor_shape}; GPU float32 vs CPU float64 "
                 "(B=8) max abs: " + ", ".join(f"{k} {v}" for k, v in worst6.items()))
        phase(6, f"[{name_limit}] {label} BatchedSndEnv.process B={batch} x "
                 f"{SECONDS:g} s at {sr} Hz, kWTA on: {ms:.3f} ms/batch, RTF "
                 f"{audio6 / (ms / 1e3):.1f} audio s per wall s (median of 10)")
        del sig_d, len_d, b6, env6
    # both routes off the grid with kWTA off, where the settle (most of a
    # batch with kWTA on) does not hide the frontends' difference
    for key, cfg, sr in (("off_grid_22k05", base, 22050), ("prev_smooth_16k", smooth, SR)):
        sig, lens = batches[key]
        sig_d = torch.as_tensor(sig, device=dev)
        len_d = torch.as_tensor(lens, device=dev)
        off = dataclasses.replace(cfg, kwta=dataclasses.replace(cfg.kwta, on=False))
        ms = {}
        for frontend in ("auto", "per_segment", "per_segment", "auto"):
            b6 = at.BatchedSndEnv(at.SndEnv(off, sr, device=dev,
                                            segment_frontend=frontend))
            ms.setdefault(frontend, []).append(wall_ms(lambda: b6.process(sig_d, len_d)))
        phase(6, f"[{name_limit}] {key} BatchedSndEnv.process B={batch} x {SECONDS:g} s "
                 f"at {sr} Hz, kWTA off (runs in the order gather, per_segment, "
                 f"per_segment, gather; median of 10 each): gather "
                 f"{ms['auto'][0]:.3f} / {ms['auto'][1]:.3f} ms/batch, per_segment "
                 f"{ms['per_segment'][0]:.3f} / {ms['per_segment'][1]:.3f} ms/batch")
        del sig_d, len_d, b6
    return launches_6


def corpus_phase(at, dev, name_limit, corpus_root, n_files=512):
    """Phase 7: ``n_files`` WAVs through CorpusRunner on ``dev`` with its
    defaults, then the float16 and int8 tiers on 64 of them, and the corpus
    RTFs. Returns the kernel's launches in the default run."""
    from auditory_tpu_torch.io.wav import load_wav
    from auditory_tpu_torch.ops import framefft
    from auditory_tpu_torch.pipeline.batch import bucket_length
    from auditory_tpu_torch.utils import f32_bounds as fb

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
    reset_launches(framefft)
    stats7 = runner.run(paths, out7)
    torch.cuda.synchronize()
    launches_7 = main_launches(framefft)
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
    len7 = np.array([len(s) for s in floats])
    ref7, valid7 = benv7.process(batch7, len7)
    env64 = f64_consts(at, env7, dev)
    bounds7 = fb.slice_bounds(env64, batch7, len7)
    worst7 = {k: 0.0 for k in runner.save_keys}
    for j, i in enumerate(sample):
        n_seg = int(valid7[j].sum())
        with np.load(corpus_root / "out" / f"utt{i:03d}.npz") as z:
            got = {k: z[k][None] for k in runner.save_keys}
        want = {k: getattr(ref7, k)[j:j + 1, :n_seg] for k in runner.save_keys}
        # the npz keeps no gabor_raw: each kWTA is held through its own mel
        w = hold_pair(env64, got, want,
                      {k: b[j:j + 1, :n_seg] for k, b in bounds7.items()},
                      f"corpus utt{i:03d}")
        for k, v in w.items():
            worst7[k] = max(worst7[k], v)
    again = at.CorpusRunner(cfg7, SR, device=dev).run(paths, out7)
    check(again.files_done == 0, f"resumed run did {again.files_done} files")
    phase(7, f"corpus ok: {n_files} files in {n_batches} batches, {launches_7} kernel "
             f"launches; count_steps {steps_valid}; {len(sample)} files vs "
             "BatchedSndEnv.process within the sum of their float32 bounds: "
             + ", ".join(f"{k} {v:.2g} of it" for k, v in worst7.items())
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
    return launches_7, stats7


def pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


def serve(ms, streams, chunk, per_poll=1):
    """Drive ``ms`` like a serving loop: every tick, feed each open stream
    ``per_poll`` chunks of ``chunk`` samples (closing it when its audio
    ends), then poll once; at the end, drain. Returns the results
    {(stream, seg_idx): {key: array}}, the wall ms of each poll that
    emitted, the number of polls that dispatched a device call, and the
    wall seconds from the first feed to the end of the drain."""
    got, poll_ms, dispatched = {}, [], 0
    cursors = [0] * len(streams)
    live = set(range(len(streams)))
    t_start = time.perf_counter()
    while True:
        for i in sorted(live):
            for _ in range(per_poll):
                ms.feed(i, streams[i][cursors[i]:cursors[i] + chunk])
                cursors[i] += chunk
                if cursors[i] >= len(streams[i]):
                    ms.close(i)
                    live.discard(i)
                    break
        # poll() dispatches a call exactly when some stream is ready
        dispatched += int(ms._ready_streams().size > 0)
        t0 = time.perf_counter()
        res = ms.poll()
        dt = 1e3 * (time.perf_counter() - t0)
        if res:
            poll_ms.append(dt)
        for i, k, out in res:
            check((i, k) not in got, f"segment {(i, k)} emitted twice")
            got[(i, k)] = out
        if not live and not res and not ms._inflight and ms._ready_streams().size == 0:
            break
    return got, poll_ms, dispatched, time.perf_counter() - t_start


def stack_segments(got, keys):
    """{(i, k): {key: array}} -> (stream index, segment index, {key: [n,
    ...]}) in sorted order."""
    order = sorted(got)
    ii = np.array([i for i, _ in order])
    kk = np.array([k for _, k in order])
    return ii, kk, {key: np.stack([got[o][key] for o in order]) for key in keys}


def hold_segments(env64, got, ref, bmel, label):
    """Serving results ``got`` (stacked segments [n, ...], host) against the
    reference ``ref`` (same layout, float32) within the sum of their
    float32 bounds (``bmel``: the mel's, stacked the same way; gabor_kwta
    each through its own mel, hold_pair). Returns (worst share of the
    mel's, max |mel diff|, max |kWTA diff|, whether mel is bit-equal)."""
    w = hold_pair(env64, got, ref, {"mel_fbank_segment": bmel}, label, batch_ndim=1)
    g = got["mel_fbank_segment"].astype(np.float64)
    r = ref["mel_fbank_segment"].astype(np.float64)
    d = np.nan_to_num(np.abs(g - r))
    gk = np.abs(got["gabor_kwta"].astype(np.float64) - ref["gabor_kwta"])
    bit = bool(np.array_equal(g, r, equal_nan=True))
    return w["mel_fbank_segment"], float(d.max()), float(gk.max()), bit


def stacked_bounds(env64, signals, lengths, ii=None, kk=None):
    """The mel's float32 bound (f32_bounds.slice_bounds) of a batch [B, seg,
    n_mel, steps], or of its (stream ``ii``, segment ``kk``) rows stacked."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    b = fb.slice_bounds(env64, signals, lengths)["mel_fbank_segment"]
    return b[0] if ii is None else b[torch.as_tensor(ii), torch.as_tensor(kk)]


def serving_streams(n, sr, rng):
    """``n`` float32 streams of uniform 2-3 s (:func:`synth_utterance`)."""
    return [synth_utterance(rng, i % 3, int(rng.uniform(2.0, 3.0) * sr), sr)
            .astype(np.float32) for i in range(n)]


def packed_bytes(ms):
    """Bytes of one poll's packed host copy."""
    cols = max(hi for _, _, hi, _, _ in ms._layout.values())
    item = {None: 4, torch.float16: 2, torch.int8: 1}[ms.transfer_dtype]
    return ms.n_streams * cols * item


def f16_share(g, base, label):
    """A float16 poll tier's array ``g`` against the float32 tier's
    ``base``: float16, the same NaN positions, and within float16 rounding
    (2^-11 |x| + 2^-24) of it. Returns the largest share of that bound."""
    r = base.astype(np.float64)
    fin = np.isfinite(r)
    check(g.dtype == np.float16 and np.array_equal(np.isfinite(g), fin),
          f"{label}: dtype or NaN positions")
    err = np.where(fin, np.abs(g.astype(np.float64) - r), 0.0)
    lim = 2.0**-11 * np.abs(np.where(fin, r, 0.0)) + 2.0**-24
    check(np.all(err <= lim), f"{label}: beyond float16 rounding")
    return float((err / lim).max())


def serving_phase(at, dev, name_limit, n_streams=512, single_s=3.0):
    """Phase 8: the serving path. (a) OnlineSndEnv over one stream against
    the offline run, per-chunk latency, and a 22.05 kHz stream; (b)
    MultiStreamOnline over ``n_streams`` 2-3 s streams fed in 100 ms chunks,
    against one offline BatchedSndEnv run; (c) pipeline depth 2, bit-equal
    to (b); (d) K=4 under 4x overload; (e) the float16 and int8 poll tiers.
    Returns the kernel's launches in the serving runs."""
    from auditory_tpu_torch.ops import framefft

    cfg = flagship_cfg(at)
    keys = SERVING_KEYS
    chunk = SR // 10
    rng = np.random.default_rng(11)
    launches = 0

    # (a) one stream through OnlineSndEnv, against the offline run
    env = at.SndEnv(cfg, SR, outputs=keys, device=dev)
    sig = synth_utterance(rng, 1, int(single_s * SR), SR).astype(np.float32)
    online = at.OnlineSndEnv(cfg, SR, outputs=keys, device=dev)
    got, lat = {}, []
    reset_launches(framefft)
    for c in range(0, len(sig), chunk):
        t0 = time.perf_counter()
        for k, out in online.feed(sig[c:c + chunk]):
            got[k] = out
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
    for k, out in online.flush():
        got[k] = out
    torch.cuda.synchronize()
    count = main_launches(framefft)
    check(count == len(got), f"OnlineSndEnv: {count} kernel launches for "
                             f"{len(got)} segments")
    launches += count
    off = env.process(env.pad(sig))
    n_off = off.mel_fbank_segment.shape[0]
    check(sorted(got) == list(range(n_off)),
          f"OnlineSndEnv emitted {len(got)} segments, offline {n_off}")
    host = lambda t: t.double().cpu().numpy()
    one = {key: np.stack([host(getattr(got[k], key)) for k in range(n_off)])
           for key in keys}
    ref = {key: host(getattr(off, key)) for key in keys}
    env64 = f64_consts(at, env, dev)
    padded = env.pad(sig)
    ratio, dmel, dk, bit = hold_segments(
        env64, one, ref, stacked_bounds(env64, padded[None], [len(padded)]),
        "OnlineSndEnv 16 kHz")
    steady = lat[10:]
    phase(8, f"OnlineSndEnv 16 kHz, {single_s:g} s in {chunk}-sample chunks: "
             f"{len(got)} segments = offline, {count} kernel launches; vs "
             f"SndEnv.process: mel max abs {dmel:.3g} ({ratio:.2g} of the sum of float32 bounds, "
             f"{'bit-equal' if bit else 'not bit-equal'}), gabor_kwta max abs "
             f"{dk:.3g}, step_valid equal")
    phase(8, f"[{name_limit}] OnlineSndEnv per-chunk latency (feed + emit + "
             f"synchronize, {len(steady)} chunks after 10 warm-up): p50 "
             f"{pct(steady, 50):.3f} ms, p90 {pct(steady, 90):.3f} ms")
    sr2 = 22050
    sig2 = synth_utterance(rng, 0, sr2, sr2).astype(np.float32)
    online2 = at.OnlineSndEnv(cfg, sr2, outputs=keys, device=dev)
    reset_launches(framefft)
    got2 = {}
    for c in range(0, len(sig2), sr2 // 10):
        got2.update(dict(online2.feed(sig2[c:c + sr2 // 10])))
    got2.update(dict(online2.flush()))
    torch.cuda.synchronize()
    check(framefft.LAUNCHES == 0, f"22.05 kHz online: {framefft.LAUNCHES} "
                                  "kernel launches off the uniform grid")
    env2 = at.SndEnv(cfg, sr2, outputs=keys, device=dev)
    off2 = env2.process(env2.pad(sig2))
    n2 = off2.mel_fbank_segment.shape[0]
    check(sorted(got2) == list(range(n2)), f"22.05 kHz: {len(got2)} segments, "
                                           f"offline {n2}")
    env2_64 = f64_consts(at, env2, dev)
    padded2 = env2.pad(sig2)
    r2, dmel2, dk2, _ = hold_segments(
        env2_64, {key: np.stack([host(getattr(got2[k], key)) for k in range(n2)])
                  for key in keys},
        {key: host(getattr(off2, key)) for key in keys},
        stacked_bounds(env2_64, padded2[None], [len(padded2)]),
        "OnlineSndEnv 22.05 kHz")
    phase(8, f"OnlineSndEnv 22.05 kHz, 1 s: {n2} segments = offline, 0 kernel "
             f"launches (gather frontend); mel max abs {dmel2:.3g} ({r2:.2g} of the sum of "
             f"float32 bounds), gabor_kwta max abs {dk2:.3g}")

    # (b) N streams, float32, K=1, D=1, against one offline batch
    streams = serving_streams(n_streams, SR, rng)
    audio_s = sum(len(s) for s in streams) / SR
    padded = [env.pad(s) for s in streams]
    counts = [env.seg_cnt(len(p)) for p in padded]
    blen = max(len(p) for p in padded)
    batch = np.zeros((n_streams, blen), np.float32)
    for i, p in enumerate(padded):
        batch[i, :len(p)] = p
    lengths = np.array([len(p) for p in padded])
    ref_out, _ = at.BatchedSndEnv(env).process(batch, lengths)
    ref_host = {key: getattr(ref_out, key).cpu().numpy() for key in keys}
    del ref_out

    def run(label, **kw):
        nonlocal launches
        ms = at.MultiStreamOnline(cfg, SR, n_streams=n_streams, outputs=keys,
                                  device=dev, **kw)
        per_poll = kw.get("max_segments_per_poll", 1)
        reset_launches(framefft)
        res, poll_ms, dispatched, wall = serve(ms, streams, chunk, per_poll)
        torch.cuda.synchronize()
        count = main_launches(framefft)
        check(count == dispatched, f"{label}: {count} kernel launches for "
                                   f"{dispatched} dispatched polls")
        launches += count
        emitted = {}
        for i, _ in res:
            emitted[i] = emitted.get(i, 0) + 1
        check(all(emitted.get(i, 0) == c for i, c in enumerate(counts))
              and all((i, k) in res for i, c in enumerate(counts) for k in range(c)),
              f"{label}: not every (stream, segment) was emitted once")
        ii, kk, stacked = stack_segments(res, keys)
        steady = poll_ms[3:]
        n_seg = len(res)
        phase(8, f"[{name_limit}] {label}: {dispatched} polls, {count} kernel "
                 f"launches, {n_seg} segments; poll wall p50 {pct(steady, 50):.3f} "
                 f"ms, p90 {pct(steady, 90):.3f} ms over {len(steady)} steady "
                 f"polls that emitted; {1e3 * wall / n_seg:.4f} ms per segment; "
                 f"RTF {audio_s / wall:.1f} audio s per wall s; "
                 f"{packed_bytes(ms)} packed bytes per poll")
        return ms, stacked, (ii, kk)

    _, base, (ii, kk) = run("MultiStreamOnline N=%d float32 K=1 D=1" % n_streams)
    ref_seg = {key: ref_host[key][ii, kk] for key in keys}
    bmel = stacked_bounds(env64, batch, lengths, ii, kk)
    ratio_b, dmel_b, dk_b, bit_b = hold_segments(env64, base, ref_seg, bmel,
                                                 "serving vs offline")
    phase(8, f"every (stream, segment) emitted once, {len(ii)} in all; vs one "
             f"offline BatchedSndEnv.process: mel max abs {dmel_b:.3g} "
             f"({ratio_b:.2g} of the sum of float32 bounds, {'bit-equal' if bit_b else 'not bit-equal'}), "
             f"gabor_kwta max abs {dk_b:.3g}, step_valid equal")
    ms_p, _, _ = run("profile=True pass", profile=True)
    phase(8, "poll phases p50 (ms, profile=True): " + ", ".join(
        f"{k} {1e3 * pct(v, 50):.3f}" for k, v in ms_p.poll_phases.items()))

    # (c) pipeline depth 2: the same program at the same shapes
    _, d2, _ = run("MultiStreamOnline D=2", pipeline_depth=2)
    check(all(np.array_equal(d2[k], base[k], equal_nan=True) for k in keys),
          "D=2 results differ from D=1")
    phase(8, "D=2 results equal D=1 bit for bit")

    # (d) K=4 under 4x overload
    _, k4, _ = run("MultiStreamOnline K=4, 4 chunks per stream per poll",
                   max_segments_per_poll=4)
    r4, dmel4, dk4, _ = hold_segments(env64, k4, base, bmel, "K=4 vs K=1")
    phase(8, f"K=4 vs K=1: mel max abs {dmel4:.3g} ({r4:.2g} of the sum of float32 bounds), "
             f"gabor_kwta max abs {dk4:.3g}")

    # (e) the float16 and int8 poll tiers against the float32 poll
    _, f16, _ = run("float16 tier", transfer_dtype=torch.float16)
    _, q8, _ = run("int8 tier", transfer_dtype="int8")
    check(np.array_equal(f16["step_valid"], base["step_valid"])
          and np.array_equal(q8["step_valid"], base["step_valid"]),
          "tier step_valid differs")
    f16_worst = q8_worst = 0.0
    for key in ("mel_fbank_segment", "gabor_kwta"):
        r = base[key].astype(np.float64)
        fin = np.isfinite(r)
        f16_worst = max(f16_worst, f16_share(f16[key], base[key], f"float16 {key}"))
        q = q8[key].astype(np.float64)
        check(np.array_equal(np.isfinite(q), fin), f"int8 {key}: NaN positions")
        # K=1: each (stream, segment, channel) is quantized over its own
        # range; channels are axis 0 of the per-segment view
        rf = np.where(fin, r, np.nan)
        axes = tuple(range(2, r.ndim))
        step = (np.nanmax(rf, axis=axes, keepdims=True)
                - np.nanmin(rf, axis=axes, keepdims=True)) / 254.0
        step = np.nan_to_num(step)
        rz = np.where(fin, r, 0.0)
        slack = 8 * 2.0**-24 * (np.abs(rz) + np.abs(rz).max() + 127 * step)
        err = np.where(fin, np.abs(q - r), 0.0)
        half = np.broadcast_to(step / 2, err.shape)
        check(np.all(err <= half + slack), f"int8 {key}: error beyond half a step")
        share = np.divide(err, half, out=np.zeros_like(err), where=half > 0)
        q8_worst = max(q8_worst, float(share.max()))
    phase(8, f"float16 within float16 rounding of float32 ({f16_worst:.2g} of "
             f"it); int8 within half a quantization step per stream, segment and "
             f"channel ({q8_worst:.2g} of it), NaN positions kept")
    return launches, streams, (base, bmel)


def streaming_phase(at, dev, name_limit, seconds=3.0):
    """Phase 9: the processspeech StreamingProcessor over a stereo signal on
    ``dev``, every segment against the same processor in float64 on the
    CPU within the float32 error model's bound; the frontend kernel must
    not launch (the path is a window gather and a matmul, as in the JAX
    package)."""
    from auditory_tpu_torch.ops import framefft
    from auditory_tpu_torch.utils import f32_bounds as fb

    cfg = flagship_cfg(at)
    rng = np.random.default_rng(13)
    m = int(seconds * SR)
    sig = np.stack([synth_utterance(rng, 0, m, SR),
                    synth_utterance(rng, 1, m, SR)]).astype(np.float32)
    args = (cfg.params, cfg.dft, cfg.mel, cfg.gabor, SR)
    sp = at.StreamingProcessor(*args, channels=2, device=dev)
    sp64 = at.StreamingProcessor(*args, channels=2, dtype=torch.float64,
                                 device="cpu")
    sp.load(sig)
    sp64.load(sig)
    outs, times = [], []
    reset_launches(framefft)
    while sp.more_segments:
        t0 = time.perf_counter()
        outs.append(sp.process_segment())
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    check(framefft.LAUNCHES == 0,
          f"StreamingProcessor launched the kernel {framefft.LAUNCHES} times")
    refs = []
    while sp64.more_segments:
        refs.append(sp64.process_segment())
    check(len(outs) == len(refs) >= 2,
          f"StreamingProcessor: {len(outs)} segments, CPU float64 {len(refs)}")
    keys = ("power_segment", "log_power_segment", "mel_fbank_segment",
            "mfcc_segment", "gabor")
    worst = {k: 0.0 for k in keys}
    for seg, (g, r) in enumerate(zip(outs, refs)):
        check(torch.equal(g["step_valid"].cpu(), r["step_valid"]),
              "StreamingProcessor step_valid differs from CPU")
        bounds = fb.stream_bounds(sp64, seg)
        for key in keys:
            check(tuple(g[key].shape) == tuple(r[key].shape),
                  f"{key} shape {tuple(g[key].shape)} != {tuple(r[key].shape)}")
            ratio = fb.share(g[key].cpu(), r[key], bounds[key])
            check(ratio <= 1.0, f"StreamingProcessor {key}: {ratio:.3g} of the bound")
            worst[key] = max(worst[key], ratio)
    phase(9, f"StreamingProcessor stereo {seconds:g} s: {len(outs)} segments, "
             f"gabor {tuple(outs[0]['gabor'].shape)}, 0 kernel launches; GPU "
             "float32 vs CPU float64: "
             + ", ".join(f"{k} {v:.2g} of its float32 bound" for k, v in worst.items()))
    steady = times[3:]
    phase(9, f"[{name_limit}] StreamingProcessor: {pct(steady, 50):.3f} ms per "
             f"segment (p50 of {len(steady)} after 3 warm-up, synchronized)")


# Phase 10 bounds. The kernel path (kernel forward + the Function's
# backward) and the plain version's autograd compute the same float32
# gradient with different sum orders (the overlap-add against autograd's
# index_put accumulation, cuBLAS tilings): a few float32 ulps of sums of at
# most 3 windows x 2 x 201 terms, far below 1e-4 of the largest gradient.
GRAD_KERNEL_BOUND = 1e-4
# The GPU float32 gradient of a mel-only loss against the CPU float64 run,
# relative to the largest gradient: the mel loss's gradient carries
# 1/melsum, so a quiet band's float32 melsum (relative error up to ~1e-4,
# the cancellation tests/test_torch_segments.py bounds) reaches it.
MEL_GRAD_BOUND = 1e-3


def kernel_grad_phase(framefft, args, kw, name_limit):
    """Phase 10a: the gradient w.r.t. the signals of a loss over power, log
    power and mel, through the kernel (its forward and the Function's
    backward) and through the plain version's autograd, on the card at the
    flagship shapes. Returns (max relative error, kernel ms, plain ms); the
    launches here are comparison launches and are not counted."""
    sig = args[0]
    gen = torch.Generator(device=sig.device).manual_seed(10)
    with torch.no_grad():
        p_scale = float(framefft.fused_frame_power_mel_reference(*args, **kw)[0].mean())
    shapes = (kw["n_bins"], kw["n_bins"], kw["n_mel"])
    cot = [torch.randn((sig.shape[0], args[3], k), generator=gen,
                       device=sig.device) for k in shapes]
    cot[0] /= p_scale  # power is O(p_scale); log power and mel are O(1)

    def grad_of(fn):
        s = sig.detach().requires_grad_()
        loss = sum((o * c).sum() for o, c in zip(fn(s, *args[1:], **kw), cot))
        return torch.autograd.grad(loss, s)[0]

    before = framefft.LAUNCHES
    g_kernel = grad_of(framefft.fused_frame_power_mel)
    torch.cuda.synchronize()
    check(framefft.LAUNCHES == before + 1, "the kernel path did not launch the kernel")
    g_plain = grad_of(framefft.fused_frame_power_mel_reference)
    check(bool(torch.isfinite(g_kernel).all()), "kernel-path gradient not finite")
    scale = float(g_plain.abs().max())
    err = float((g_kernel - g_plain).abs().max()) / scale
    check(scale > 0 and err <= GRAD_KERNEL_BOUND,
          f"kernel-path gradient off the plain version's by {err:.3g} of its "
          f"max (bound {GRAD_KERNEL_BOUND})")
    ms = cuda_ms(lambda: grad_of(framefft.fused_frame_power_mel))
    plain = cuda_ms(lambda: grad_of(framefft.fused_frame_power_mel_reference))
    b, n = sig.shape
    phase(10, f"10a kernel backward at B={b} x {n} samples: max |kernel path - "
              f"plain autograd| {err:.3g} of max |grad| (bound "
              f"{GRAD_KERNEL_BOUND}); loss over power, log power and mel")
    phase(10, f"[{name_limit}] 10a frontend forward + backward: kernel + "
              f"Function backward {ms:.4f} ms, plain PyTorch autograd "
              f"{plain:.4f} ms (median of 10, CUDA events)")
    return err, ms, plain


def sndenv_grad_phase(at, framefft, dev, name_limit, sig, lengths):
    """Phase 10b: SndEnv forward + backward at the flagship (kWTA on) on the
    batch ``sig``: a finite, nonzero gradient w.r.t. the signals through the
    kernel, its time and peak memory; and the float32 gradient of a
    mel-only loss on 2 rows against the CPU float64 run. Returns the
    kernel's launches on the path."""
    from auditory_tpu_torch.pipeline.sndenv import precision_tier

    cfg = flagship_cfg(at)
    env = at.SndEnv(cfg, SR, device=dev)
    sig_d = torch.as_tensor(sig, device=dev)
    len_d = torch.as_tensor(lengths, device=dev)

    def grad(e, rows, lens, mel_only=False):
        s = rows.detach().requires_grad_()
        out, _ = e(s, lens)
        loss = (out.mel_fbank_segment ** 2).sum() if mel_only else (
            (out.mel_fbank_segment ** 2).mean() + (out.gabor_kwta ** 2).mean())
        with precision_tier(e.matmul_precision):
            return torch.autograd.grad(loss, s)[0]

    reset_launches(framefft)
    torch.cuda.reset_peak_memory_stats()
    g = grad(env, sig_d, len_d)
    g32 = grad(env, sig_d[:2], len_d[:2], mel_only=True)
    torch.cuda.synchronize()
    launches = main_launches(framefft)
    peak = torch.cuda.max_memory_allocated()
    check(launches >= 2, f"SndEnv backward path launched the kernel {launches} times")
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
          "SndEnv gradient not finite or all zero")
    env64 = at.SndEnv(cfg, SR, dtype=torch.float64, device="cpu")
    g64 = grad(env64, torch.as_tensor(sig[:2], dtype=torch.float64),
               torch.as_tensor(lengths[:2]), mel_only=True)
    err = float((g32.double().cpu() - g64).abs().max() / g64.abs().max())
    check(err <= MEL_GRAD_BOUND, f"mel-loss gradient GPU float32 vs CPU float64 "
                                 f"off by {err:.3g} of its max (bound {MEL_GRAD_BOUND})")
    ms = wall_ms(lambda: grad(env, sig_d, len_d), reps=5, warmup=1)
    b = sig.shape[0]
    phase(10, f"10b SndEnv forward + backward B={b} x {SECONDS:g} s, kWTA on: "
              f"{launches} kernel launches, gradient finite and nonzero; mel-loss "
              f"gradient GPU float32 vs CPU float64 (2 rows): {err:.3g} of max "
              f"|grad| (bound {MEL_GRAD_BOUND})")
    phase(10, f"[{name_limit}] 10b SndEnv forward + backward B={b} x {SECONDS:g} s: "
              f"{ms:.3f} ms (median of 5, synchronized); peak memory "
              f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    return launches


def trainers_phase(framefft, dev, name_limit, steps=(200, 300), n_per_class=40):
    """Phases 10c-d: the phone classifier (features through BatchedSndEnv,
    then ``steps[0]`` MLP steps) and the learnable frontend (``steps[1]``
    steps) on ``dev`` through their entry points. Returns the kernel's
    launches in both."""
    from auditory_tpu_torch.examples import learnable_frontend, train_phone_classifier

    common = ["--device", dev.type, "--n-per-class", str(n_per_class)]
    reset_launches(framefft)
    res = train_phone_classifier.main(common + ["--steps", str(steps[0])])
    torch.cuda.synchronize()
    launches_c = main_launches(framefft)
    check(launches_c >= 1, f"classifier features launched the kernel {launches_c} times")
    check(res["acc"] > 0.5, f"classifier test accuracy {res['acc']:.3f}")
    phase(10, f"10c phone classifier: {launches_c} kernel launch(es) for the "
              f"features, final test accuracy {res['acc']:.3f} (> 0.5), loss "
              f"{res['first_loss']:.4f} -> {res['last_loss']:.4f}")
    phase(10, f"[{name_limit}] 10c classifier: {res['ms_per_step']:.3f} ms per "
              f"training step ({steps[0]} steps, evaluation every 50 included)")
    reset_launches(framefft)
    res = learnable_frontend.main(common + ["--steps", str(steps[1])])
    torch.cuda.synchronize()
    launches_f = main_launches(framefft)
    check(launches_f >= 1, f"frontend mel features launched the kernel {launches_f} times")
    check(res["last_loss"] < 0.7 * res["first_loss"],
          f"learnable frontend loss {res['first_loss']:.4f} -> {res['last_loss']:.4f}")
    check(res["drift"] > 0.01, f"filter drift {res['drift']:.4f}")
    phase(10, f"10d learnable frontend: {launches_f} kernel launch(es) for the "
              f"mel, loss {res['first_loss']:.4f} -> {res['last_loss']:.4f} (< 0.7x), "
              f"filter drift {res['drift']:.4f}, test accuracy {res['acc']:.3f}")
    phase(10, f"[{name_limit}] 10d learnable frontend: {res['ms_per_step']:.3f} ms "
              f"per training step ({steps[1]} steps)")
    return launches_c + launches_f


def segments_phase(at, framefft, dev, name_limit, wave, sig, batch=64):
    """Phase 10e: SegmentPipeline over the WAV ``wave`` (three slices, the
    last one past its end) and a [B, S] batch of ``sig`` rows on ``dev``,
    each against the CPU float64 run; compare_segments once. Returns the
    kernel's launches."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    pipe = at.SegmentPipeline(SR, device=dev)
    pipe64 = at.SegmentPipeline(SR, dtype=torch.float64, device="cpu")
    x = wave.sound_to_tensor()
    end_ms = 1e3 * len(x) / SR
    slices = ((120.0, 260.0), (1500.0, 1730.0), (end_ms - 150.0, end_ms - 10.0))
    rows = sig[:batch]
    reset_launches(framefft)
    outs = [pipe.process(x, a, b) for a, b in slices]
    out_b = pipe.process(rows, 100.0, 400.0)
    torch.cuda.synchronize()
    launches = main_launches(framefft)
    check(launches == len(slices) + 1,
          f"SegmentPipeline: {launches} kernel launches for {len(slices) + 1} calls")
    worst, masked = 0.0, 0
    runs = [(o, x, a, b, slice(None)) for o, (a, b) in zip(outs, slices)]
    runs.append((out_b, rows[:2].astype(np.float64), 100.0, 400.0, slice(0, 2)))
    for got, signal, a, b, sel in runs:
        ref = pipe64.process(signal, a, b)
        check(torch.equal(got["step_valid"].cpu(), ref["step_valid"]),
              "SegmentPipeline step_valid differs from CPU")
        for k in ("gabor_kwta", "mfcc_segment", "power_segment"):
            check(tuple(got[k][sel].shape) == tuple(ref[k].shape), f"{k} shape")
            check(bool(torch.isfinite(got[k]).all()), f"SegmentPipeline {k} not finite")
        mine = {k: (v if k == "step_valid" else v[sel]).cpu()
                for k, v in got.items() if v is not None}
        try:
            shares = fb.hold(mine, ref, fb.segment_bounds(pipe64, signal, a, b),
                             pipe64, batch_ndim=np.asarray(signal).ndim - 1)
        except AssertionError as e:
            raise RuntimeError(f"chip_smoke: SegmentPipeline vs CPU float64: {e}") from None
        worst = max(worst, *shares.values())
        masked += int((~got["step_valid"]).sum())
    check(masked > 0, "no slice overran the signal")
    check(tuple(out_b["gabor_kwta"].shape[:1]) == (rows.shape[0],), "batch axis lost")
    pipe_b = at.SegmentPipeline(SR, gabor=at.GaborSet(
        size_x=8, size_y=8, stride_x=3, stride_y=3, gain=2.0,
        specs=at.default_gabor_specs(phases=(0.0, 1.5708))), device=dev)
    res = at.compare_segments(pipe, pipe_b, x, *slices[0])
    d = res["diff"]
    check(d["power_segment"]["max_abs_diff"] == 0.0,
          "compare_segments: equal windows gave different power")
    check(d["gabor_kwta"]["a"]["shape"] != d["gabor_kwta"]["b"]["shape"],
          "compare_segments: the two gabor stacks gave one shape")
    ms = wall_ms(lambda: pipe.process(x, *slices[0]))
    phase(10, f"10e SegmentPipeline: {launches} kernel launches for "
              f"{len(slices)} WAV slices and a [{rows.shape[0]}, {rows.shape[1]}] "
              f"batch; GPU float32 vs CPU float64, every output, at {worst:.3g} of "
              f"its float32 bound, {masked} masked steps; compare_segments: power "
              f"equal, gabor_kwta {d['gabor_kwta']['a']['shape']} vs "
              f"{d['gabor_kwta']['b']['shape']}")
    phase(10, f"[{name_limit}] 10e SegmentPipeline.process of one slice: "
              f"{ms:.3f} ms (median of 10, synchronized)")
    return launches


def dataset_phase(at, dev, corpus_out):
    """Phase 10f: FeatureDataset over a CorpusRunner output directory:
    every batch on ``dev``, equal to the npz contents bit for bit, and the
    normalized mel equal to the host formula."""
    ds = at.FeatureDataset(str(corpus_out))
    seen = 0
    for b in ds.batches(64, seed=0, device=dev):
        for i, stem in enumerate(b["stem"]):
            n = int(b["n_seg"][i])
            raw = ds.load(stem)
            for k in ds.keys:
                check(b[k].device.type == dev.type, f"{k} not on {dev}")
                got = b[k][i].cpu().numpy()
                check(np.array_equal(got[:n], raw[k], equal_nan=True)
                      and not got[n:].any(), f"dataset {stem} {k} differs from npz")
            seen += 1
    check(seen == len(ds), f"dataset yielded {seen} of {len(ds)} files")
    mean, std = ds.normalizer()
    b = next(ds.batches(16, seed=1, normalize=True, device=dev))
    for i, stem in enumerate(b["stem"]):
        n = int(b["n_seg"][i])
        raw = ds.load(stem)["mel_fbank_segment"].astype(np.float32)
        want = (raw - mean[:, None]) / std[:, None]
        check(np.array_equal(b["mel_fbank_segment"][i, :n].cpu().numpy(), want,
                             equal_nan=True), f"normalized mel of {stem}")
    phase(10, f"10f FeatureDataset: {seen} files in batches of 64 on {dev}, "
              f"every key equal to its npz bit for bit; normalized mel equal "
              f"to the host formula")



# ---------------------------------------------------------------------------
# Phase 11: the frontend's route
# ---------------------------------------------------------------------------

def kernel_route_args(env, sig_d):
    """The fused kernel's arguments for ``env``'s uniform grid over the
    batch ``sig_d`` (what ``SndEnv.forward`` passes it)."""
    t = env.timing
    offset0, n_flat = env._grid_for(sig_d.shape[-1], 0)[:2]
    args = (sig_d, t.step_samples, offset0, n_flat, env.dft_cos, env.dft_sin,
            env.mel_w)
    kw = dict(n_bins=t.n_bins, n_mel=env.cfg.mel.fbank.n_filters, dft=env.cfg.dft,
              fbank=env.cfg.mel.fbank, emit=(True, True), passes=6)
    return args, kw


def tf32_gather_control(at, env, sig, lens):
    """The control for the model's bound: ``env`` with its frontend replaced
    by the window gather (the kernel's plain version) run with TF32 on, held
    to CPU float64 within the float32 error model's bound. It must fail
    there, on power or log power; returns the failure."""
    import auditory_tpu_torch.pipeline.sndenv as sndenv_mod
    from auditory_tpu_torch.ops import framefft

    def tf32_gather(*args, **kw):
        with framefft.tf32_flags((True, True)):
            return framefft.fused_frame_power_mel_reference(*args, **kw)

    real = sndenv_mod.fused_frame_power_mel
    sndenv_mod.fused_frame_power_mel = tf32_gather
    try:
        res, valid = env(torch.as_tensor(sig[:8], device=env.device),
                         torch.as_tensor(lens[:8], device=env.device))
    finally:
        sndenv_mod.fused_frame_power_mel = real
    try:
        hold_to_cpu_f64(at, env, res, valid, sig, lens)
    except RuntimeError as e:
        msg = str(e)
        check(msg.startswith(("chip_smoke: GPU float32 vs CPU float64: power_segment",
                              "chip_smoke: GPU float32 vs CPU float64: log_power_segment")),
              f"the TF32 control failed for another reason: {msg}")
        return msg[len("chip_smoke: "):]
    raise RuntimeError("chip_smoke: the TF32 gather passed the float32 bound: it "
                       "cannot tell float32 from TF32")


def routes_phase(at, framefft, dev, name_limit, rng, batch=64):
    """Phase 11: SndEnv where the kernel stages the signal span in pieces
    (48 kHz with 64 filters, 88.2 kHz with 64, 96 kHz with 32), each on the
    kernel route with one launch, held against CPU float64 and timed
    against the kernel's plain version (the window gather); the control for
    the float32 bound (the gather with TF32 on fails it); SegmentPipeline at
    96 kHz; 44.1 kHz with 32 filters. Returns the kernel's launches."""
    from auditory_tpu_torch.pipeline.batch import bucket_length
    from auditory_tpu_torch.pipeline.sndenv import precision_tier
    from auditory_tpu_torch.utils import f32_bounds as fb

    def with_mel(cfg, n_mel):
        return dataclasses.replace(cfg, mel=dataclasses.replace(
            cfg.mel, fbank=dataclasses.replace(cfg.mel.fbank, n_filters=n_mel)))

    launches = 0
    for sr, n_mel in ((48000, 64), (96000, 32), (88200, 64)):
        env = at.SndEnv(with_mel(flagship_cfg(at), n_mel), sr, device=dev)
        t = env.timing
        blen = bucket_length(int(SECONDS * sr), t)
        sig, lens = bench_batch(rng, blen, sr, batch)
        check(env.route(blen) == "kernel", f"{sr} Hz route {env.route(blen)}")
        sig_d, len_d = torch.as_tensor(sig, device=dev), torch.as_tensor(lens, device=dev)
        reset_launches(framefft)
        res, valid = env(sig_d, len_d)
        torch.cuda.synchronize()
        check(framefft.LAUNCHES == 1, f"{sr} Hz: {framefft.LAUNCHES} kernel launches")
        launches += main_launches(framefft)
        worst = hold_to_cpu_f64(at, env, res, valid, sig, lens)
        del res
        ms = wall_ms(lambda: env(sig_d, len_d), reps=5, warmup=1)
        env_off = at.SndEnv(with_mel(flagship_cfg(at, kwta_on=False), n_mel), sr,
                            device=dev)
        ms_off = wall_ms(lambda: env_off(sig_d, len_d), reps=5, warmup=1)
        args, kw = kernel_route_args(env, sig_d)
        shape = picked_layout(framefft, args, t.win_samples)
        with precision_tier("highest"):
            k_ms = cuda_ms(lambda: framefft.fused_frame_power_mel(*args, **kw), reps=5)
            p_ms = cuda_ms(lambda: framefft.fused_frame_power_mel_reference(*args, **kw),
                           reps=5)
        bound = frontend_bound(batch, blen, args[3], t.win_samples, t.n_bins, n_mel,
                               6, (True, True), mel_terms(args[6], t.n_bins, n_mel))
        phase(11, f"SndEnv {sr / 1000:g} kHz, {n_mel} filters, B={batch} x "
                  f"{SECONDS:g} s: route 'kernel', 1 launch (block: {shape.consumers} warpgroup(s), {shape.ring} stages, "
                  f"piece {shape.piece or 'none'} in {shape.pbufs} buffers, "
                  f"{shape.kind}, {shape.bytes} bytes); GPU float32 vs CPU float64 "
                  f"(B=8, {t.win_samples}-term sums): "
                  + ", ".join(f"{k} {v}" for k, v in worst.items()))
        if sr == 96000:
            why = tf32_gather_control(at, env, sig, lens)
            phase(11, f"control: the window gather with TF32 on in the kernel's "
                      f"place fails the float32 bound: {why}")
        phase(11, f"[{name_limit}] SndEnv {sr / 1000:g} kHz, {n_mel} filters, "
                  f"B={batch} x {SECONDS:g} s: {ms:.3f} ms (median of 5, "
                  f"synchronized), RTF {float(lens.sum()) / sr / (ms / 1e3):.1f}; "
                  f"kWTA off {ms_off:.3f} ms; the frontend alone: kernel "
                  f"{k_ms:.4f} ms (bound {bound[0]:.4f} ms by {bound[1]}), plain "
                  f"PyTorch (window gather + FP32 GEMMs) {p_ms:.4f} ms (median of 5, "
                  "CUDA events)")
    sr = 96000
    pipe = at.SegmentPipeline(sr, device=dev)
    pipe64 = at.SegmentPipeline(sr, dtype=torch.float64, device="cpu")
    rows, _ = bench_batch(rng, sr, sr, batch)
    steps = pipe.setup(100.0, 400.0)[2]
    reset_launches(framefft)
    out = pipe.process(rows, 100.0, 400.0)
    torch.cuda.synchronize()
    check(framefft.LAUNCHES == 1,
          f"SegmentPipeline 96 kHz: {framefft.LAUNCHES} kernel launches")
    launches += main_launches(framefft)
    rows2 = rows[:2].astype(np.float64)
    ref = pipe64.process(rows2, 100.0, 400.0)
    check(torch.equal(out["step_valid"].cpu(), ref["step_valid"]),
          "SegmentPipeline 96 kHz step_valid differs from CPU")
    mine = {k: (v if k == "step_valid" else v[:2]).cpu() for k, v in out.items()
            if v is not None}
    try:
        shares = fb.hold(mine, ref, fb.segment_bounds(pipe64, rows2, 100.0, 400.0),
                         pipe64, batch_ndim=1)
    except AssertionError as e:
        raise RuntimeError(f"chip_smoke: SegmentPipeline 96 kHz vs CPU float64: {e}") from None
    phase(11, f"SegmentPipeline 96 kHz, [{batch}, {sr}] rows, {steps} steps: 1 "
              f"kernel launch; vs CPU float64 within the float32 bound: "
              + ", ".join(f"{k} {v:.2g}" for k, v in shares.items()))
    env44 = at.SndEnv(flagship_cfg(at), 44100, device=dev)
    blen = bucket_length(int(SECONDS * 44100), env44.timing)
    sig44, len44 = bench_batch(rng, blen, 44100, batch)
    check(env44.route(blen) == "kernel", "44.1 kHz, 32 filters left the kernel")
    sig44_d, len44_d = torch.as_tensor(sig44, device=dev), torch.as_tensor(len44, device=dev)
    reset_launches(framefft)
    env44(sig44_d, len44_d)
    torch.cuda.synchronize()
    check(framefft.LAUNCHES == 1, f"44.1 kHz: {framefft.LAUNCHES} kernel launches")
    launches += main_launches(framefft)
    ms44 = wall_ms(lambda: env44(sig44_d, len44_d), reps=5, warmup=1)
    env44_off = at.SndEnv(flagship_cfg(at, kwta_on=False), 44100, device=dev)
    ms44_off = wall_ms(lambda: env44_off(sig44_d, len44_d), reps=5, warmup=1)
    # the frontend alone in the layout picked, in the whole span and in
    # pieces with two warpgroups
    args, kw = kernel_route_args(env44, sig44_d)
    geom = (args[1], env44.timing.win_samples, args[3])
    picked = picked_layout(framefft, args, geom[1])
    fits = framefft.layouts(*geom)
    timed = dict.fromkeys((picked, next(lay for lay in fits if not lay.piece),
                           next(lay for lay in fits if lay.piece and lay.consumers == 2)))
    k_ms = {}
    with precision_tier("highest"):
        for lay in timed:
            with forced_layout(framefft, lay):
                k_ms[lay] = cuda_ms(lambda: framefft.fused_frame_power_mel(*args, **kw),
                                    reps=5)
    phase(11, "SndEnv 44.1 kHz, 32 filters: route 'kernel', 1 launch")
    phase(11, f"[{name_limit}] SndEnv 44.1 kHz, 32 filters, B={batch} x {SECONDS:g} s "
              f"on the kernel route: {ms44:.3f} ms (median of 5, synchronized); kWTA "
              f"off {ms44_off:.3f} ms; the frontend alone: kernel "
              + ", ".join(f"{k_ms[lay]:.4f} ms in {tuple(lay[:4])} ({lay.kind}"
                          f"{', picked' if lay == picked else ''})"
                          for lay in timed)
              + " (median of 5, CUDA events)")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the multi-process paths on the card
# ---------------------------------------------------------------------------

# what the multi-rank runs return and gather
P12_KEYS = ("mel_fbank_segment", "mfcc_segment", "gabor_kwta", "step_valid")
RANK_TIMEOUT_S = 120


def sync():
    """Wait for the card (a rank's steps also run on the host when
    rehearsed there)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def phase12_batch(at, batch=BATCH):
    """The flagship batch of phase 12 (bench.py's batch, B=512 x 3 s), made
    from its own seed so that every rank builds the same one."""
    from auditory_tpu_torch.pipeline.batch import bucket_length

    n16 = bucket_length(int(SECONDS * SR), at.WindowParams().derive(SR))
    return bench_batch(np.random.default_rng(12), n16, SR, batch)


def long_utterance(at):
    """One padded 60 s utterance for the segment-sharded (CP) run."""
    env = at.SndEnv(flagship_cfg(at), SR, device="cpu")
    sig = env.pad(synth_utterance(np.random.default_rng(13), 1, 60 * SR, SR))
    return sig[None].astype(np.float32), np.array([sig.shape[0]])


def rank_rows(rank, world, batch=BATCH):
    """This rank's contiguous rows of phase 12's batch: all 512 rows over two
    ranks, 511 (uneven) over three."""
    n = batch if world == 2 else batch - 1
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n), world)])
    return slice(int(bounds[rank]), int(bounds[rank + 1])), n


def _rank_rows(at, framefft, D, rank, world, workdir, rec, batch):
    """(b) process_local over this rank's rows, gathered on every rank."""
    from auditory_tpu_torch.parallel.mesh import make_mesh

    sig, lens = phase12_batch(at, batch)
    sl, n = rank_rows(rank, world, batch)
    env = at.SndEnv(flagship_cfg(at), SR, device=D.local_device(), outputs=P12_KEYS,
                    feature_stats=True)
    benv = at.BatchedSndEnv(env, mesh=make_mesh())
    benv.process_local(sig[sl][:8], lens[sl][:8])  # warm-up: library, handles
    sync()
    D.barrier("rows_warm")
    reset_launches(framefft)
    t0 = time.perf_counter()
    (out, valid, stats), pad = benv.process_local(sig[sl], lens[sl])
    sync()
    rec["rows_launches"] = framefft.LAUNCHES
    rec["rows_layouts"] = dict(framefft.LAUNCHES_BY_LAYOUT)
    rec["rows_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    g_out, g_valid = D.gather_local_rows((out, valid), sl.stop - sl.start, pad)
    rec["rows_gather_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["rows"] = [sl.start, sl.stop]
    if rank == 0:
        np.savez(workdir / f"rows{world}.npz", seg_valid=g_valid,
                 **{k: getattr(g_out, k) for k in P12_KEYS},
                 **{f"stats_{k}": v.cpu().numpy() for k, v in stats.items()})


def _rank_cp(at, framefft, D, rank, world, workdir, rec, batch):
    """(c) the 60 s utterance's segments over the ranks."""
    from auditory_tpu_torch.parallel.mesh import make_mesh

    sig, lens = long_utterance(at)
    env = at.SndEnv(flagship_cfg(at), SR, device=D.local_device(), outputs=P12_KEYS,
                    feature_stats=True)
    benv = at.BatchedSndEnv(env, mesh=make_mesh(), shard_axis="segment")
    reset_launches(framefft)
    t0 = time.perf_counter()
    (out, valid, _), pad = benv.process_local(sig, lens)
    sync()
    rec["cp_launches"] = framefft.LAUNCHES
    rec["cp_layouts"] = dict(framefft.LAUNCHES_BY_LAYOUT)
    rec["cp_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["cp_segments"] = int(valid.shape[1])
    t0 = time.perf_counter()
    g_out, g_valid = D.allgather((out, valid), axis=1)
    rec["cp_gather_ms"] = 1e3 * (time.perf_counter() - t0)
    if rank == 0:
        np.savez(workdir / "cp.npz", seg_valid=g_valid,
                 **{k: getattr(g_out, k) for k in P12_KEYS})


def _rank_corpus(at, framefft, D, rank, world, workdir, rec, batch):
    """(d) run_distributed over phase 7's files; the digest guard; (e) a
    rank whose run raises."""
    from auditory_tpu_torch.io.wav import load_wav
    from auditory_tpu_torch.pipeline.batch import bucket_length

    paths = sorted(glob.glob(str(workdir.parent / "corpus" / "wavs" / "*.wav")))
    runner = at.CorpusRunner(flagship_cfg(at), SR, device=D.local_device())
    # the batches this rank's shard (every world-th file) fills, as phase 7
    # counts them
    buckets = {}
    for p in paths[rank::world]:
        n = len(runner.env.pad(load_wav(p).sound_to_tensor(np.float32)))
        key = bucket_length(n, runner.env.timing, quantum=SR)
        buckets[key] = buckets.get(key, 0) + 1
    rec["corpus_batches"] = sum(-(-c // runner.batch_size) for c in buckets.values())
    reset_launches(framefft)
    t0 = time.perf_counter()
    stats, summary = runner.run_distributed(paths, str(workdir / "dist_out"),
                                            resume=False)
    sync()
    rec["corpus_launches"] = framefft.LAUNCHES
    rec["corpus_layouts"] = dict(framefft.LAUNCHES_BY_LAYOUT)
    rec["corpus_s"] = time.perf_counter() - t0
    rec["corpus_audio_s"] = stats.audio_seconds
    rec["corpus_files"] = stats.files_done
    rec["summary"] = summary
    try:
        runner.run_distributed(paths if rank == 0 else paths[::-1],
                               str(workdir / "nope"))
    except ValueError as e:
        rec["digest"] = str(e)
    failing = at.CorpusRunner(flagship_cfg(at), SR, device=D.local_device())
    if rank == 1:
        def broken(*a, **k):
            raise OSError("the disk is full")
        failing.run = broken
    t0 = time.perf_counter()
    try:
        failing.run_distributed(paths[:8], str(workdir / "fail_out"))
    except RuntimeError as e:
        rec["fail"] = str(e)
    rec["fail_s"] = time.perf_counter() - t0


RANK_STEPS = {"two": (_rank_rows, _rank_cp, _rank_corpus), "three": (_rank_rows,)}


def rank_main(argv):
    """One rank of a phase 12 group (``chip_smoke.py --rank SCENARIO RANK
    WORLD PORT WORKDIR DEVICE BATCH``): join the gloo group on DEVICE (the
    card: ``cuda``), run the scenario's steps and write what each observed
    to ``WORKDIR/SCENARIO_rank<RANK>.json``."""
    scenario, rank, world, port, workdir, device, batch = (
        argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4]), argv[5],
        int(argv[6]))
    t_start = time.perf_counter()
    import auditory_tpu_torch as at
    from auditory_tpu_torch.ops import framefft
    from auditory_tpu_torch.parallel import distributed as D

    dev = D.initialize(f"127.0.0.1:{port}", world, rank, device=device,
                       timeout_s=RANK_TIMEOUT_S)
    rec = {"rank": rank, "device": str(dev), "backend": D.data_backend()}
    try:
        for step in RANK_STEPS[scenario]:
            step(at, framefft, D, rank, world, workdir, rec, batch)
            D.barrier(step.__name__)
    finally:
        rec["wall_s"] = time.perf_counter() - t_start
        with open(workdir / f"{scenario}_rank{rank}.json", "w") as f:
            json.dump(rec, f)
        D.shutdown()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_group(scenario, world, workdir, timeout, dev, batch):
    """Run a phase 12 group as ``world`` processes of this script on
    ``dev`` and wait for them (killing all at the time limit); any rank's
    failure fails the run. Returns each rank's record."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", scenario,
         str(rank), str(world), str(port), str(workdir), dev.type, str(batch)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{scenario} rank {rank} exited {p.returncode}:\n"
                                 f"{out[-3000:]}")
    recs = []
    for rank in range(world):
        with open(workdir / f"{scenario}_rank{rank}.json") as f:
            recs.append(json.load(f))
    return recs


def hold_rows(env64, got, ref, bounds, label):
    """Gathered host arrays ``got`` against the single-process run ``ref``
    (host arrays) within the sum of their float32 bounds (hold_pair;
    ``bounds``: f32_bounds.slice_bounds of the rows): validity equal,
    gabor_kwta each through its own mel. Returns the worst share."""
    keys = ("seg_valid", "step_valid", "mel_fbank_segment", "mfcc_segment",
            "gabor_kwta")
    w = hold_pair(env64, {k: got[k] for k in keys}, {k: ref[k] for k in keys},
                  bounds, label)
    return max(w.values())


def multirank_phase(at, framefft, dev, name_limit, chip_dir, stats7, serving,
                    batch=BATCH):
    """Phase 12: (a) process_local in a one-rank NCCL group; (b) two gloo
    ranks on the one card, 256 rows each, and three with 511 rows; (c) the
    60 s utterance's segments over two ranks; (d) run_distributed over phase
    7's files on two ranks; (e) a rank whose run raises; (f)
    MultiStreamOnline on a two-shard mesh of the card. Returns the kernel's
    launches (all ranks)."""
    from auditory_tpu_torch.parallel import distributed as D
    from auditory_tpu_torch.parallel.mesh import make_mesh
    from auditory_tpu_torch.utils import f32_bounds as fb

    workdir = chip_dir / "ranks"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    sig, lens = phase12_batch(at, batch)
    env = at.SndEnv(flagship_cfg(at), SR, device=dev, outputs=P12_KEYS,
                    feature_stats=True)
    out, valid, stats = at.BatchedSndEnv(env).process(sig, lens)
    want_dev = "cuda:0" if dev.type == "cuda" else "cpu"
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    ref = {"seg_valid": valid.cpu().numpy(),
           **{k: getattr(out, k).cpu().numpy() for k in P12_KEYS}}
    ref_stats = {k: v.cpu().numpy() for k, v in stats.items()}
    del out
    env64 = f64_consts(at, env, dev)
    bounds = fb.slice_bounds(env64, sig, lens)

    def hold_stats(got, rows, label):
        """All-reduced feature stats of ``rows`` against the single run's:
        the count equal, the sums within twice f32_bounds.sum_bounds."""
        valid = held(ref["step_valid"][:rows], dev)
        mel = held(ref["mel_fbank_segment"][:rows], dev).double().transpose(-1, -2)
        sums = fb.sum_bounds(bounds["mel_fbank_segment"][:rows].transpose(-1, -2),
                             mel, valid)
        check(float(got["count"]) == float(ref_stats["count"]), f"{label} stats count")
        for k, b in zip(("sum", "sumsq"), sums):
            sh = fb.share(held(got[k], dev), held(ref_stats[k], dev), 2.0 * b)
            check(sh <= 1.0, f"{label} stats {k} at {sh:.3g} of the sum of bounds")

    # (a) one rank, NCCL
    D.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=dev.type,
                 timeout_s=RANK_TIMEOUT_S)
    try:
        check(D.data_backend() == want_backend,
              f"one-rank group on {D.data_backend()}")
        benv = at.BatchedSndEnv(env, mesh=make_mesh())
        benv.process_local(sig[:8], lens[:8])  # warm-up: the communicator
        torch.cuda.synchronize()
        reset_launches(framefft)
        t0 = time.perf_counter()
        (o, v, st), pad = benv.process_local(sig, lens)
        torch.cuda.synchronize()
        launches = main_launches(framefft)
        ms_a = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        g_out, g_valid = D.gather_local_rows((o, v), batch, pad)
        gather_a = 1e3 * (time.perf_counter() - t0)
        st = {k: val.cpu().numpy() for k, val in st.items()}
        D.barrier("one_rank")
    finally:
        D.shutdown()
    check(launches == 1, f"(a) {launches} kernel launches")
    worst = hold_rows(env64, {"seg_valid": g_valid,
                              **{k: getattr(g_out, k) for k in P12_KEYS}},
                      ref, bounds, "(a) one rank")
    hold_stats(st, batch, "(a)")
    phase(12, f"(a) one-rank {want_backend} group, B={batch} x {SECONDS:g} s: process_local "
              f"+ gather_local_rows vs BatchedSndEnv.process at {worst:.2g} of "
              f"the sum of their float32 bounds, all-reduced stats within the sum of their bounds; {launches} "
              "kernel launch")
    phase(12, f"[{name_limit}] (a) process_local {ms_a:.3f} ms, gather "
              f"{gather_a:.3f} ms ({want_backend}, wall)")
    del g_out

    # (b)-(e): two ranks, then three, as processes on the one card (gloo)
    recs2 = spawn_group("two", 2, workdir, 600, dev, batch)
    recs3 = spawn_group("three", 3, workdir, 300, dev, batch)
    for world, recs in ((2, recs2), (3, recs3)):
        check(all(r["backend"] == "gloo" and r["device"] == want_dev for r in recs),
              f"{world} ranks: backend or device {[(r['backend'], r['device']) for r in recs]}")
        n = rank_rows(0, world, batch)[1]
        got = dict(np.load(workdir / f"rows{world}.npz"))
        w = hold_rows(env64, got, {k: v[:n] for k, v in ref.items()},
                      {k: b[:n] for k, b in bounds.items()}, f"(b) {world} ranks")
        if world == 2:
            hold_stats({k: got[f"stats_{k}"] for k in ref_stats}, batch,
                       "(b) all-reduced")
        for r in recs:
            add_layout_launches(r["rows_layouts"])
        launches += sum(r["rows_launches"] for r in recs)
        check(all(r["rows_launches"] == 1 for r in recs), "(b) a rank did not launch")
        phase(12, f"(b) {world} gloo ranks on the card, rows "
                  f"{[tuple(r['rows']) for r in recs]} of {n}: gathered vs the "
                  f"single-process run at {w:.2g} of the sum of their float32 "
                  f"bounds; launches "
                  f"{[r['rows_launches'] for r in recs]}")
        phase(12, f"[{name_limit}] (b) {world} ranks: process_local per rank "
                  + ", ".join(f"{r['rows_ms']:.1f}" for r in recs) + " ms; gather per rank "
                  + ", ".join(f"{r['rows_gather_ms']:.1f}" for r in recs)
                  + " ms; rank wall (start to exit) "
                  + ", ".join(f"{r['wall_s']:.1f}" for r in recs) + " s")
    # (c) the long utterance's segments
    lsig, llen = long_utterance(at)
    lenv = at.SndEnv(flagship_cfg(at), SR, device=dev, outputs=P12_KEYS)
    lo, lv = lenv(torch.as_tensor(lsig, device=dev), torch.as_tensor(llen, device=dev))
    lref = {"seg_valid": lv.cpu().numpy(), **{k: getattr(lo, k).cpu().numpy() for k in P12_KEYS}}
    w = hold_rows(env64, dict(np.load(workdir / "cp.npz")), lref,
                  fb.slice_bounds(env64, lsig, llen), "(c) CP")
    check(all(r["cp_launches"] == 1 for r in recs2),
          f"(c) launches per rank {[r['cp_launches'] for r in recs2]}, not 1")
    for r in recs2:
        add_layout_launches(r["cp_layouts"])
    launches += sum(r["cp_launches"] for r in recs2)
    phase(12, f"(c) one 60 s utterance, shard_axis='segment' over 2 ranks: segments "
              f"{[r['cp_segments'] for r in recs2]} of {lv.shape[1]}; vs the "
              f"unsharded run at {w:.2g} of the sum of their float32 bounds")
    phase(12, f"[{name_limit}] (c) per rank " + ", ".join(
        f"{r['cp_ms']:.1f} ms + gather {r['cp_gather_ms']:.1f} ms" for r in recs2))
    # (d) run_distributed against phase 7's single run
    out7, outd = chip_dir / "corpus" / "out", workdir / "dist_out"
    n_files = len(glob.glob(str(chip_dir / "corpus" / "wavs" / "*.wav")))
    check(sum(r["corpus_files"] for r in recs2) == n_files
          and recs2[0]["summary"]["files_ok"] == n_files and recs2[1]["summary"] is None,
          f"(d) files {[r['corpus_files'] for r in recs2]}, {recs2[0]['summary']}")
    names = sorted(f for f in os.listdir(out7) if f.endswith(".npz"))
    check(sorted(f for f in os.listdir(outd) if f.endswith(".npz")) == names,
          "(d) merged npz names differ from phase 7's")
    with open(out7 / "feature_stats.json") as f:
        s7 = json.load(f)
    with open(outd / "feature_stats.json") as f:
        sd = json.load(f)
    check(sd["count_steps"] == s7["count_steps"], "(d) count_steps")
    worst_d = hold_corpus_dirs(at, env, dev, sorted(glob.glob(
        str(chip_dir / "corpus" / "wavs" / "*.wav"))), out7, outd, "(d)", (s7, sd))
    ok = lambda path: sorted(json.loads(line)["path"] for line in open(path)
                             if json.loads(line)["status"] == "ok")
    check(ok(outd / "manifest.jsonl") == ok(out7 / "manifest.jsonl"), "(d) manifest")
    check(all(r["corpus_launches"] == r["corpus_batches"] > 0 for r in recs2),
          f"(d) launches per rank {[r['corpus_launches'] for r in recs2]} for "
          f"batches {[r['corpus_batches'] for r in recs2]}")
    for r in recs2:
        add_layout_launches(r["corpus_layouts"])
    launches += sum(r["corpus_launches"] for r in recs2)
    rtf_d = sum(r["corpus_audio_s"] for r in recs2) / max(r["corpus_s"] for r in recs2)
    phase(12, f"(d) run_distributed over {n_files} files on 2 ranks: merged npz, manifest "
              f"and feature_stats equal phase 7's run (npz and mel statistics at "
              f"{worst_d:.2g} of the sum of their float32 bounds; count_steps "
              f"equal); launches "
              f"{[r['corpus_launches'] for r in recs2]} (one per batch); the digest guard refused "
              "a drifted list on both ranks")
    phase(12, f"[{name_limit}] (d) run_distributed RTF {rtf_d:.1f} (audio s over "
              f"the slower rank's wall, {max(r['corpus_s'] for r in recs2):.2f} s) "
              f"next to phase 7's run() RTF {stats7.rtf:.1f}")
    for r in recs2:
        check("digests disagree" in r.get("digest", ""), f"(d) digest guard: {r}")
        check("rank(s) [1]" in r.get("fail", "") and r["fail_s"] < RANK_TIMEOUT_S,
              f"(e) rank {r['rank']}: {r.get('fail')!r} after {r['fail_s']:.1f} s")
    phase(12, "(e) rank 1's run raised: both ranks raised, naming rank 1, after "
              + ", ".join(f"{r['fail_s']:.2f}" for r in recs2) + " s")
    # (f) the serving path on a two-shard mesh of the card
    streams, (base, bmel) = serving
    ms = at.MultiStreamOnline(flagship_cfg(at), SR, n_streams=len(streams),
                              outputs=SERVING_KEYS, mesh=make_mesh([dev, dev]))
    reset_launches(framefft)
    res, poll_ms, dispatched, wall = serve(ms, streams, SR // 10)
    torch.cuda.synchronize()
    count = main_launches(framefft)
    check(count == 2 * dispatched, f"(f) {count} launches for {dispatched} polls")
    launches += count
    _, _, stacked = stack_segments(res, SERVING_KEYS)
    ratio, dmel, dk, bit = hold_segments(f64_consts(at, env, dev), stacked, base,
                                         bmel, "(f) mesh serving")
    steady = poll_ms[3:]
    phase(12, f"(f) MultiStreamOnline, {len(streams)} streams on a 2-shard mesh of "
              f"the card: {len(res)} segments vs phase 8: mel max abs {dmel:.3g} "
              f"({ratio:.2g} of the sum of float32 bounds, {'bit-equal' if bit else 'not bit-equal'}), "
              f"gabor_kwta max abs {dk:.3g}; {count} launches for {dispatched} polls")
    phase(12, f"[{name_limit}] (f) poll wall p50 {pct(steady, 50):.3f} ms, RTF "
              f"{sum(len(s) for s in streams) / SR / wall:.1f}")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the native decoder and the CLI
# ---------------------------------------------------------------------------


def native_cli_phase(at, framefft, dev, name_limit, chip_dir, wav, one, n_cli=64):
    """Phase 13: the native decoder in use; phase 7's corpus through run()
    with the native decoder and with io/wav; the CLI's commands as
    subprocesses on the card. Returns the kernel's launches (this process)."""
    from auditory_tpu_torch.io import native
    from auditory_tpu_torch.io.wav import load_wav
    from auditory_tpu_torch.utils import f32_bounds as fb

    check(native.available(), f"native decoder unavailable: {native.build_error()}")
    paths = sorted(glob.glob(str(chip_dir / "corpus" / "wavs" / "*.wav")))
    launches, rtf = 0, {}
    available = native.available
    for decoder in ("native", "python"):
        runner = at.CorpusRunner(flagship_cfg(at), SR, device=dev)
        before = native.DECODED
        reset_launches(framefft)
        # io/wav: the runner's fallback when the native library is missing
        native.available = available if decoder == "native" else lambda: False
        try:
            st = runner.run(paths, str(chip_dir / "corpus" / f"out_{decoder}"),
                            resume=False)
        finally:
            native.available = available
        torch.cuda.synchronize()
        launches += main_launches(framefft)
        check(st.files_done == len(paths), f"{decoder}: {st.files_done} files")
        other = "python" if decoder == "native" else "native"
        check(runner.decode_counts[decoder] == len(paths)
              and runner.decode_counts[other] == 0,
              f"{decoder} decode counts {runner.decode_counts}")
        check((native.DECODED - before == len(paths)) == (decoder == "native"),
              f"native.DECODED moved by {native.DECODED - before}")
        rtf[decoder] = st
    t0 = time.perf_counter()
    for lo in range(0, len(paths), 128):
        info = [native.wav_info(p)[3] for p in paths[lo:lo + 128]]
        native.decode_batch_i16(paths[lo:lo + 128], max(info), n_threads=8)
    dec_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in paths:
        load_wav(p).data
    dec_python = time.perf_counter() - t0
    phase(13, f"native decoder built and used: {len(paths)} files through it "
              f"(native.DECODED), io/wav run decoded {len(paths)} in Python")
    phase(13, f"[{name_limit}] CorpusRunner.run over phase 7's {len(paths)} files: "
              f"native decoder {rtf['native'].wall_seconds:.3f} s, RTF "
              f"{rtf['native'].rtf:.1f}; io/wav {rtf['python'].wall_seconds:.3f} s, "
              f"RTF {rtf['python'].rtf:.1f}; decode alone (one thread pool pass, "
              f"no device): native {dec_native:.3f} s, io/wav serial {dec_python:.3f} s")

    cli_dir = chip_dir / "cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    (cli_dir / "wavs").mkdir(parents=True)
    for p in paths[:n_cli]:
        os.symlink(p, cli_dir / "wavs" / os.path.basename(p))
    base = [sys.executable, "-m", "auditory_tpu_torch.cli"]
    on = ("--device", dev.type)

    def run_cli(*args):
        t0 = time.perf_counter()
        if args[0] in ("process", "corpus", "segment"):
            args = args + on
        proc = subprocess.run([*base, *args], capture_output=True, text=True,
                              timeout=300, cwd=str(Path(__file__).resolve().parent))
        check(proc.returncode == 0, f"cli {args[0]} exited {proc.returncode}:\n"
                                    f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        return proc.stdout, time.perf_counter() - t0

    times = {}
    _, times["process"] = run_cli("process", str(wav), "--out", str(cli_dir / "p.npz"))
    env13 = at.SndEnv(flagship_cfg(at), SR, device=dev)
    sig13 = env13.pad(load_wav(str(wav)).sound_to_tensor())
    keys = ("mel_fbank_segment", "gabor_kwta", "mfcc_segment")
    with np.load(cli_dir / "p.npz") as z:
        hold_pair(f64_consts(at, env13, dev), {k: z[k][None] for k in keys},
                  {k: getattr(one, k)[None] for k in keys},
                  fb.slice_bounds(f64_consts(at, env13, dev), sig13[None], [len(sig13)]),
                  "cli process vs SndEnv.process")
    out, times["corpus"] = run_cli("corpus", "--glob", str(cli_dir / "wavs" / "*.wav"),
                                   "--out", str(cli_dir / "corpus"))
    rec = json.loads(out.strip().splitlines()[-1])
    check(rec["files_done"] == n_cli and rec["decoded"]["native"] == n_cli,
          f"cli corpus {rec}")
    out, times["corpus --coordinator"] = run_cli(
        "corpus", "--glob", str(cli_dir / "wavs" / "*.wav"), "--out",
        str(cli_dir / "coord"), "--coordinator", f"127.0.0.1:{free_port()}",
        "--num-processes", "1", "--process-id", "0")
    crec = json.loads(out.strip().splitlines()[-1])
    check(crec["files_done"] == n_cli and crec.get("backend") == (
        "nccl" if dev.type == "cuda" else "gloo"), f"coordinator {crec}")
    env7 = at.SndEnv(flagship_cfg(at), SR, device=dev)
    worst = max(hold_corpus_dirs(at, env7, dev, paths[:n_cli], chip_dir / "corpus" / "out",
                                 cli_dir / d, f"cli {d}") for d in ("corpus", "coord"))
    _, times["segment --compare"] = run_cli(
        "segment", str(wav), "--start-ms", "100", "--end-ms", "400", "--compare",
        "--b-mel-filters", "40", "--out", str(cli_dir / "s.npz"))
    with np.load(cli_dir / "s.npz") as z:
        check(z["a_mel_fbank_segment"].shape[0] == 32 and z["b_mel_fbank_segment"].shape[0] == 40,
              "cli segment --compare shapes")
    out, times["info"] = run_cli("info", str(wav))
    check("16000 Hz, 1 ch, 16-bit" in out, f"cli info: {out!r}")
    phase(13, f"CLI on {dev.type}: process = SndEnv.process; corpus over {n_cli} of phase "
              f"7's files and corpus --coordinator (1 process, backend "
              f"{crec['backend']}) = phase 7's run at {worst:.2g} of the sum of their "
              "float32 bounds, "
              f"{n_cli} files through the native decoder; segment --compare; info")
    phase(13, f"[{name_limit}] CLI wall per command (process start to exit): "
              + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the fuzzed configurations on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def captured_calls(module):
    """Pass every call of ``module.fused_frame_power_mel`` through, and
    record its (args, kwargs, outputs) in the yielded list."""
    calls = []
    real = module.fused_frame_power_mel

    def call(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, tuple(None if x is None else x.detach().clone()
                                      for x in out)))
        return out

    module.fused_frame_power_mel = call
    try:
        yield calls
    finally:
        module.fused_frame_power_mel = real


def hold_kernel_call(framefft, call, label):
    """A kernel call the main path made (captured_calls): its outputs
    against the plain version in float64 on the same inputs within the
    float32 error model's bound; then the kernel at passes 3 on the same
    inputs against the plain version's limb emulation within the bound of
    two sum orders (pair_frontend_bounds) and against float64 within the
    grade's bound, as phase 3 holds them. Returns (share at passes 6, pair
    share at passes 3, grade share at passes 3, the block layout)."""
    from auditory_tpu_torch.pipeline.sndenv import precision_tier

    args, kw, got = call
    check(kw.get("passes", 6) == 6, f"{label}: the main path ran passes={kw.get('passes')}")
    kw6 = {k: v for k, v in kw.items() if k != "passes"}
    kw3 = dict(kw6, emit=(True, True))
    with precision_tier("highest"):
        ref, bounds = frontend_model(framefft, args, kw6)
        _, s6 = compare(got, ref, bounds, label)
        got3 = framefft.fused_frame_power_mel(*args, **kw3, passes=3)
        emu = framefft.fused_frame_power_mel_reference(*args, **kw3, passes=3)
        _, s_pair = compare(got3, emu, model_bounds(args, kw3, emu[0], 3, pair=True),
                            f"{label} passes=3 vs emulation")
        ref3 = plain_f64(framefft, args, kw3)
        s3 = model_share(got3, ref3, model_bounds(args, kw3, ref3[0], 3))
        check(s3 <= 1.0, f"{label} passes=3: at {s3:.3g} of the grade's float32 bound")
    return s6, s_pair, s3, picked_layout(framefft, args, args[4].shape[0])


def fuzz_rows(sig, rng, n_full, ragged):
    """float32 rows: the signal with a little noise, the first cut to a
    ragged true length ``ragged`` (zero past it), then ``n_full`` rows of
    the full length."""
    rows = (sig[None] + 0.01 * rng.standard_normal((n_full + 1, len(sig)))).astype(np.float32)
    lens = np.full(n_full + 1, len(sig), dtype=np.int64)
    lens[0] = ragged
    rows[0, ragged:] = 0.0
    return rows, lens


def fuzz_phase(at, framefft, dev, name_limit, entries):
    """Phase 14: every configuration of tests/data/torch_fuzz_configs.json
    (tests/test_fuzz_parity.py's draws) on the card, each launching the
    kernel on the main path: the families "config" and "layout" through
    SndEnv at 8 rows of the entry's length plus a ragged one, on 'auto'
    where the grid is uniform and on 'per_segment' where it is not, the
    slice held against CPU float64 (rows 0-7); "online" through
    OnlineSndEnv (segment_frontend='per_segment') fed the entry's drawn
    chunks, every segment against the CPU float64 offline run; "segment"
    through SegmentPipeline over 8 rows, against CPU float64. Every kernel
    call is held by hold_kernel_call. Returns the kernel's launches."""
    import auditory_tpu_torch.pipeline.segments as segments_mod
    import auditory_tpu_torch.pipeline.sndenv as sndenv_mod
    from auditory_tpu_torch.utils import f32_bounds as fb

    t0 = time.perf_counter()
    launches, worst, layouts = 0, {}, {}
    for e in entries:
        label, sr = f"{e['family']}{e['seed']}", e["sample_rate"]
        rng = np.random.default_rng(e["seed"])
        if e["family"] in ("config", "layout"):
            env = at.SndEnv(e["cfg"], sr, device=dev)
            sig = env.pad(fuzz_tone(e))
            n = len(sig)
            if env.route(n) != "kernel":
                env = at.SndEnv(e["cfg"], sr, device=dev, segment_frontend="per_segment")
            route = env.route(n)
            check(route in ("kernel", "per_segment"), f"{label}: route {route}")
            rows, lens = fuzz_rows(sig, rng, 8, n - env.timing.stride_samples // 2)
            with captured_calls(sndenv_mod) as calls:
                reset_launches(framefft)
                res, valid = env(torch.as_tensor(rows, device=dev),
                                 torch.as_tensor(lens, device=dev))
                torch.cuda.synchronize()
                count = main_launches(framefft)
            check(count == len(calls) == 1, f"{label}: {count} kernel launches")
            slice_share = max(sh for _, sh in cpu_f64_shares(
                at, env, res, valid, rows, lens).values())
            what = f"SndEnv route {route}, B={rows.shape[0]} x {n}"
        elif e["family"] == "online":
            sig = fuzz_tone(e).astype(np.float32)
            online = at.OnlineSndEnv(e["cfg"], sr, device=dev,
                                     segment_frontend="per_segment")
            got, i = {}, 0
            with captured_calls(sndenv_mod) as calls:
                reset_launches(framefft)
                for c in e["chunks"]:
                    got.update(dict(online.feed(sig[i:i + c])))
                    i += c
                got.update(dict(online.flush()))
                torch.cuda.synchronize()
                count = main_launches(framefft)
            check(count == len(calls) == len(got), f"{label}: {count} kernel launches "
                                                  f"for {len(got)} segments")
            env64 = at.SndEnv(e["cfg"], sr, dtype=torch.float64, device="cpu",
                              outputs=at.SndEnv.ALL_OUTPUTS,
                              segment_frontend="per_segment")
            padded = torch.as_tensor(env64.pad(sig.astype(np.float64)))[None]
            lens = torch.tensor([padded.shape[1]])
            ref, _ = env64(padded, lens)
            check(sorted(got) == list(range(ref.mel_fbank_segment.shape[1])),
                  f"{label}: {len(got)} segments online, "
                  f"{ref.mel_fbank_segment.shape[1]} offline")
            mine = {f: torch.stack([getattr(got[k], f).cpu() for k in sorted(got)])[None]
                    for f in (*FLOAT_FIELDS, "step_valid") if getattr(got[0], f) is not None}
            try:
                shares = fb.hold(mine, ref, fb.slice_bounds(env64, padded, lens), env64)
            except AssertionError as err:
                raise RuntimeError(f"chip_smoke: {label} online vs CPU float64: {err}") from None
            slice_share = max(shares.values())
            what = f"OnlineSndEnv, {len(e['chunks'])} chunks, {len(got)} segments"
        else:
            a, b = e["start_ms"], e["end_ms"]
            kw = dict(mel=at.MelParams(), gabor=e["gset"], kwta=at.KWTAParams(on=False))
            pipe = at.SegmentPipeline(sr, e["wp"], device=dev, **kw)
            pipe64 = at.SegmentPipeline(sr, e["wp"], dtype=torch.float64, device="cpu", **kw)
            rows = fuzz_rows(fuzz_tone(e), rng, 7, e["n_samples"])[0]
            with captured_calls(segments_mod) as calls:
                reset_launches(framefft)
                out = pipe.process(rows, a, b)
                torch.cuda.synchronize()
                count = main_launches(framefft)
            check(count == len(calls) == 1, f"{label}: {count} kernel launches")
            rows2 = rows[:2].astype(np.float64)
            ref = pipe64.process(rows2, a, b)
            mine = {k: (v if k == "step_valid" else v[:2]).cpu() for k, v in out.items()
                    if v is not None}
            try:
                shares = fb.hold(mine, ref, fb.segment_bounds(pipe64, rows2, a, b),
                                 pipe64, batch_ndim=1)
            except AssertionError as err:
                raise RuntimeError(f"chip_smoke: {label} SegmentPipeline vs CPU "
                                   f"float64: {err}") from None
            slice_share = max(shares.values())
            what = f"SegmentPipeline, [{rows.shape[0]}, {rows.shape[1]}], {a:.1f}-{b:.1f} ms"
        launches += count
        kernel = [hold_kernel_call(framefft, c, f"{label} call {j}")
                  for j, c in enumerate(calls)]
        lay = kernel[0][3]
        cfg = e.get("cfg")
        geom = (f"{cfg.params.win_ms:g}/{cfg.params.step_ms:g} ms window/step, "
                f"{cfg.mel.fbank.n_filters} filters" if cfg is not None
                else f"{e['wp'].win_ms:g}/{e['wp'].step_ms:g} ms window/step, 32 filters")
        args = calls[0][0]
        worst[label] = {"slice": round(slice_share, 4),
                        "kernel": round(max(k[0] for k in kernel), 4),
                        "passes3_pair": round(max(k[1] for k in kernel), 4),
                        "passes3_grade": round(max(k[2] for k in kernel), 4)}
        layouts[label] = f"{lay.kind}, {lay.consumers} warpgroup(s)"
        phase(14, f"{label} ({sr} Hz, {geom}; {what}): {count} kernel launch(es), step "
                  f"{args[1]}, window {args[4].shape[0]}, {args[3]} windows a row of "
                  f"{args[0].shape[1]} from offset {args[2]}, {args[0].shape[0]} rows; "
                  f"layout {tuple(lay[:4])} ({lay.kind}, {lay.consumers} warpgroup(s)); "
                  f"shares of the float32 bound: slice vs CPU float64 "
                  f"{worst[label]['slice']:.3g}, kernel vs plain float64 "
                  f"{worst[label]['kernel']:.3g}, passes=3 vs emulation "
                  f"{worst[label]['passes3_pair']:.3g} and vs its grade "
                  f"{worst[label]['passes3_grade']:.3g}")
    kinds = {}
    for v in layouts.values():
        kinds[v] = kinds.get(v, 0) + 1
    phase(14, "worst share of the float32 bound by entry: " + json.dumps(worst))
    phase(14, f"{len(entries)} fuzzed entries, {launches} kernel launches on the main "
              f"path, layouts {json.dumps(kinds)}; {time.perf_counter() - t0:.1f} s")
    return launches, worst


# ---------------------------------------------------------------------------
# Phase 15: the serve_streams and process_speech examples on the card
# ---------------------------------------------------------------------------

def examples_phase(at, framefft, dev, name_limit, wav):
    """Phase 15: serve_streams at its defaults (16 streams, 2 s) through
    its main(), float32 and float16 tiers: every stream's segments emitted
    once, the float32 tier within the sum of the float32 bounds of one
    offline BatchedSndEnv run over the streams, the float16 tier within
    float16 rounding of the float32 tier, the median poll; process_speech
    on ``wav`` on the card (no kernel launch: the window gather) with the
    segment count and hottest bands of its CPU run. Returns the kernel's
    launches and the median poll ms by tier."""
    import io

    from auditory_tpu_torch.examples import process_speech, serve_streams
    from auditory_tpu_torch.io.wav import load_wav

    t0 = time.perf_counter()
    launches, runs, poll = 0, {}, {}
    for tier, flags in (("float32", []), ("float16", ["--f16"])):
        text = io.StringIO()
        reset_launches(framefft)
        with contextlib.redirect_stdout(text):
            served = serve_streams.main(flags)
        torch.cuda.synchronize()
        count = main_launches(framefft)
        out = text.getvalue()
        check("SERVE_OK" in out, f"serve_streams {flags}: no SERVE_OK in {out!r}")
        check(count >= len(served.poll_ms) >= 1,
              f"serve_streams {tier}: {count} kernel launches for "
              f"{len(served.poll_ms)} polls that emitted")
        launches += count
        runs[tier] = {(i, k): o for i, k, o in served.results}
        check(len(runs[tier]) == len(served.results),
              f"serve_streams {tier}: a segment was emitted twice")
        poll[tier] = float(np.median(served.poll_ms))
        phase(15, f"[{name_limit}] serve_streams {' '.join(flags) or '(defaults)'}: "
                  + "; ".join(out.strip().splitlines())
                  + f"; {count} kernel launches; median poll {poll[tier]:.3f} ms")
    env = at.SndEnv(serve_streams.example_cfg(), serve_streams.SR,
                    outputs=SERVING_KEYS, device=dev)
    env64 = f64_consts(at, env, dev)
    padded = [env.pad(s) for s in served.signals]
    lengths = np.array([len(p) for p in padded])
    batch = np.zeros((len(padded), lengths.max()), np.float32)
    for i, p in enumerate(padded):
        batch[i, :len(p)] = p
    counts = [env.seg_cnt(n) for n in lengths]
    for tier, got in runs.items():
        check(sorted(got) == [(i, k) for i, c in enumerate(counts) for k in range(c)],
              f"serve_streams {tier}: not every (stream, segment) emitted once")
    ref_out, _ = at.BatchedSndEnv(env).process(batch, lengths)
    ii, kk, base = stack_segments(runs["float32"], SERVING_KEYS)
    ref = {key: getattr(ref_out, key).cpu().numpy()[ii, kk] for key in SERVING_KEYS}
    ratio, dmel, dk, _ = hold_segments(env64, base, ref,
                                       stacked_bounds(env64, batch, lengths, ii, kk),
                                       "serve_streams vs offline")
    _, _, half = stack_segments(runs["float16"], SERVING_KEYS)
    check(np.array_equal(half["step_valid"], base["step_valid"]),
          "serve_streams float16 step_valid differs")
    f16 = max(f16_share(half[k], base[k], f"serve_streams float16 {k}")
              for k in ("mel_fbank_segment", "gabor_kwta"))
    phase(15, f"serve_streams: {len(ii)} segments of {len(counts)} streams, each once; "
              f"float32 vs one offline BatchedSndEnv run: mel max abs {dmel:.3g} "
              f"({ratio:.2g} of the sum of float32 bounds), gabor_kwta max abs {dk:.3g}; "
              f"float16 within float16 rounding of float32 ({f16:.2g} of it)")

    text = io.StringIO()
    reset_launches(framefft)
    with contextlib.redirect_stdout(text):
        outs = process_speech.main([str(wav)])
    torch.cuda.synchronize()
    check(framefft.LAUNCHES == 0,
          f"process_speech launched the kernel {framefft.LAUNCHES} times")
    w = load_wav(str(wav))
    cpu = process_speech.process(w.sound_to_tensor(), w.sample_rate, "cpu")
    hottest = lambda runs_: [int(np.argmax(o["mel_fbank_segment"][:, :, 0].cpu().numpy()
                                           .mean(axis=1))) for o in runs_]
    check(len(outs) == len(cpu) >= 2, f"process_speech: {len(outs)} segments on the "
                                      f"card, {len(cpu)} on the CPU")
    check(hottest(outs) == hottest(cpu), f"process_speech: hottest bands "
                                         f"{hottest(outs)} on the card, {hottest(cpu)} on the CPU")
    lines = text.getvalue().strip().splitlines()
    phase(15, f"process_speech {wav.name}: {len(outs)} segments, 0 kernel launches, "
              f"hottest bands {sorted(set(hottest(outs)))} as on the CPU; first line "
              f"{lines[1]!r}; {time.perf_counter() - t0:.1f} s for the phase")
    return launches, poll


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
    # the native WAV decoder (host C++), built here so that no timed run
    # pays its compile
    from auditory_tpu_torch.io import native

    t0 = time.perf_counter()
    check(native.available(), f"native decoder unavailable: {native.build_error()}")
    phase(2, f"built the native WAV decoder (csrc/auditory_io.cpp, host C++) in "
             f"{time.perf_counter() - t0:.2f} s")
    for label, sr, nw in (("flagship 16 kHz", SR, 304), ("serving poll", SR, 14),
                          ("44.1 kHz", 44100, 300), ("48 kHz", 48000, 300),
                          ("96 kHz", 96000, 300)):
        t = at.WindowParams().derive(sr)
        for rows in (64, BATCH):
            lay = framefft.launch_shape(t.step_samples, t.win_samples, nw, rows,
                                        framefft.sm_count(dev))
            phase(2, f"{label}, B={rows}: {lay.consumers} consumer warpgroup(s) "
                     f"({64 * lay.consumers} windows a block) + 1 producer warp, "
                     f"{lay.ring} basis stages, "
                     + (f"the span in pieces of {lay.piece} samples through a ring of "
                        f"{lay.pbufs} buffers (a stager's warps)" if lay.piece
                        else "the whole span staged once")
                     + f", {lay.bytes} bytes of dynamic shared memory per block (at "
                     "every mel bank)")
    # the picker's bytes against the library's, for every layout it weighs,
    # and the band table's size at every mel bank
    pieced, differ, n_layouts = [], [], 0
    lib = framefft._lib()
    for sr in RATES:
        t = at.WindowParams().derive(sr)
        nw = grid_windows(t, bucket_length(int(SECONDS * sr), t))
        geom = (t.step_samples, t.win_samples, nw)
        for lay in framefft.layouts(*geom):
            n_layouts += 1
            if lib.framefft_shared_bytes(*geom, *lay[:4]) != lay.bytes:
                differ.append((sr, tuple(lay[:4])))
        for n_mel in LAYOUT_FILTERS + (320,):
            if lib.framefft_table_words(t.n_bins, n_mel) != framefft.table_words(
                    t.n_bins, n_mel):
                differ.append((sr, n_mel, "band table words"))
        if framefft.launch_shape(*geom).piece:
            pieced.append(f"{sr / 1000:g}")
    check(not differ, f"ops/framefft.py differs from the library at {differ[:5]}")
    phase(2, f"ops/framefft.py::shared_bytes equals the library's framefft_shared_bytes "
             f"on the {n_layouts} layouts that fit at {len(RATES)} rates (3 s rows; no "
             "layout depends on the mel bank), and table_words the library's "
             f"framefft_table_words at {len(LAYOUT_FILTERS) + 1} mel banks; for a large "
             f"batch plan_layout stages the span in pieces at (kHz): {', '.join(pieced)}")

    # 3. kernel against its plain version
    def geometry(sr, fbank=at.FilterBank(), window_fn=None, weights=None):
        # weights: a bank [n_mel, n_bins] in the design's place
        t = at.WindowParams().derive(sr)
        if weights is None:
            weights = design.mel_design(fbank, t.win_samples, sr).weights
        c = constants_from_numpy(
            weights, np.eye(1), np.zeros((1, 1, 1)),
            *design.dft_matrices(t.win_samples),
            design.analysis_window(window_fn, t.win_samples),
        )
        consts = [torch.as_tensor(c[k], dtype=torch.float32, device=dev)
                  for k in ("dft_cos", "dft_sin", "mel_w")]
        return t, consts, fbank

    def kernel_args(t, consts, fbank, sig, emit=(True, True), offset0=None,
                    step=None):
        seg = t.seg_cnt(sig.shape[-1])
        n_windows = (seg - 1) * (t.stride_samples // t.step_samples) + t.segment_steps
        if step is not None:
            # another step over the same window and basis: the windows that
            # start inside the signal, from offset0 on
            n_windows = (sig.shape[-1] - offset0 - 1) // step + 1
        args = (torch.as_tensor(sig, device=dev),
                t.step_samples if step is None else step,
                t.step_offsets[0] if offset0 is None else offset0, n_windows,
                *consts)
        kw = dict(n_bins=t.n_bins, n_mel=fbank.n_filters, dft=at.DFTParams(),
                  fbank=fbank, emit=emit)
        return args, kw

    n16 = bucket_length(int(SECONDS * SR), at.WindowParams().derive(SR))
    flag_sig, flag_len = bench_batch(rng, n16, SR, BATCH)
    t44 = at.WindowParams().derive(44100)

    def rate_batch(sr, b, noise=False):
        t = at.WindowParams().derive(sr)
        n = bucket_length(int(SECONDS * sr), t)
        return (noise_batch(rng, n, b) if noise else bench_batch(rng, n, sr, b))[0]

    # banks the design does not make: dense random weights (every filter
    # open across every pass boundary: past the carry slots, the staged
    # entries and the staged weights), and a filter with every weight 0
    n_bins16 = at.WindowParams().derive(SR).n_bins
    dense_bank = rng.random((320, n_bins16))
    empty_bank = design.mel_design(at.FilterBank(), 400, SR).weights.copy()
    empty_bank[5] = 0.0

    # label: (geometry, signals, emit, step); every case on bench_batch's
    # tone rows
    cases = {
        "flagship_16k_B512": (geometry(SR), flag_sig, (True, True), None),
        "44k1_B32": (geometry(44100), rate_batch(44100, 32), (True, True), None),
        "hamming_16k_B64": (geometry(SR, window_fn="hamming"), flag_sig[:64],
                            (True, True), None),
        "unpadded_16k_B8": (geometry(SR), flag_sig[:8, :3472], (True, True), None),
        "mel_only_16k_B512": (geometry(SR), flag_sig, (False, False), None),
        "nan_mel_8k_B16": (
            geometry(8000, at.FilterBank(n_filters=80, lo_hz=0.0, hi_hz=4000.0)),
            bench_batch(rng, 24000, 8000, 16)[0], (True, True), None),
        # the span in pieces, and many filters
        "48k_64mel_B16": (geometry(48000, at.FilterBank(n_filters=64)),
                          rate_batch(48000, 16), (True, True), None),
        "256mel_16k_B16": (geometry(SR, at.FilterBank(n_filters=256)), flag_sig[:16],
                           (True, True), None),
        "96k_B16": (geometry(96000), rate_batch(96000, 16), (True, True), None),
        "44k1_80mel_B4": (geometry(44100, at.FilterBank(n_filters=80)),
                          rate_batch(44100, 4), (True, True), None),
        "48k_128mel_B4": (geometry(48000, at.FilterBank(n_filters=128)),
                          rate_batch(48000, 4), (True, True), None),
        "88k2_64mel_B16": (geometry(88200, at.FilterBank(n_filters=64)),
                           rate_batch(88200, 16), (True, True), None),
        "96k_320mel_B4": (geometry(96000, at.FilterBank(n_filters=320)),
                          rate_batch(96000, 4), (True, True), None),
        "step8_16k_B4": (geometry(SR), flag_sig[:4], (True, True), 8),
        "dense_bank_320mel_16k_B16": (
            geometry(SR, at.FilterBank(n_filters=320), weights=dense_bank),
            flag_sig[:16], (True, True), None),
        "empty_filter_16k_B8": (geometry(SR, weights=empty_bank), flag_sig[:8],
                                (True, True), None),
    }
    errs = {"power": 0.0, "log_power": 0.0, "log_mel": 0.0}
    shares = {"kernel": 0.0, "plain_f32": 0.0}
    by_geometry = {}
    with precision_tier("highest"):
        for label, ((t, consts, fbank), sig, emit, step) in cases.items():
            args, kw = kernel_args(t, consts, fbank, sig, emit,
                                   offset0=None if step is None else -200, step=step)
            before = framefft.LAUNCHES
            got = framefft.fused_frame_power_mel(*args, **kw)
            torch.cuda.synchronize()
            check(framefft.LAUNCHES == before + 1, f"{label}: the kernel did not launch")
            lay = picked_layout(framefft, args, t.win_samples)
            ref, bounds = frontend_model(framefft, args, kw)
            e, sk = compare(got, ref, bounds, label)
            sp = model_share(framefft.fused_frame_power_mel_reference(*args, **kw), ref,
                             bounds)
            shares = {"kernel": max(shares["kernel"], sk),
                      "plain_f32": max(shares["plain_f32"], sp)}
            by_geometry[label] = sk
            nans = int(torch.isnan(got[2]).sum())
            phase(3, f"{label} ({lay.kind}, layout {tuple(lay[:4])}): max |kernel - "
                     f"plain float64| power {e[0]:.3g}, "
                     f"log_power {e[1]:.3g}, log_mel {e[2]:.3g}; worst share of the "
                     f"float32 bound {sk:.3g} (the plain version's float32 run: "
                     f"{sp:.3g}); NaN log_mel {nans} (identical positions)")
            if t.win_samples > 400:
                # the control, where a window sums more terms than the
                # flagship's 400: TF32 products must fail the float32 bound
                with framefft.tf32_flags((True, True)):
                    ctl = framefft.fused_frame_power_mel_reference(*args, **kw)
                sc = model_share(ctl[:2], ref[:2], bounds[:2])
                check(sc > 1.0, f"{label}: the plain version with TF32 on is within "
                                f"the float32 bound ({sc:.3g} of it)")
                phase(3, f"{label}: control: the plain version with TF32 on is at "
                         f"{sc:.3g} of the float32 bound (fails, as it must)")
            for k, v in zip(errs, e):
                errs[k] = max(errs[k], v)
            del got, ref, bounds
        phase(3, "worst share of the float32 bound by geometry: " + json.dumps(
            {k: round(v, 4) for k, v in by_geometry.items()}))
        # one geometry through the whole span and in pieces with two and
        # with one warpgroup: each k16 step's partial sum and the mel sum
        # keep their order in every layout, so the outputs are the same bits
        t, consts, fbank = geometry(44100)
        args, kw = kernel_args(t, consts, fbank, rate_batch(44100, 32))
        fits = framefft.layouts(t.step_samples, t.win_samples, args[3])
        trio = [next(lay for lay in fits if not lay.piece)] + [
            next(lay for lay in fits if lay.piece and lay.consumers == c) for c in (2, 1)]
        outs = []
        for lay in trio:
            with forced_layout(framefft, lay):
                outs.append(framefft.fused_frame_power_mel(*args, **kw))
        torch.cuda.synchronize()
        for lay, out in zip(trio[1:], outs[1:]):
            for name, a, b in zip(("power", "log power", "log mel"), outs[0], out):
                check(bit_equal(a, b), f"44.1 kHz: {name} differs between the layouts "
                                       f"{tuple(trio[0][:4])} and {tuple(lay[:4])}")
        phase(3, "44k1_B32 through " + ", ".join(f"{tuple(lay[:4])} ({lay.kind})"
                                                 for lay in trio)
                 + ": power, log power and log mel bit for bit equal")
        del outs
        nonfinite_phase(framefft, geometry, kernel_args, rate_batch, dense_bank)
        # the timed geometries at B=64 and a corpus batch of 512
        piece_times = []
        for sr, n_mel in TIMED_GEOMETRIES:
            t, consts, fbank = geometry(sr, at.FilterBank(n_filters=n_mel))
            for b in (64, BATCH):
                args, kw = kernel_args(t, consts, fbank, rate_batch(sr, b))
                lay = picked_layout(framefft, args, t.win_samples)
                row = time_frontend(framefft, args, kw)
                piece_times.append({"geometry": f"{sr / 1000:g} kHz, {n_mel} filters",
                                    "batch": b, "layout": list(lay[:4]),
                                    "kind": lay.kind, **row})
                phase(3, f"[{name_limit}] {sr / 1000:g} kHz, {n_mel} filters, B={b} x "
                         f"{SECONDS:g} s, layout {tuple(lay[:4])}: kernel "
                         f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms by "
                         f"{row['bound_by']}), plain PyTorch {row['plain_ms']:.4f} ms, "
                         f"FP32 torch.matmul of the frames {row['library_ms']:.4f} ms, "
                         f"the whole function in plain calls on the frames "
                         f"{row['library_function_ms']:.4f} ms (median of 10, CUDA "
                         "events)")
                if (sr, n_mel, b) == (96000, 320, BATCH):
                    dense = frontend_bound(b, args[0].shape[1], args[3], t.win_samples,
                                           t.n_bins, n_mel, 6, kw["emit"],
                                           t.n_bins * n_mel)
                    phase(3, f"96 kHz, 320 filters, B={b}: the bound counts the mel "
                             f"sum's {mel_terms(consts[2], t.n_bins, n_mel)} nonzero "
                             f"weights a window ({row['bound_ms']:.4f} ms); counted "
                             f"dense ({t.n_bins * n_mel} a window) it would be "
                             f"{dense[0]:.4f} ms by {dense[1]}")
                del args
        # the per-segment route's geometry (SndEnv(segment_frontend=
        # 'per_segment') at 22.05 kHz, phase 6): each segment's span of B
        # rows of 3 s one row of the kernel's signals, 14 windows a row from
        # offset 0 (step 221, window 551: 9 k chunks, 276 bins in 5 passes)
        t22, consts22, fbank22 = geometry(22050)
        seg_args = {}
        for b in (64, BATCH):
            label = f"per_segment_22k05_B{b}"
            args, kw = per_segment_args(at, dev, t22, consts22, fbank22,
                                        rate_batch(22050, b))
            before = framefft.LAUNCHES
            got = framefft.fused_frame_power_mel(*args, **kw)
            torch.cuda.synchronize()
            check(framefft.LAUNCHES == before + 1, f"{label}: the kernel did not launch")
            lay = picked_layout(framefft, args, t22.win_samples)
            ref, bounds = frontend_model(framefft, args, kw)
            e, sk = compare(got, ref, bounds, label)
            sp = model_share(framefft.fused_frame_power_mel_reference(*args, **kw), ref,
                             bounds)
            shares = {"kernel": max(shares["kernel"], sk),
                      "plain_f32": max(shares["plain_f32"], sp)}
            for k, v in zip(errs, e):
                errs[k] = max(errs[k], v)
            del got, ref, bounds
            row = time_frontend(framefft, args, kw)
            piece_times.append({"geometry": "22.05 kHz, 32 filters, per-segment spans",
                                "batch": b, "rows": args[0].shape[0],
                                "layout": list(lay[:4]), "kind": lay.kind, **row})
            phase(3, f"{label} ({args[0].shape[0]} spans of {args[0].shape[1]} samples, "
                     f"{args[3]} windows a span, offset0 0; layout {tuple(lay[:4])}, "
                     f"{lay.kind}): max |kernel - plain float64| power {e[0]:.3g}, "
                     f"log_power {e[1]:.3g}, log_mel {e[2]:.3g}; worst share of the "
                     f"float32 bound {sk:.3g} (the plain version's float32 run: {sp:.3g})")
            phase(3, f"[{name_limit}] {label}: kernel {row['ms']:.4f} ms (bound "
                     f"{row['bound_ms']:.4f} ms by {row['bound_by']}), plain PyTorch "
                     f"{row['plain_ms']:.4f} ms, FP32 torch.matmul of the frames "
                     f"{row['library_ms']:.4f} ms, the whole function in plain calls on "
                     f"the frames {row['library_function_ms']:.4f} ms (median of 10, "
                     "CUDA events)")
            seg_args[b] = (args, kw)
        per_segment_row = piece_times[-1]
        # the serving poll's geometry: N=512 rows of one poll span each, the
        # border offset moving window 0 to sample 0 (14 windows per row)
        span = at.OnlineSndEnv(flagship_cfg(at), SR, device=dev)._span
        serving_sig = np.ascontiguousarray(flag_sig[:, :span])
        args, kw = kernel_args(*geometry(SR), serving_sig, offset0=0)
        got = framefft.fused_frame_power_mel(*args, **kw)
        torch.cuda.synchronize()
        e, s_serving = compare(got, *frontend_model(framefft, args, kw),
                               "serving_16k_N512")
        for k, v in zip(errs, e):
            errs[k] = max(errs[k], v)
        serving_ms = cuda_ms(lambda: framefft.fused_frame_power_mel(*args, **kw))
        serving_plain_ms = cuda_ms(
            lambda: framefft.fused_frame_power_mel_reference(*args, **kw))
        phase(3, f"serving_16k_N512 (S={span}, {args[3]} windows per row, "
                 f"offset0 0): max |kernel - plain float64| power {e[0]:.3g}, log_power "
                 f"{e[1]:.3g}, log_mel {e[2]:.3g}; worst share of the float32 bound "
                 f"{s_serving:.3g}")
        phase(3, f"[{name_limit}] serving_16k_N512: kernel {serving_ms:.4f} ms, "
                 f"plain PyTorch {serving_plain_ms:.4f} ms (median of 10, CUDA "
                 "events)")
        phase(3, f"serving_16k_N512: one call launches {device_kernels(framefft, args, kw)}")
        serving_args = (args, kw)
        # the lower grades. The kernel and the plain version's limb emulation
        # form the same products in other sum orders: the kernel is held to
        # the emulation within the bound of two such runs (no grade term),
        # and each to the float64 plain version within its grade's bound.
        # The grade shows: passes=1 leaves the exact grade's bound in every
        # output, and on the tone rows of the CPU controls
        # (tests/test_torch_f32_bounds.py: a 1234 Hz tone with 0.01 noise, a
        # 0.2 noise row) passes=3 leaves it in power, log power and log mel
        def tone_rows(sr):
            n = bucket_length(int(SECONDS * sr), at.WindowParams().derive(sr))
            tt = np.arange(n) / sr
            trng = np.random.default_rng(1234)
            return np.stack([
                0.5 * np.sin(2 * np.pi * 1234.0 * tt) + 0.01 * trng.standard_normal(n),
                0.2 * trng.standard_normal(n)]).astype(np.float32)

        grade_shares, pair_shares, exact_shares = {}, {}, {}
        for label, (gargs, gkw) in (
                ("flagship_16k_B512", kernel_args(*geometry(SR), flag_sig)),
                ("serving_16k_N512", serving_args),
                ("tone_16k_B2", kernel_args(*geometry(SR), tone_rows(SR))),
                ("per_segment_22k05_B512", seg_args[BATCH]),
                ("tone_22k05_spans_B2", per_segment_args(at, dev, t22, consts22, fbank22,
                                                         tone_rows(22050)))):
            ref = plain_f64(framefft, gargs, gkw)
            exact = model_bounds(gargs, gkw, ref[0])
            for passes in (3, 1):
                got = framefft.fused_frame_power_mel(*gargs, **gkw, passes=passes)
                torch.cuda.synchronize()
                emu = framefft.fused_frame_power_mel_reference(*gargs, **gkw, passes=passes)
                e, sh_pair = compare(got, emu, model_bounds(gargs, gkw, emu[0], passes,
                                                            pair=True),
                                     f"{label} passes={passes} vs emulation")
                bounds = model_bounds(gargs, gkw, ref[0], passes)
                sh = [model_share((g,), (r,), (b,)) for g, r, b in zip(got, ref, bounds)]
                check(max(sh) <= 1.0, f"{label} passes={passes}: at {max(sh):.3g} of "
                                      "the grade's float32 bound")
                sh_emu = model_share(emu, ref, bounds)
                check(sh_emu <= 1.0, f"{label} passes={passes}: the limb emulation at "
                                     f"{sh_emu:.3g} of the grade's float32 bound")
                lo = [model_share((g,), (r,), (b,)) for g, r, b in zip(got, ref, exact)]
                # where the grade must show: passes=1 in every output; passes=3
                # on the tone rows, in every output at 16 kHz, in power and log
                # power on the 22.05 kHz spans (the limb emulation's log mel
                # there sits at 1.02 of the exact bound on the CPU: too close)
                shows = (lo if passes == 1 or label == "tone_16k_B2"
                         else lo[:2] if label.startswith("tone_") else [])
                if shows:
                    check(min(shows) > 1.0, f"{label} passes={passes}: within the "
                                            f"exact grade's bound in an output ({lo}): "
                                            "the grade does not show")
                grade_shares[f"{label}_passes{passes}"] = sh
                pair_shares[f"{label}_passes{passes}"] = sh_pair
                exact_shares[f"{label}_passes{passes}"] = lo
                phase(3, f"{label} passes={passes}: max |kernel - limb emulation| "
                         f"power {e[0]:.3g}, log_power {e[1]:.3g}, log_mel {e[2]:.3g}, at "
                         f"{sh_pair:.3g} of the bound of two sum orders; vs the float64 "
                         f"plain at {sh[0]:.3g} / {sh[1]:.3g} / {sh[2]:.3g} of the grade's "
                         f"float32 bound (the emulation at {sh_emu:.3g}) and at "
                         f"{lo[0]:.3g} / {lo[1]:.3g} / {lo[2]:.3g} of the exact grade's")
            del ref, got, emu, bounds, exact
        # the prologue on the card: the basis limbs bit for bit, the band
        # table word for word where the kernel reads it
        for label, (t, consts, fbank) in (
                ("16 kHz", geometry(SR)), ("44.1 kHz", geometry(44100)),
                ("96 kHz, 320 filters", geometry(96000, at.FilterBank(n_filters=320))),
                ("8 kHz, 80 filters (NaN weights)", geometry(
                    8000, at.FilterBank(n_filters=80, lo_hz=0.0, hi_hz=4000.0))),
                ("16 kHz, dense random bank", geometry(
                    SR, at.FilterBank(n_filters=320), weights=dense_bank)),
                ("16 kHz, an empty filter", geometry(SR, weights=empty_bank))):
            n_mel = fbank.n_filters
            for passes in PASSES:
                a, tab = framefft.prologue_on_card(consts[0], consts[1], consts[2],
                                                   t.n_bins, n_mel, passes)
                b = framefft.pack_basis_limbs(consts[0], consts[1], t.n_bins, passes)
                check(torch.equal(a.view(torch.int16), b.view(torch.int16)),
                      f"basis limbs packed on the card differ at {label}, "
                      f"passes={passes}")
                check(band_table_equal(framefft, tab, framefft.band_table(
                    consts[2], t.n_bins, n_mel), t.n_bins, n_mel),
                      f"the band table built on the card differs at {label}")
        phase(3, "the prologue on the card: basis limbs equal pack_basis_limbs bit for "
                 "bit, and the band table band_table word for word (16, 44.1 kHz, 96 "
                 "kHz with 320 filters, 8 kHz with NaN weights, a dense random bank, "
                 "an empty filter; passes 1, 3, 6)")

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

    reset_launches(framefft)
    one = env.process(env.pad(wave.sound_to_tensor()))
    res, seg_valid = benv.process(flag_sig, flag_len)
    torch.cuda.synchronize()
    launches = main_launches(framefft)
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
        for f in FLOAT_FIELDS:
            check(bool(torch.isfinite(getattr(out, f)).all()), f"{f} not finite")

    worst = hold_to_cpu_f64(at, env, res, seg_valid, flag_sig, flag_len)
    phase(4, f"slice ok: {launches} kernel launches; WAV tone band {band} "
             f"({env.mel_des.hz_pts[band]:.0f}-{env.mel_des.hz_pts[band + 2]:.0f} Hz); "
             f"GPU float32 vs CPU float64 (B=8) max abs: "
             + ", ".join(f"{k} {v}" for k, v in worst.items()))

    # 5. times on the card: the kernel at each grade against its bound, the
    # plain version, and plain calls on prebuilt frames (library_times, TF32
    # off; the port never calls them)
    timing = {}
    with precision_tier("highest"):
        for label, (targs, tkw) in (("flagship", kernel_args(*geometry(SR), flag_sig)),
                                    ("serving", serving_args)):
            sig5, _, _, nw5, cos5, _, mel5 = targs[:7]
            b5, s5 = sig5.shape
            row = {"plain_ms": cuda_ms(
                lambda: framefft.fused_frame_power_mel_reference(*targs, **tkw))}
            for passes in PASSES:
                row[passes] = cuda_ms(
                    lambda: framefft.fused_frame_power_mel(*targs, **tkw, passes=passes))
                row[f"bound{passes}"] = frontend_bound(
                    b5, s5, nw5, cos5.shape[0], tkw["n_bins"], tkw["n_mel"],
                    passes, tkw["emit"], mel_terms(mel5, tkw["n_bins"], tkw["n_mel"]))
            row["library_ms"], row["library_function_ms"] = library_times(targs, tkw)
            timing[label] = row
            phase(5, f"[{name_limit}] frontend {label} (B={b5} x {s5} samples, "
                     f"{nw5} windows a row): kernel "
                     + ", ".join(f"passes={q} {row[q]:.4f} ms (bound {row[f'bound{q}'][0]:.4f} "
                                 f"ms by {row[f'bound{q}'][1]}, {row[f'bound{q}'][0] / row[q]:.1%})"
                                 for q in PASSES)
                     + f"; plain PyTorch (float32 matmuls) {row['plain_ms']:.4f} ms; "
                     f"torch.matmul of the prebuilt frames by the [win, 2 n_bins] "
                     f"basis, FP32 {row['library_ms']:.4f} ms; the whole function in "
                     f"plain calls on the frames {row['library_function_ms']:.4f} ms "
                     "(median of 10, CUDA events)")
    kernel_ms, plain_ms = timing["flagship"][6], timing["flagship"]["plain_ms"]
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
    launches_7, stats7 = corpus_phase(at, dev, name_limit, wav_dir / "corpus")

    # 8. serving: OnlineSndEnv and MultiStreamOnline over 512 streams
    launches_8, streams_8, base_8 = serving_phase(at, dev, name_limit)

    # 9. the processspeech StreamingProcessor (no kernel on its path)
    streaming_phase(at, dev, name_limit)

    # 10. training: gradients through the kernel, the trainers,
    # SegmentPipeline and FeatureDataset
    with precision_tier("highest"):
        grad_err, grad_ms, grad_plain_ms = kernel_grad_phase(
            framefft, *kernel_args(*geometry(SR), flag_sig), name_limit)
    launches_10 = sndenv_grad_phase(at, framefft, dev, name_limit, flag_sig, flag_len)
    launches_10 += trainers_phase(framefft, dev, name_limit)
    launches_10 += segments_phase(at, framefft, dev, name_limit, wave, flag_sig)
    dataset_phase(at, dev, wav_dir / "corpus" / "out")

    # 11. the frontend's route: the geometries the kernel cannot hold
    launches_11 = routes_phase(at, framefft, dev, name_limit, rng)

    # 12. the multi-process paths, the segment-sharded run and mesh serving
    launches_12 = multirank_phase(at, framefft, dev, name_limit, wav_dir, stats7,
                                  (streams_8, base_8))

    # 13. the native decoder and the CLI
    launches_13 = native_cli_phase(at, framefft, dev, name_limit, wav_dir,
                                   wav_dir / "tone2000.wav", one)

    # 14. tests/test_fuzz_parity.py's configurations on the card
    launches_14, fuzz_worst = fuzz_phase(at, framefft, dev, name_limit,
                                         fuzz_entries(at))

    # 15. the serve_streams and process_speech examples
    launches_15, example_poll_ms = examples_phase(at, framefft, dev, name_limit,
                                                  wav_dir / "tone2000.wav")

    # the kernel by block layout: launches on the main path, and times
    # (phase 5's flagship and serving shapes, phase 3's piece geometries)
    total = (launches + launches_6 + launches_7 + launches_8 + launches_10
             + launches_11 + launches_12 + launches_13 + launches_14 + launches_15)
    check(sum(MAIN_LAYOUT_LAUNCHES.values()) == total,
          f"launches by layout {MAIN_LAYOUT_LAUNCHES} do not add up to {total}")
    by_kind = {}
    for label, (targs, tkw) in (("flagship", kernel_args(*geometry(SR), flag_sig[:1])),
                                ("serving", serving_args)):
        t16 = at.WindowParams().derive(SR)
        lay = framefft.launch_shape(targs[1], t16.win_samples, targs[3])
        row = timing[label]
        by_kind.setdefault(lay.kind, []).append({
            "geometry": f"16 kHz, 32 filters, {label}", "batch": targs[0].shape[0]
            if label == "serving" else BATCH, "layout": list(lay[:4]), "ms": row[6],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound6"][0],
            "bound_by": row["bound6"][1], "library_ms": row["library_ms"],
            "library_function_ms": row["library_function_ms"]})
    for row in piece_times:
        by_kind.setdefault(row["kind"], []).append(
            {k: v for k, v in row.items() if k != "kind"})
    layouts_line = [{"layout": kind, "launches": MAIN_LAYOUT_LAUNCHES.get(kind, 0),
                     "timings": by_kind.get(kind, [])} for kind in ("whole span", "pieces")]
    print(json.dumps({"kernels": [{
        "name": "fused_frame_power_mel",
        "route": "cuda",
        "source": "auditory_tpu_torch/csrc/framefft.cu",
        "replaces": "auditory_tpu/ops/framefft.py:715",
        "launches": total,
        "max_abs_err": errs["log_mel"],
        "max_abs_err_power": errs["power"],
        "max_abs_err_log_power": errs["log_power"],
        "passes": 6,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": timing["flagship"]["bound6"][0],
        "bound_by": timing["flagship"]["bound6"][1],
        "library_ms": timing["flagship"]["library_ms"],
        "library_function_ms": timing["flagship"]["library_function_ms"],
        "ms_by_passes": {q: timing["flagship"][q] for q in PASSES},
        "bound_ms_by_passes": {q: timing["flagship"][f"bound{q}"][0] for q in PASSES},
        "grade_bound_shares": grade_shares,
        "pair_bound_shares": pair_shares,
        "exact_bound_shares": exact_shares,
        "kernel_bound_share": shares["kernel"],
        "plain_f32_bound_share": shares["plain_f32"],
        "serving_ms": serving_ms,
        "serving_plain_ms": serving_plain_ms,
        "serving_ms_by_passes": {q: timing["serving"][q] for q in PASSES},
        "serving_bound_ms": timing["serving"]["bound6"][0],
        "serving_library_ms": timing["serving"]["library_ms"],
        "per_segment_22k05_ms": per_segment_row["ms"],
        "per_segment_22k05_plain_ms": per_segment_row["plain_ms"],
        "per_segment_22k05_bound_ms": per_segment_row["bound_ms"],
        "per_segment_22k05_library_ms": per_segment_row["library_ms"],
        "fwd_bwd_ms": grad_ms,
        "plain_fwd_bwd_ms": grad_plain_ms,
        "grad_max_rel_err": grad_err,
        "fuzz_launches": launches_14,
        "fuzz_worst_bound_share": max(max(v.values()) for v in fuzz_worst.values()),
        "serve_streams_launches": launches_15,
        "serve_streams_poll_ms": example_poll_ms,
        "layouts": layouts_line,
    }]}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(sys.argv[2:])
    else:
        main()
