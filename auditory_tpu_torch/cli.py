"""Command-line interface of the PyTorch/CUDA port (counterpart of
``auditory_tpu/cli.py``, with its commands and flags plus ``--device``).

CLI equivalents of the reference example apps:

- ``process``  <- examples/processspeech (single WAV -> power/mel/MFCC/gabor
  tensors, written to .npz instead of rendered in a GoGi grid)
- ``corpus``   <- the corpus-scale batch path (TIMIT-style extraction), on
  one device, a device mesh (``--mesh``), a host's slice of the files
  (``--shard``) or a process group (``--coordinator``)
- ``corpus-merge``, ``segment``, ``info``, ``table``, ``viz``
- ``play``     <- examples/play (host audio out; gated on an available audio
  backend, otherwise reports and exits)

The pipeline commands run on the card (``--device cuda``, the default, never
a silent fall back to the host) unless ``--device cpu`` is given; ``--f64``
runs float64 on the CPU. Every flag is checked before a ``--coordinator``
run joins its process group, so no rank leaves after the handshake.

Usage: ``python -m auditory_tpu_torch.cli process sounds/bug.wav --out
out.npz [--device cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import glob as _glob
import json
import os
import sys

import numpy as np
import torch

from .config import (
    DFTParams,
    FilterBank,
    GaborSet,
    MelParams,
    SndEnvConfig,
    WindowParams,
    default_gabor_specs,
    resolve_device,
)
from .io.wav import load_wav
from .pipeline.sndenv import SndEnv


def _build_cfg(args) -> SndEnvConfig:
    gset = GaborSet(
        size_x=args.gabor_size,
        size_y=args.gabor_size,
        stride_x=args.gabor_stride,
        stride_y=args.gabor_stride,
        gain=args.gabor_gain,
        specs=default_gabor_specs(
            phases=(0.0, 1.5708) if args.gabor_phases == 2 else (0.0,)
        ),
    )
    return SndEnvConfig(
        params=WindowParams(
            win_ms=args.win_ms,
            step_ms=args.step_ms,
            segment_ms=args.segment_ms,
            stride_ms=args.stride_ms,
            border_steps=args.border_steps,
        ),
        dft=DFTParams(window_fn=args.window_fn),
        mel=MelParams(
            fbank=FilterBank(n_filters=args.mel_filters, hi_hz=args.hi_hz),
            mfcc=not args.no_mfcc,
            deltas=not args.no_mfcc,
        ),
        gabor=gset,
        kwta=dataclasses.replace(SndEnvConfig().kwta, on=not args.no_kwta),
    )


def _add_pipeline_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--win-ms", type=float, default=25.0)
    p.add_argument("--step-ms", type=float, default=10.0)
    p.add_argument("--segment-ms", type=float, default=100.0)
    p.add_argument("--stride-ms", type=float, default=100.0)
    p.add_argument("--border-steps", type=int, default=2)
    p.add_argument("--mel-filters", type=int, default=32)
    p.add_argument("--hi-hz", type=float, default=8000.0)
    p.add_argument("--no-mfcc", action="store_true")
    p.add_argument("--no-kwta", action="store_true")
    p.add_argument("--gabor-size", type=int, default=9)
    p.add_argument("--gabor-stride", type=int, default=3)
    p.add_argument("--gabor-gain", type=float, default=2.0)
    p.add_argument("--gabor-phases", type=int, default=2, choices=(1, 2))
    p.add_argument(
        "--window-fn", choices=("hamming", "hann"), default=None,
        help="opt-in analysis window folded into every DFT frontend "
        "(SURVEY extension; the reference applies NONE -- rectangular "
        "straight into the FFT, dft/dft.go:42-59; omit for parity)",
    )
    p.add_argument("--f64", action="store_true",
                   help="float64 parity mode, on the CPU whatever --device")
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="where the pipeline runs: cuda (default; the card, never a "
        "silent fall back to the host), cuda:N, or cpu",
    )


def _frontend_refused(args) -> bool:
    """``--frontend`` other than ``auto``: the JAX package's TPU
    formulations of the DFT (conv, frames, windowed, sliced, factored, fft)
    have no counterpart in the port, whose frontend is one route (the fused
    kernel on a uniform window grid it holds, the window gather elsewhere;
    ``SndEnv.route``). Refused up front with a clean error."""
    if getattr(args, "frontend", "auto") == "auto":
        return False
    print(
        f"error: --frontend {args.frontend} is one of the JAX package's TPU "
        "formulations of the DFT; the PyTorch port has one frontend (the "
        "fused CUDA kernel on a uniform window grid it holds, the window "
        "gather elsewhere): pass --frontend auto or leave it out",
        file=sys.stderr,
    )
    return True


def _add_frontend_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--frontend",
        choices=("auto", "conv", "frames", "windowed", "sliced", "factored",
                 "fft"),
        default="auto",
        help="spectrum frontend. Only auto is taken: the fused CUDA kernel "
        "on a uniform window grid it holds, the window gather elsewhere "
        "(SndEnv.route); the other values name the JAX package's TPU "
        "formulations of the DFT and are refused with an error",
    )


def _add_precision_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--precision", choices=("highest", "high", "default"),
        default="highest",
        help="contraction precision of the float32 matmuls and convolutions "
        "(SndEnv matmul_precision): highest and high switch TF32 off (IEEE "
        "float32), default allows TF32 (~5e-4 relative). The fused kernel "
        "runs its exact float32 grade at every tier",
    )


def _device_and_dtype(args):
    """(device, dtype) of a pipeline command: float64 on the CPU under
    --f64, else float32 on --device (resolved now: a missing card raises
    here, before any work)."""
    if getattr(args, "f64", False):
        return torch.device("cpu"), torch.float64
    return resolve_device(args.device), torch.float32


def cmd_process(args) -> int:
    if _frontend_refused(args):
        return 2
    device, dtype = _device_and_dtype(args)
    w = load_wav(args.file)
    if args.channel >= 0 and w.channels > 1:
        sig = w.channel_signal(args.channel)
        channels = 1
    else:
        # reference SoundToTensor semantics (sound/sound.go:116-127)
        sig = w.sound_to_tensor()
        channels = w.channels
    cfg = _build_cfg(args)
    try:
        env = SndEnv(
            cfg, w.sample_rate, dtype=dtype, channels=channels,
            matmul_precision=args.precision, device=device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.silence_add or args.silence_existing:
        # SndEnv.AdjustForSilence (sndenv.go:274-294): trim/pad leading
        # silence to the requested amount
        sig, _off = env.adjust_for_silence(
            sig, args.silence_add, args.silence_existing
        )
    if args.pad:
        sig = env.pad(sig)
    out = env.process(sig)
    arrays = {
        f.name: getattr(out, f.name).cpu().numpy()
        for f in dataclasses.fields(out)
        if getattr(out, f.name) is not None
    }
    np.savez(args.out, **arrays)
    n_seg = arrays["power_segment"].shape[0]
    print(
        f"{args.file}: {w.sample_rate} Hz, {w.num_frames} frames -> "
        f"{n_seg} segments; wrote {sorted(arrays)} to {args.out}"
    )
    return 0


def cmd_corpus_merge(args) -> int:
    from .pipeline.batch import CorpusRunner

    try:
        summary = CorpusRunner.merge_shards(args.out)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary))
    return 0


def _corpus_flags(args):
    """Every check of ``corpus``'s flags, all before a process group is
    joined. Returns (shard_index, num_shards, device, dtype) or an exit
    code."""
    distributed = bool(args.coordinator)
    if distributed:
        if args.shard:
            print("error: --shard and --coordinator are exclusive (the "
                  "distributed path shards by rank automatically)",
                  file=sys.stderr)
            return 2
        if args.mesh:
            # each rank runs its own file shard on its own device: a mesh
            # over the process group would tie the ranks' batches together
            print("error: --mesh and --coordinator are exclusive (each "
                  "process computes its file shard on its own device; use "
                  "BatchedSndEnv.process_local via the API for one program "
                  "over the processes)", file=sys.stderr)
            return 2
        if args.num_processes < 1 or not (
            0 <= args.process_id < args.num_processes
        ):
            print("error: --coordinator requires --num-processes N and "
                  "--process-id in [0, N)", file=sys.stderr)
            return 2
    shard_index, num_shards = 0, 1
    if args.shard:
        try:
            si, ns = args.shard.split("/")
            shard_index, num_shards = int(si), int(ns)
        except ValueError:
            shard_index, num_shards = -1, 0
        if not 0 <= shard_index < num_shards:
            print(f"error: --shard must be I/N with 0 <= I < N, got "
                  f"{args.shard!r}", file=sys.stderr)
            return 2
    if args.f16_features and args.int8_features:
        print("error: --f16-features and --int8-features are exclusive",
              file=sys.stderr)
        return 2
    if _frontend_refused(args):
        return 2
    try:
        device, dtype = _device_and_dtype(args)
        # the configuration's own checks (mel range, gabor size), on the
        # host so that nothing touches the card before the handshake
        SndEnv(_build_cfg(args), args.rate, dtype=dtype, device="cpu")
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return shard_index, num_shards, device, dtype


def cmd_corpus(args) -> int:
    checked = _corpus_flags(args)
    if isinstance(checked, int):
        return checked
    shard_index, num_shards, device, dtype = checked
    if not args.coordinator:
        return _corpus_run(args, device, dtype, shard_index, num_shards)
    # after this no rank returns early: an exit here would leave the sibling
    # ranks waiting in a collective
    from .parallel.distributed import initialize, shutdown

    device = initialize(
        args.coordinator, args.num_processes, args.process_id, device=device,
    )
    try:
        return _corpus_run(args, device, dtype, shard_index, num_shards)
    finally:
        shutdown()


def _corpus_run(args, device, dtype, shard_index, num_shards) -> int:
    from .parallel.mesh import make_mesh
    from .pipeline.batch import CorpusRunner

    distributed = bool(args.coordinator)
    paths = sorted(_glob.glob(args.glob))
    if not paths:
        if distributed:
            # do NOT exit before run_distributed's digest exchange: an empty
            # list either matches every rank (all agree, a zero-file run
            # merges cleanly) or disagrees (the digest guard raises the
            # same clean error on every rank)
            print(f"warning: no files match {args.glob}; proceeding into "
                  "the distributed digest exchange", file=sys.stderr)
        else:
            print(f"no files match {args.glob}", file=sys.stderr)
            return 1
    mesh = None
    if args.mesh:
        mesh = make_mesh() if device.type == "cuda" else make_mesh([device])
    runner = CorpusRunner(
        _build_cfg(args),
        args.rate,
        batch_size=args.batch_size,
        dtype=dtype,
        mesh=mesh,
        transfer=args.transfer,
        transfer_dtype=(
            "int8" if args.int8_features
            else torch.float16 if args.f16_features else None
        ),
        pipeline_depth=args.pipeline_depth,
        matmul_precision=args.precision,
        device=None if mesh is not None else device,
    )
    report = {}
    if distributed:
        from .parallel import distributed as dist_mod

        report["backend"] = dist_mod.data_backend()
        stats, summary = runner.run_distributed(
            paths, args.out, resume=not args.no_resume
        )
        if summary is not None:
            print(json.dumps({"merged": summary}))
    else:
        stats = runner.run(paths, args.out, resume=not args.no_resume,
                           shard_index=shard_index, num_shards=num_shards)
    print(
        json.dumps(
            {
                "files_done": stats.files_done,
                "files_failed": stats.files_failed,
                "audio_seconds": round(stats.audio_seconds, 3),
                "wall_seconds": round(stats.wall_seconds, 3),
                "rtf": round(stats.rtf, 1),
                "decoded": runner.decode_counts,
                **report,
            }
        )
    )
    return 0


def _segment_slice(args, prefix="") -> tuple:
    """Resolve a (start_ms, end_ms, label) slice from --phn/--unit or
    --start-ms/--end-ms (B side falls back to the A side's slice when its
    own flags are unset, like gaborview's independent CurSnd1/CurSnd2)."""
    from .speech import timit

    g = lambda name: getattr(args, prefix + name)
    start_ms, end_ms = g("start_ms"), g("end_ms")
    label = None if prefix else "(time slice)"
    unit = g("unit")
    if args.phn and (not prefix or unit is not None):
        units = timit.load_times(args.phn, fuse=args.fuse)
        idx = unit if unit is not None else 0
        if not 0 <= idx < len(units):
            raise ValueError(
                f"unit index {idx} out of range (file has {len(units)})"
            )
        u = units[idx]
        start_ms, end_ms, label = u.start, u.end, u.name
    return start_ms, end_ms, label


def _segment_pipeline(args, w, prefix=""):
    """Build a SegmentPipeline from (possibly B-prefixed) CLI flags; any
    unset B flag inherits the A value (gbv.go:243-258 dual param stacks)."""
    from .pipeline.segments import SegmentPipeline, SegmentWindowParams

    device, dtype = _device_and_dtype(args)

    def g(name):
        v = getattr(args, prefix + name, None) if prefix else None
        return getattr(args, name) if v is None else v

    gset = GaborSet(
        size_x=g("gabor_size"), size_y=g("gabor_size"),
        stride_x=g("gabor_stride_x"), stride_y=g("gabor_stride_y"),
        gain=g("gabor_gain"),
        specs=default_gabor_specs(
            phases=(0.0, 1.5708) if g("gabor_phases") == 2 else (0.0,)
        ),
    )
    return SegmentPipeline(
        w.sample_rate,
        SegmentWindowParams(
            win_ms=g("win_ms"), step_ms=g("step_ms"),
            resize=not args.no_resize,
        ),
        dft=DFTParams(window_fn=g("window_fn")),
        mel=MelParams(fbank=FilterBank(n_filters=g("mel_filters"))),
        gabor=gset,
        dtype=dtype,
        device=device,
    )


def cmd_segment(args) -> int:
    """Headless gaborview: process one phone/time-slice of an utterance;
    with --compare, run a second (B) parameter stack on the same (or another)
    slice and report the differences -- the reference app's A/B capability
    (gbv.go:243-258, 952-1207)."""
    from .pipeline.segments import compare_segments

    w = load_wav(args.file)
    sig = w.sound_to_tensor()

    try:
        start_ms, end_ms, label = _segment_slice(args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if end_ms is None or start_ms is None:
        print("need --phn or both --start-ms/--end-ms", file=sys.stderr)
        return 1

    pipe = _segment_pipeline(args, w)
    s, e, steps = pipe.setup(start_ms, end_ms)

    if not args.compare:
        if args.html:
            print("--html requires --compare (the report renders an A/B "
                  "pair)", file=sys.stderr)
            return 1
        out = pipe.process(sig, start_ms, end_ms)
        arrays = {k: v.cpu().numpy() for k, v in out.items() if v is not None}
        np.savez(args.out, **arrays)
        print(
            f"{args.file} [{label}] {start_ms:.0f}-{end_ms:.0f} ms "
            f"(resized {s:.0f}-{e:.0f}, {steps} steps) -> {args.out}: "
            f"mel {arrays['mel_fbank_segment'].shape}, "
            f"gabor {arrays['gabor_kwta'].shape}"
        )
        return 0

    try:
        b_start, b_end, b_label = _segment_slice(args, prefix="b_")
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    pipe_b = _segment_pipeline(args, w, prefix="b_")
    res = compare_segments(
        pipe, pipe_b, sig, start_ms, end_ms,
        start_ms_b=b_start, end_ms_b=b_end,
    )
    arrays = {}
    for side in ("a", "b"):
        for k, v in res[side].items():
            if v is not None:
                arrays[f"{side}_{k}"] = v.cpu().numpy()
    np.savez(args.out, **arrays)
    print(f"A [{label}] vs B [{b_label or label}] -> {args.out}")
    print(json.dumps(res["diff"], indent=1, default=str))
    if args.html:
        from .utils.report import write_compare_html

        names = (
            "win_ms", "step_ms", "mel_filters", "gabor_size",
            "gabor_stride_x", "gabor_stride_y", "gabor_gain", "gabor_phases",
        )
        pa = {n: getattr(args, n) for n in names}
        pb = {
            n: getattr(args, "b_" + n)
            if getattr(args, "b_" + n, None) is not None
            else getattr(args, n)
            for n in names
        }
        pa["slice"] = f"{label or ''} {start_ms:.0f}-{end_ms:.0f} ms"
        sb, eb = (b_start if b_start is not None else start_ms,
                  b_end if b_end is not None else end_ms)
        pb["slice"] = f"{b_label or label or ''} {sb:.0f}-{eb:.0f} ms"
        try:
            write_compare_html(
                arrays, args.html, params_a=pa, params_b=pb,
                diff=res["diff"],
                title=f"A/B compare: {os.path.basename(args.file)}",
            )
        except RuntimeError as e:
            # matplotlib absent: same clean gating as cmd_viz (the npz and
            # diff JSON above are already written/printed)
            print(f"--html skipped: {e}", file=sys.stderr)
            return 2
        print(f"html report -> {args.html}")
    return 0


def cmd_info(args) -> int:
    w = load_wav(args.file)
    dur = w.num_frames / w.sample_rate
    print(
        f"{args.file}: {w.sample_rate} Hz, {w.channels} ch, "
        f"{w.source_bit_depth}-bit, {w.num_frames} frames ({dur:.3f} s)"
    )
    return 0


def cmd_table(args) -> int:
    """Headless sounds-table workflow: load a directory of WAVs and their
    transcription/timing files into a filterable units table -- the
    gaborview app's corpus-browsing surface (gbv.go:627-718
    LoadTranscription + ConfigSoundsTable + FilterSounds)."""
    from .speech.table import SoundsTable, load_cv_sequence, load_timit_sequence

    paths = sorted(_glob.glob(args.glob))
    if not paths:
        print(f"no files match {args.glob}", file=sys.stderr)
        return 1
    table = SoundsTable()
    for p in paths:
        if args.corpus == "TIMIT":
            seq = load_timit_sequence(p, fuse=args.fuse, silence=args.silence)
        else:
            seq = load_cv_sequence(
                p, corpus=args.corpus, set_id=args.set_id,
                silence=args.silence,
            )
        table.add_sequence(seq)
    rows = table.filter_sound(args.filter) if args.filter else table.rows
    if args.json:
        print(json.dumps([dataclasses.asdict(r) for r in rows]))
        return 0
    print(f"{'sound':10s} {'start':>9s} {'end':>9s} {'dur':>8s}  file (dir)")
    for r in rows:
        print(
            f"{r.sound:10s} {r.start:9.1f} {r.end:9.1f} {r.duration:8.1f}  "
            f"{r.file} ({r.dir})"
        )
    print(f"{len(rows)} units from {len(paths)} files")
    return 0


def _open_external(paths, tool=None) -> None:
    """Launch a host tool on artifact files without waiting -- the analog
    of the reference's Audacity shell-out (gaborview gbv.go:891-902, which
    exec.Command's an external editor on the current sound file). Tool
    resolution: explicit arg > $AUDITORY_TPU_OPEN > xdg-open."""
    import subprocess

    tool = tool or os.environ.get("AUDITORY_TPU_OPEN") or "xdg-open"
    for p in paths:
        try:
            subprocess.Popen(
                [tool, p], stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        except OSError as e:
            print(f"open: {tool} {p}: {e}", file=sys.stderr)
            return


def cmd_viz(args) -> int:
    """Headless PNG rendering of pipeline outputs and the gabor bank --
    the reference's tensor-grid validation surface (gbv.go:1209-1313,
    processspeech.go:503-512, agabor/gabor.go:318-326) without a GUI."""
    from .utils import viz

    try:
        written = []
        if args.npz:
            written += viz.render_npz(
                args.npz, args.out,
                keys=args.keys.split(",") if args.keys else None,
                max_panels=args.max_panels,
            )
        if args.gabor_bank:
            gset = GaborSet(
                size_x=args.gabor_size, size_y=args.gabor_size,
                specs=default_gabor_specs(
                    phases=(0.0, 1.5708) if args.gabor_phases == 2 else (0.0,)
                ),
            )
            os.makedirs(args.out, exist_ok=True)
            written.append(
                viz.render_gabor_bank(
                    gset, os.path.join(args.out, "gabor_bank.png")
                )
            )
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    if not written:
        print("nothing to render (pass an .npz and/or --gabor-bank)",
              file=sys.stderr)
        return 1
    for p in written:
        print(p)
    if getattr(args, "open", False):
        _open_external(written)
    return 0


def cmd_play(args) -> int:
    """Host audio playback (reference sound/playwav.go:20-62 +
    examples/play/play.go:164-179).

    Flag parity with the play app: --rate/--channels/--depth configure the
    playback stream the way the reference passes them into the oto context
    (playwav.go:41), overriding the file header. Unset flags default to the
    file's own header (a conscious deviation: the reference hardcodes
    44100/2/2 and plays misconfigured audio; defaulting to the header plays
    every file correctly while explicit flags reproduce the override).

    Missing file: "File: X not found" like play.go:139-141, rc 1. No audio
    backend: with --out-wav, re-encode the decoded audio at the requested
    rate/channels/depth to that file (headless fallback, rc 0); else report
    and rc 2.
    """
    if not os.path.exists(args.file):
        # PlayIt's missing-file message (play.go:139-141)
        print(f"File: {args.file} not found", file=sys.stderr)
        return 1
    w = load_wav(args.file)
    rate = args.rate if args.rate else w.sample_rate
    channels = args.channels if args.channels else w.channels
    depth_bits = 8 * args.depth if args.depth else w.source_bit_depth
    # the FULL interleaved stream, normalized -- NOT sound_to_tensor, whose
    # reference quirk keeps only the first num_frames samples (half a stereo
    # file) and is a DSP-input convention, not a playback one
    div = w._norm_divisor() or 1.0
    sig = (w.data.astype(np.float64) / div).astype(np.float32)
    try:
        import sounddevice  # type: ignore
    except ImportError:
        if args.out_wav:
            from .io.wav import float_to_wave, write_wav

            write_wav(
                args.out_wav,
                float_to_wave(
                    sig, rate, bit_depth=depth_bits, channels=channels
                ),
            )
            print(
                f"no audio backend; wrote {args.out_wav} "
                f"({rate} Hz, {channels} ch, {depth_bits}-bit, "
                f"{len(sig)} samples)"
            )
            return 0
        print(
            "no audio backend available (sounddevice not installed); "
            f"decoded {len(sig)} samples at {rate} Hz OK "
            "(pass --out-wav FILE to re-encode instead)",
            file=sys.stderr,
        )
        return 2
    frames = (
        sig[: len(sig) // channels * channels].reshape(-1, channels)
        if channels > 1
        else sig
    )
    sounddevice.play(frames, rate, blocking=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="auditory_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process", help="process one WAV through the full pipeline")
    p.add_argument("file")
    p.add_argument("--out", default="out.npz")
    p.add_argument("--pad", action="store_true", default=True)
    p.add_argument("--no-pad", dest="pad", action="store_false")
    p.add_argument(
        "--channel", type=int, default=-1,
        help="de-interleave this channel for multi-channel WAVs (-1 = the "
        "reference's SoundToTensor flattening)",
    )
    p.add_argument("--silence-add", type=float, default=0.0,
                   help="ms of leading silence wanted (AdjustForSilence)")
    p.add_argument("--silence-existing", type=float, default=0.0,
                   help="ms of leading silence already in the file")
    _add_pipeline_args(p)
    _add_precision_arg(p)
    _add_frontend_arg(p)
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("corpus", help="batched extraction over a corpus")
    p.add_argument("--glob", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--rate", type=int, default=16000)
    p.add_argument("--batch-size", type=int, default=128,
                   help="utterances per device batch (larger batches "
                   "amortize the link's fixed per-copy cost)")
    p.add_argument("--mesh", action="store_true",
                   help="shard every batch over all visible GPUs (with "
                   "--device cpu: the host)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument(
        "--transfer", choices=("auto", "float32"), default="auto",
        help="auto: ship 8/16-bit PCM as raw int16, normalize on device "
        "(half the upload bytes; <=1 f32 ulp vs the host float path); "
        "float32: exact host normalization",
    )
    p.add_argument(
        "--f16-features", action="store_true",
        help="cast saved features to float16 on device (half the download "
        "bytes and npz size)",
    )
    p.add_argument(
        "--int8-features", action="store_true",
        help="quantize saved features to int8 on device with per-channel "
        "ranges (quarter the download bytes; lossy -- error <= half a "
        "quantization step per mel band / gabor filter; NaNs preserved; "
        "exact zeros/sign preserved for the gabor fold channels)",
    )
    p.add_argument("--pipeline-depth", type=int, default=3,
                   help="max dispatched-but-unwritten batches in flight")
    _add_frontend_arg(p)
    p.add_argument(
        "--shard", default="",
        help="I/N multi-host scale-out: this host processes the "
        "deterministic slice paths[I::N] with per-shard manifest/stats "
        "(pass the SAME glob on every host; combine with corpus-merge)",
    )
    p.add_argument(
        "--coordinator", default="",
        help="host:port of the torch.distributed rendezvous (rank 0 "
        "listens there): run the LIVE multi-process path "
        "(CorpusRunner.run_distributed) -- every process takes its "
        "paths[rank::nproc] slice on its own device (cuda:local_rank), and "
        "rank 0 merges manifests/stats automatically (no corpus-merge "
        "step); a rank that fails makes every rank fail. Requires "
        "--num-processes/--process-id; --out must be a shared filesystem "
        "path",
    )
    p.add_argument("--num-processes", type=int, default=0,
                   help="with --coordinator: total process count")
    p.add_argument("--process-id", type=int, default=-1,
                   help="with --coordinator: this process' rank")
    _add_pipeline_args(p)
    _add_precision_arg(p)
    p.set_defaults(fn=cmd_corpus)

    p = sub.add_parser(
        "corpus-merge",
        help="combine per-shard corpus outputs (manifest + feature stats)",
    )
    p.add_argument("out", help="the shared --out directory the shards wrote")
    p.set_defaults(fn=cmd_corpus_merge)

    p = sub.add_parser(
        "segment", help="process one phone/time-slice (headless gaborview)"
    )
    p.add_argument("file")
    p.add_argument("--phn", help=".PHN.MS timing file (TIMIT)")
    p.add_argument("--unit", type=int, default=0, help="unit index in --phn")
    p.add_argument("--fuse", action="store_true", help="fuse stop closures")
    p.add_argument("--start-ms", type=float)
    p.add_argument("--end-ms", type=float)
    p.add_argument("--no-resize", action="store_true")
    p.add_argument("--out", default="segment.npz")
    p.add_argument("--f64", action="store_true",
                   help="float64 parity mode, on the CPU whatever --device")
    _add_device_arg(p)
    # A-side params (defaults per gbv.go InitGabors/WinDefaults)
    p.add_argument("--win-ms", type=float, default=25.0)
    p.add_argument("--step-ms", type=float, default=10.0)
    p.add_argument("--mel-filters", type=int, default=32)
    p.add_argument("--gabor-size", type=int, default=8)
    p.add_argument("--gabor-stride-x", type=int, default=6)
    p.add_argument("--gabor-stride-y", type=int, default=3)
    p.add_argument("--gabor-gain", type=float, default=1.5)
    p.add_argument("--gabor-phases", type=int, default=1, choices=(1, 2))
    p.add_argument(
        "--window-fn", choices=("hamming", "hann"), default=None,
        help="opt-in analysis window (reference applies none; omit for "
        "parity, dft/dft.go:42-59)",
    )
    # B-side params for --compare (unset -> inherit the A value;
    # gbv.go:243-258 dual WParams/PParams/GParams)
    p.add_argument("--compare", action="store_true",
                   help="run a second (B) parameter stack and diff outputs")
    p.add_argument("--html", default=None, metavar="OUT.html",
                   help="with --compare: also write ONE self-contained HTML "
                   "report (params + diff stats + embedded figures)")
    p.add_argument("--b-unit", type=int, default=None)
    p.add_argument("--b-start-ms", type=float, default=None)
    p.add_argument("--b-end-ms", type=float, default=None)
    p.add_argument("--b-win-ms", type=float, default=None)
    p.add_argument("--b-step-ms", type=float, default=None)
    p.add_argument("--b-mel-filters", type=int, default=None)
    p.add_argument("--b-gabor-size", type=int, default=None)
    p.add_argument("--b-gabor-stride-x", type=int, default=None)
    p.add_argument("--b-gabor-stride-y", type=int, default=None)
    p.add_argument("--b-gabor-gain", type=float, default=None)
    p.add_argument("--b-gabor-phases", type=int, default=None, choices=(1, 2))
    p.add_argument("--b-window-fn", choices=("hamming", "hann"), default=None)
    p.set_defaults(fn=cmd_segment)

    p = sub.add_parser("info", help="WAV metadata")
    p.add_argument("file")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "table", help="browse a corpus' units table (headless gaborview)"
    )
    p.add_argument("--glob", required=True, help="WAV file glob")
    p.add_argument(
        "--corpus", default="TIMIT",
        choices=("TIMIT", "SYNTHCVS", "GRAFESTES", "VOWELS"),
    )
    p.add_argument("--set-id", default="I", help="CV corpus subset id")
    p.add_argument("--fuse", action="store_true", help="fuse stop closures")
    p.add_argument("--silence", type=float, default=0.0,
                   help="ms of silence adjustment (AdjSeqTimes)")
    p.add_argument("--filter", help="only units with this sound name")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_table)

    p = sub.add_parser(
        "viz", help="render pipeline .npz outputs / the gabor bank to PNGs "
        "(a `segment --compare` npz renders as side-by-side A/B figures)"
    )
    p.add_argument("npz", nargs="?", help="pipeline output .npz to render")
    p.add_argument("--out", default="viz", help="output directory")
    p.add_argument("--keys", help="comma-separated subset of npz keys")
    p.add_argument("--max-panels", type=int, default=16,
                   help="max per-segment panels for 3-D tensors")
    p.add_argument("--gabor-bank", action="store_true",
                   help="also render the (default-spec) gabor filter bank")
    p.add_argument("--gabor-size", type=int, default=9)
    p.add_argument("--gabor-phases", type=int, default=2, choices=(1, 2))
    p.add_argument("--open", action="store_true",
                   help="launch the rendered files in an external viewer "
                   "($AUDITORY_TPU_OPEN or xdg-open; gbv.go:891-902 analog)")
    p.set_defaults(fn=cmd_viz)

    p = sub.add_parser("play", help="play a WAV on the host audio device")
    p.add_argument("file", help="wave file name (play.go -file)")
    p.add_argument("--rate", type=int, default=None,
                   help="sample rate, e.g. 44100/22050/11025 (play.go -rate);"
                   " default: file header")
    p.add_argument("--channels", type=int, default=None,
                   help="channel count (play.go -channels); default: header")
    p.add_argument("--depth", type=int, default=None, choices=(1, 2, 3, 4),
                   help="bit depth in BYTES like the reference (play.go"
                   " -depth); default: header")
    p.add_argument("--out-wav", default=None,
                   help="headless fallback: re-encode to this WAV when no "
                   "audio backend is available")
    p.set_defaults(fn=cmd_play)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, IsADirectoryError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError) as e:
        # RuntimeError: e.g. no card for the default --device cuda
        print(f"error: {e}", file=sys.stderr)
        return 1


def entry() -> None:
    """console_scripts entry point (pyproject [project.scripts])."""
    raise SystemExit(main())


if __name__ == "__main__":
    entry()
