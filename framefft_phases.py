"""Where a block of the frontend kernel spends its time, on the card.

    python3 framefft_phases.py

Builds csrc/framefft.cu with -DFRAMEFFT_PHASES (thread 0 of each block
stamps clock64 at the phase boundaries and sums the cycles it waits on the
piece ring and on the basis ring) into build/, runs the flagship (B=512 x
3 s, 16 kHz) and serving-poll (512 rows x 14 windows) geometries at passes 1
and 6, with and without the wide outputs, and the piece layouts (48 kHz with
64 and 128 filters, 88.2 and 96 kHz with 32) at passes 6 and B=64 and 512 x
3 s, and prints the median cycles per block of: the first staging, and per
N pass (the first six) the k loop and the epilogue (power, stores, mel); in
pieces also the k loop's cycles per k chunk against the flagship's, and the
median cycles a block's first consumer thread waited on the piece ring and
on the basis ring. Then it times, at B=64 and 512, each piece geometry and
some that take the whole span in the layout ops/framefft.py::plan_layout
picks and in the layouts it passes over. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# clock64 slots a block: phase stamps 0-15, piece-ring and basis-ring waits
SLOTS = 18
WAIT_PIECE, WAIT_BASIS = 16, 17


def build_phases():
    """csrc/framefft.cu built with -DFRAMEFFT_PHASES into build/; returns
    the library's path."""
    from auditory_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "framefft-phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFRAMEFFT_PHASES", "-o", str(out),
         str(_build.CSRC / "framefft.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return out


def alternatives(framefft, step, win, n_mel, n_windows, picked):
    """The layouts plan_layout passes over at this geometry, with the mel
    sums where the picked one keeps them: the first that fits of each
    (warpgroups, whole span or pieces) class, and in pieces with two
    warpgroups also each shallower basis ring where the picked one is in
    pieces."""
    out, seen = [], set()
    for lay in framefft.layouts(step, win, n_mel, n_windows):
        key = (lay.consumers, bool(lay.piece),
               lay.ring if lay.piece and lay.consumers == 2 and picked.piece else 0)
        if lay.mel_glob != picked.mel_glob or key in seen or lay.piece > 64:
            continue
        seen.add(key)
        if lay != picked:
            out.append(lay)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("framefft_phases: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import auditory_tpu_torch as at
    from auditory_tpu_torch.convert import constants_from_numpy
    from auditory_tpu_torch.dsp import design
    from auditory_tpu_torch.ops import _build, framefft
    from auditory_tpu_torch.pipeline.batch import bucket_length
    from auditory_tpu_torch.pipeline.sndenv import precision_tier

    lib = ctypes.CDLL(str(build_phases()))
    lib.framefft_phase_clock.argtypes = [ctypes.c_void_p]
    _build.load = lambda name: lib
    framefft._lib.cache_clear()

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def geometry(sr, n_mel, batch):
        t = at.WindowParams().derive(sr)
        fb = at.FilterBank(n_filters=n_mel)
        mel = design.mel_design(fb, t.win_samples, sr)
        c = constants_from_numpy(mel.weights, np.eye(1), np.zeros((1, 1, 1)),
                                 *design.dft_matrices(t.win_samples), None)
        consts = [torch.as_tensor(c[k], dtype=torch.float32, device=dev)
                  for k in ("dft_cos", "dft_sin", "mel_w")]
        n = bucket_length(int(cs.SECONDS * sr), t)
        sig, _ = cs.bench_batch(rng, n, sr, batch)
        seg = t.seg_cnt(n)
        nw = (seg - 1) * (t.stride_samples // t.step_samples) + t.segment_steps
        return t, fb, consts, sig, nw

    t, fb, consts, flag, nw16 = geometry(cs.SR, 32, cs.BATCH)
    span = at.OnlineSndEnv(cs.flagship_cfg(at), cs.SR, device=dev)._span
    # label, geometry, signals, offset0, windows a row, passes, emits
    both = ((True, True), (False, False))
    cases = [("flagship", (t, fb, consts), flag, t.step_offsets[0], nw16, (1, 6), both),
             ("serving", (t, fb, consts), np.ascontiguousarray(flag[:, :span]), 0,
              t.segment_steps, (1, 6), both)]
    # the piece layouts, at B=64 and at a corpus batch of 512
    pieced = (("48 kHz, 64 filters", 48000, 64), ("48 kHz, 128 filters", 48000, 128),
              ("88.2 kHz", 88200, 32), ("96 kHz", 96000, 32))
    for label, sr, n_mel in pieced:
        for batch in (64, 512):
            tg, fg, cg, sg, nwg = geometry(sr, n_mel, batch)
            cases.append((f"{label}, B={batch}", (tg, fg, cg), sg, tg.step_offsets[0],
                          nwg, (6,), ((True, True),)))
    print(cs.card(), flush=True)
    flagship_chunk = None
    with precision_tier("highest"):
        for label, (t, fb, consts), sig, off, nw, grades, emits in cases:
            sig = torch.as_tensor(sig, device=dev)
            kw = dict(n_bins=t.n_bins, n_mel=fb.n_filters, dft=at.DFTParams(), fbank=fb)
            shape = framefft.launch_shape(t.step_samples, t.win_samples, fb.n_filters, nw,
                                          sig.shape[0], framefft.sm_count(dev))
            n_pass = -(-t.n_bins // framefft.BINS_PER_PASS)
            n_kc = -(-t.win_samples // framefft.K_CHUNK)
            for passes in grades:
                for emit in emits:
                    call = lambda: framefft.fused_frame_power_mel(
                        sig, t.step_samples, off, nw, *consts, **kw, emit=emit,
                        passes=passes)
                    for _ in range(3):
                        call()
                    torch.cuda.synchronize()
                    buf = np.zeros((8192, SLOTS), np.int64)
                    if lib.framefft_phase_clock(buf.ctypes.data) != 0:
                        raise RuntimeError("reading the phase stamps failed")
                    n_blocks = -(-(sig.shape[0] * nw) // (64 * shape.consumers))
                    b = buf[:min(n_blocks, 8192)]
                    parts = [f"staging {np.median(b[:, 1] - b[:, 0]):.0f}"]
                    prev = b[:, 1]
                    chunks = []
                    # stamps exist for the first 6 passes
                    for q in range(min(n_pass, 6)):
                        kl = np.median(b[:, 2 + 2 * q] - prev)
                        ep = np.median(b[:, 3 + 2 * q] - b[:, 2 + 2 * q])
                        chunks.append(kl / n_kc)
                        parts.append(f"pass {q} k loop {kl:.0f} ({kl / n_kc:.0f} "
                                     f"a k chunk) epilogue {ep:.0f}")
                        prev = b[:, 3 + 2 * q]
                    if n_pass <= 6:
                        parts.append(f"block {np.median(prev - b[:, 15]):.0f}")
                    chunk = float(np.median(chunks))
                    if label == "flagship" and passes == 6 and emit == (True, True):
                        flagship_chunk = chunk
                    if shape.piece:
                        parts.append(
                            f"a k chunk {chunk:.0f} against the flagship's (whole "
                            f"span) {flagship_chunk:.0f}: {chunk / flagship_chunk:.2f}x; "
                            f"waits of the first consumer thread: piece ring "
                            f"{np.median(b[:, WAIT_PIECE]):.0f} "
                            f"({np.median(b[:, WAIT_PIECE]) / (n_pass * n_kc):.1f} a k "
                            f"chunk), basis ring {np.median(b[:, WAIT_BASIS]):.0f} "
                            f"({np.median(b[:, WAIT_BASIS]) / (n_pass * n_kc):.1f} a k "
                            "chunk)")
                    ms = cs.cuda_ms(call)
                    print(f"{label} passes={passes} emit={emit}: layout {tuple(shape)} "
                          f"(warpgroups, stages, piece, piece buffers, mel_glob, "
                          f"bytes), {n_blocks} blocks, {n_pass} N passes of {n_kc} k "
                          f"chunks, {ms:.4f} ms (CUDA events, median of 10); median "
                          "cycles per block: " + ", ".join(parts), flush=True)

        # the layouts the picker passes over, at B=64 and 512
        sweeps = [(sr, n_mel) for _, sr, n_mel in pieced] + [
            (16000, 32), (16000, 80), (32000, 32), (32000, 128), (44100, 32), (48000, 32),
            (96000, 320)]
        for batch in (64, 512):
            for sr, n_mel in sweeps:
                t, fb, consts, sig, nw = geometry(sr, n_mel, batch)
                sig = torch.as_tensor(sig, device=dev)
                kw = dict(n_bins=t.n_bins, n_mel=n_mel, dft=at.DFTParams(), fbank=fb)
                picked = framefft.launch_shape(t.step_samples, t.win_samples, n_mel, nw,
                                               batch, framefft.sm_count(dev))
                others = alternatives(framefft, t.step_samples, t.win_samples, n_mel,
                                      nw, picked)
                times = []
                for lay in [picked] + others:
                    with cs.forced_layout(framefft, lay):
                        times.append(cs.cuda_ms(lambda: framefft.fused_frame_power_mel(
                            sig, t.step_samples, t.step_offsets[0], nw, *consts, **kw)))
                print(f"layouts at {sr / 1000:g} kHz, {n_mel} filters, B={batch} (CUDA "
                      "events, median of 10): " + "; ".join(
                          f"{tuple(lay[:5])}{' (picked)' if i == 0 else ''} {ms:.4f} ms"
                          for i, (lay, ms) in enumerate(zip([picked] + others, times))),
                      flush=True)
                del sig

if __name__ == "__main__":
    main()
