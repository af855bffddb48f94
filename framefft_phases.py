"""Where a block of the frontend kernel spends its time, on the card.

    python3 framefft_phases.py

Builds csrc/framefft.cu with -DFRAMEFFT_PHASES (thread 0 of each block
stamps clock64 at the phase boundaries) into build/, runs the flagship
(B=512 x 3 s, 16 kHz) and serving-poll (512 rows x 14 windows) geometries at
passes 1 and 6, with and without the wide outputs, and the other block
layouts at B=64 x 3 s (48 kHz with 64 filters: mel sums in global memory;
96 kHz: the span staged in pieces) at passes 6, and prints the median
cycles per block of: the first staging, and per N pass (the first six) the
k loop (the products, and in pieces the staging of the next piece) and the
epilogue (power, stores, mel). Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def build_phases_lib():
    from auditory_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "framefft-phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFRAMEFFT_PHASES", "-o", str(out),
         str(_build.CSRC / "framefft.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
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

    lib = ctypes.CDLL(str(build_phases_lib()))
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
    # the other block layouts: mel sums in global memory (48 kHz, 64
    # filters), the span staged in pieces (96 kHz), both at B=64
    for label, sr, n_mel in (("48 kHz, 64 filters", 48000, 64), ("96 kHz", 96000, 32)):
        tg, fg, cg, sg, nwg = geometry(sr, n_mel, 64)
        cases.append((label, (tg, fg, cg), sg, tg.step_offsets[0], nwg, (6,),
                      ((True, True),)))
    print(cs.card(), flush=True)
    with precision_tier("highest"):
        for label, (t, fb, consts), sig, off, nw, grades, emits in cases:
            sig = torch.as_tensor(sig, device=dev)
            kw = dict(n_bins=t.n_bins, n_mel=fb.n_filters, dft=at.DFTParams(), fbank=fb)
            shape = framefft.launch_shape(t.step_samples, t.win_samples, fb.n_filters, nw)
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
                    buf = np.zeros((8192, 16), np.int64)
                    if lib.framefft_phase_clock(buf.ctypes.data) != 0:
                        raise RuntimeError("reading the phase stamps failed")
                    n_blocks = -(-(sig.shape[0] * nw) // (64 * shape[0]))
                    b = buf[:min(n_blocks, 8192)]
                    parts = [f"staging {np.median(b[:, 1] - b[:, 0]):.0f}"]
                    prev = b[:, 1]
                    # stamps exist for the first 6 passes
                    for q in range(min(n_pass, 6)):
                        kl = np.median(b[:, 2 + 2 * q] - prev)
                        ep = np.median(b[:, 3 + 2 * q] - b[:, 2 + 2 * q])
                        parts.append(f"pass {q} k loop {kl:.0f} ({kl / n_kc:.0f} "
                                     f"a k chunk) epilogue {ep:.0f}")
                        prev = b[:, 3 + 2 * q]
                    if n_pass <= 6:
                        parts.append(f"block {np.median(prev - b[:, 15]):.0f}")
                    ms = cs.cuda_ms(call)
                    print(f"{label} passes={passes} emit={emit}: layout (warpgroups, "
                          f"stages, piece, mel_glob, bytes) {shape[:4] + (shape[4],)}, "
                          f"{n_blocks} blocks, {n_pass} N passes of {n_kc} k chunks, "
                          f"{ms:.4f} ms (CUDA events, median of 10); median cycles "
                          "per block: " + ", ".join(parts), flush=True)

if __name__ == "__main__":
    main()
