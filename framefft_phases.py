"""Where a block of the frontend kernel spends its time, on the card.

    python3 framefft_phases.py

Builds csrc/framefft.cu with -DFRAMEFFT_PHASES (thread 0 of each block
stamps clock64 at the phase boundaries) into build/, runs the flagship
(B=512 x 3 s, 16 kHz) and serving-poll (512 rows x 14 windows) geometries at
passes 1 and 6, with and without the wide outputs, and prints the median
cycles per block of: the span's staging, and per N pass the k loop (the
products) and the epilogue (power, stores, mel). Needs a CUDA card.
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
    t = at.WindowParams().derive(cs.SR)
    fb = at.FilterBank()
    mel = design.mel_design(fb, t.win_samples, cs.SR)
    c = constants_from_numpy(mel.weights, np.eye(1), np.zeros((1, 1, 1)),
                             *design.dft_matrices(t.win_samples), None)
    consts = [torch.as_tensor(c[k], dtype=torch.float32, device=dev)
              for k in ("dft_cos", "dft_sin", "mel_w")]
    n16 = bucket_length(int(cs.SECONDS * cs.SR), t)
    flag, _ = cs.bench_batch(np.random.default_rng(0), n16, cs.SR, cs.BATCH)
    seg = t.seg_cnt(n16)
    nw16 = (seg - 1) * (t.stride_samples // t.step_samples) + t.segment_steps
    span = at.OnlineSndEnv(cs.flagship_cfg(at), cs.SR, device=dev)._span
    cases = (("flagship", torch.as_tensor(flag, device=dev), t.step_offsets[0], nw16),
             ("serving", torch.as_tensor(np.ascontiguousarray(flag[:, :span]), device=dev),
              0, t.segment_steps))
    kw = dict(n_bins=t.n_bins, n_mel=fb.n_filters, dft=at.DFTParams(), fbank=fb)
    print(cs.card(), flush=True)
    with precision_tier("highest"):
        for label, sig, off, nw in cases:
            for passes in (1, 6):
                for emit in ((True, True), (False, False)):
                    call = lambda: framefft.fused_frame_power_mel(
                        sig, t.step_samples, off, nw, *consts, **kw, emit=emit,
                        passes=passes)
                    for _ in range(3):
                        call()
                    torch.cuda.synchronize()
                    buf = np.zeros((8192, 16), np.int64)
                    if lib.framefft_phase_clock(buf.ctypes.data) != 0:
                        raise RuntimeError("reading the phase stamps failed")
                    consumers, _, _ = framefft.launch_shape(
                        t.step_samples, t.win_samples, fb.n_filters, nw)
                    n_blocks = -(-(sig.shape[0] * nw) // (64 * consumers))
                    b = buf[:min(n_blocks, 8192)]
                    n_pass = -(-t.n_bins // framefft.BINS_PER_PASS)
                    parts = [f"staging {np.median(b[:, 1] - b[:, 0]):.0f}"]
                    prev = b[:, 1]
                    for q in range(n_pass):
                        kl = np.median(b[:, 2 + 2 * q] - prev)
                        ep = np.median(b[:, 3 + 2 * q] - b[:, 2 + 2 * q])
                        parts.append(f"pass {q} k loop {kl:.0f} epilogue {ep:.0f}")
                        prev = b[:, 3 + 2 * q]
                    parts.append(f"block {np.median(prev - b[:, 15]):.0f}")
                    ms = cs.cuda_ms(call)
                    print(f"{label} passes={passes} emit={emit}: {n_blocks} blocks, "
                          f"{ms:.4f} ms (CUDA events, median of 10); median cycles "
                          "per block: " + ", ".join(parts), flush=True)


if __name__ == "__main__":
    main()
