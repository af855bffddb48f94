"""Where a block of the frontend kernel spends its time, on the card; and
whether two trees' kernels give the same bits.

    python3 framefft_phases.py
    python3 framefft_phases.py --ablate
    python3 framefft_phases.py --dump OUT.pt [--tree DIR]
    python3 framefft_phases.py --compare A.pt B.pt

Builds csrc/framefft.cu with -DFRAMEFFT_PHASES (thread 0 of each block
stamps clock64 at the phase boundaries and sums the cycles it waits on the
piece ring and on the basis ring) into build/, runs the flagship (B=512 x
3 s, 16 kHz) and serving-poll (512 rows x 14 windows) geometries at passes 1
and 6, with and without the wide outputs, and the piece layouts (48 kHz with
64 and 128 filters, 88.2 and 96 kHz with 32) at passes 6 and B=64 and 512 x
3 s, and prints the median cycles per block of: the first staging, and per
N pass (the first six) the k loop and the epilogue split into the power
tile (with the barrier after it), the power and log power stores, and the
mel sums; in
pieces also the k loop's cycles per k chunk against the flagship's, and the
median cycles a block's first consumer thread waited on the piece ring and
on the basis ring. Then it times, at B=64 and 512, each piece geometry and
some that take the whole span in the layout ops/framefft.py::plan_layout
picks and in the layouts it passes over. Needs a CUDA card.

``--ablate`` times the kernel and reads its mel stamps at the flagship, 16
kHz with 256 filters and 96 kHz with 320 (B=512 x 3 s) three ways: as it
is, with each closed mel sum stored to shared memory in place of its
scattered store to the mel output, and with the mel sums skipped (the last
two give wrong outputs; they time what the mel epilogue costs).

``--dump`` runs the kernel (passes=6) of the package in DIR (default: this
checkout; another tree unpacked with ``git archive``) on seeded inputs at
the flagship (B=512 x 3 s), the serving poll, 44.1 kHz with 80 filters, 48
kHz with 128, 16 kHz with 256, 96 kHz with 320 (B=64 x 3 s), a dense
random bank, a bank with an empty filter, and rows with a NaN sample, an
inf sample and an overflowing tone at 16 kHz and at 96 kHz with 320
filters, and saves power, log power and log mel to OUT. ``--compare``
says, per case and output, whether two dumps are equal bit for bit (NaN
where NaN), and exits nonzero where one is not.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# clock64 slots a block (csrc/framefft.cu, FRAMEFFT_PHASES): the consumers'
# start, the staged span, the block's start, the piece-ring and basis-ring
# waits, then four stamps a pass for the first six passes (the end of its k
# loop, power tile, stores and mel sums)
SLOTS = 29
START, STAGED, BLOCK, WAIT_PIECE, WAIT_BASIS, PASS0 = 0, 1, 2, 3, 4, 5


# --ablate: the mel epilogue's lines in csrc/framefft.cu and what takes
# their place: a closed sum stored to shared memory, no mel sums
CLOSE = "if (live) mrow[E.x] = floored_log(sum + p.mel_log_off, p.mel_log_min);"
ABLATIONS = {
    "as built": (),
    "closed sums stored to shared memory": (
        (CLOSE, "c_out[(E.x & 3) * 64] = floored_log(sum + p.mel_log_off, "
                "p.mel_log_min);"),),
    "no mel sums": (
        ("if (!dense && !nonfinite[64 * wg + r]) {", "if (p.n_mel < 0) {"),
        ("for (int f = half; f < p.n_mel; f += 2) {", "for (int f = half; f < 0; f += 2) {")),
}


def build_phases(name="framefft-phases", edits=()):
    """csrc/framefft.cu, with ``edits`` ((line, replacement) pairs)
    applied, built with -DFRAMEFFT_PHASES into build/; returns the
    library's path."""
    from auditory_tpu_torch.ops import _build

    out = _build.BUILD_DIR / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "framefft.cu"
    if edits:
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"csrc/framefft.cu has no single line {old!r}")
            text = text.replace(old, new)
        src = out.with_suffix(".cu")
        src.write_text(text)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFRAMEFFT_PHASES", "-o", str(out),
         str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return out


def alternatives(framefft, step, win, n_windows, picked):
    """The layouts plan_layout passes over at this geometry: the first that
    fits of each (warpgroups, whole span or pieces) class, and in pieces
    with two warpgroups also each shallower basis ring where the picked one
    is in pieces."""
    out, seen = [], set()
    for lay in framefft.layouts(step, win, n_windows):
        key = (lay.consumers, bool(lay.piece),
               lay.ring if lay.piece and lay.consumers == 2 and picked.piece else 0)
        if key in seen or lay.piece > 64:
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
              ("88.2 kHz", 88200, 32), ("96 kHz", 96000, 32),
              ("96 kHz, 320 filters", 96000, 320), ("16 kHz, 256 filters", 16000, 256))
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
            shape = framefft.launch_shape(t.step_samples, t.win_samples, nw,
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
                    parts = [f"staging {np.median(b[:, STAGED] - b[:, START]):.0f}"]
                    prev = b[:, STAGED]
                    chunks = []
                    # stamps exist for the first 6 passes
                    for q in range(min(n_pass, 6)):
                        s0 = PASS0 + 4 * q
                        kl = np.median(b[:, s0] - prev)
                        power, stores, mel = (np.median(b[:, s0 + i + 1] - b[:, s0 + i])
                                              for i in range(3))
                        ep = np.median(b[:, s0 + 3] - b[:, s0])
                        chunks.append(kl / n_kc)
                        parts.append(f"pass {q} k loop {kl:.0f} ({kl / n_kc:.0f} "
                                     f"a k chunk) epilogue {ep:.0f} (power tile "
                                     f"{power:.0f}, stores {stores:.0f}, mel {mel:.0f})")
                        prev = b[:, s0 + 3]
                    if n_pass <= 6:
                        parts.append(f"block {np.median(prev - b[:, BLOCK]):.0f}")
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
                          f"(warpgroups, stages, piece, piece buffers, bytes), "
                          f"{n_blocks} blocks, {n_pass} N passes of {n_kc} k "
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
                picked = framefft.launch_shape(t.step_samples, t.win_samples, nw,
                                               batch, framefft.sm_count(dev))
                others = alternatives(framefft, t.step_samples, t.win_samples, nw,
                                      picked)
                times = []
                for lay in [picked] + others:
                    with cs.forced_layout(framefft, lay):
                        times.append(cs.cuda_ms(lambda: framefft.fused_frame_power_mel(
                            sig, t.step_samples, t.step_offsets[0], nw, *consts, **kw)))
                print(f"layouts at {sr / 1000:g} kHz, {n_mel} filters, B={batch} (CUDA "
                      "events, median of 10): " + "; ".join(
                          f"{tuple(lay[:4])}{' (picked)' if i == 0 else ''} {ms:.4f} ms"
                          for i, (lay, ms) in enumerate(zip([picked] + others, times))),
                      flush=True)
                del sig

def ablate() -> None:
    """The kernel's time and mel stamps as built and in the ABLATIONS."""
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

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = []
    for sr, n_mel in ((16000, 32), (16000, 256), (96000, 320)):
        t = at.WindowParams().derive(sr)
        fb = at.FilterBank(n_filters=n_mel)
        c = constants_from_numpy(design.mel_design(fb, t.win_samples, sr).weights,
                                 np.eye(1), np.zeros((1, 1, 1)),
                                 *design.dft_matrices(t.win_samples), None)
        consts = [torch.as_tensor(c[k], dtype=torch.float32, device=dev)
                  for k in ("dft_cos", "dft_sin", "mel_w")]
        n = bucket_length(int(cs.SECONDS * sr), t)
        sig = torch.as_tensor(cs.bench_batch(rng, n, sr, cs.BATCH)[0], device=dev)
        cases.append((sr, t, fb, consts, sig, cs.grid_windows(t, n)))
    print(cs.card(), flush=True)
    for i, (label, edits) in enumerate(ABLATIONS.items()):
        lib = ctypes.CDLL(str(build_phases(f"framefft-ablate-{i}", edits)))
        lib.framefft_phase_clock.argtypes = [ctypes.c_void_p]
        _build.load = lambda name, lib=lib: lib
        framefft._lib.cache_clear()
        framefft.launch_shape.cache_clear()
        with precision_tier("highest"):
            for sr, t, fb, consts, sig, nw in cases:
                kw = dict(n_bins=t.n_bins, n_mel=fb.n_filters, dft=at.DFTParams(),
                          fbank=fb)
                ms = cs.cuda_ms(lambda: framefft.fused_frame_power_mel(
                    sig, t.step_samples, t.step_offsets[0], nw, *consts, **kw))
                buf = np.zeros((8192, SLOTS), np.int64)
                if lib.framefft_phase_clock(buf.ctypes.data) != 0:
                    raise RuntimeError("reading the phase stamps failed")
                lay = framefft.launch_shape(t.step_samples, t.win_samples, nw,
                                            sig.shape[0], framefft.sm_count(dev))
                b = buf[:min(-(-(sig.shape[0] * nw) // (64 * lay.consumers)), 8192)]
                n_pass = min(-(-t.n_bins // framefft.BINS_PER_PASS), 6)
                mel = [np.median(b[:, PASS0 + 4 * q + 3] - b[:, PASS0 + 4 * q + 2])
                       for q in range(n_pass)]
                print(f"{label}: {sr / 1000:g} kHz, {fb.n_filters} filters, "
                      f"B={sig.shape[0]}: {ms:.4f} ms (CUDA "
                      "events, median of 10); median mel cycles per block, passes "
                      f"0-{n_pass - 1}: " + ", ".join(f"{m:.0f}" for m in mel), flush=True)


def dump(out_path: str, tree: str) -> None:
    """The kernel's outputs on the parity cases (see the module docstring),
    from the package in ``tree``, saved to ``out_path``."""
    if not torch.cuda.is_available():
        raise SystemExit("framefft_phases: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(tree).resolve()))
    import auditory_tpu_torch as at
    from auditory_tpu_torch.convert import constants_from_numpy
    from auditory_tpu_torch.dsp import design
    from auditory_tpu_torch.ops import framefft
    from auditory_tpu_torch.pipeline.batch import bucket_length
    from auditory_tpu_torch.pipeline.sndenv import precision_tier

    print(f"package: {Path(at.__file__).parent}; {cs.card()}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    dense_bank = rng.random((320, 201))
    empty_bank = design.mel_design(at.FilterBank(), 400, 16000).weights.copy()
    empty_bank[5] = 0.0

    def nonfinite(sig, sr):
        n = sig.shape[1]
        sig[0, n // 2] = np.nan
        sig[1, n // 3] = np.inf
        sig[2] = (1e30 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / sr)).astype(np.float32)
        return sig

    # label: (rate, filters, weights or None, rows, noise rows, serving poll, non-finite)
    cases = {
        "flagship 16 kHz, B=512": (16000, 32, None, 512, False, False, False),
        "serving poll, N=512": (16000, 32, None, 512, False, True, False),
        "44.1 kHz, 80 filters, B=64": (44100, 80, None, 64, True, False, False),
        "48 kHz, 128 filters, B=64": (48000, 128, None, 64, True, False, False),
        "16 kHz, 256 filters, B=64": (16000, 256, None, 64, False, False, False),
        "96 kHz, 320 filters, B=64": (96000, 320, None, 64, True, False, False),
        "16 kHz, dense random bank, B=16": (16000, 320, dense_bank, 16, False, False, False),
        "16 kHz, an empty filter, B=16": (16000, 32, empty_bank, 16, False, False, False),
        "16 kHz, non-finite rows, B=8": (16000, 32, None, 8, True, False, True),
        "96 kHz, 320 filters, non-finite rows, B=8": (96000, 320, None, 8, True, False, True),
    }
    outs = {}
    with precision_tier("highest"):
        for label, (sr, n_mel, weights, rows, noise, serving, bad) in cases.items():
            t = at.WindowParams().derive(sr)
            fb = at.FilterBank(n_filters=n_mel)
            w = design.mel_design(fb, t.win_samples, sr).weights if weights is None else weights
            c = constants_from_numpy(w, np.eye(1), np.zeros((1, 1, 1)),
                                     *design.dft_matrices(t.win_samples), None)
            consts = [torch.as_tensor(c[k], dtype=torch.float32, device=dev)
                      for k in ("dft_cos", "dft_sin", "mel_w")]
            n = bucket_length(int(cs.SECONDS * sr), t)
            sig = (cs.noise_batch(rng, n, rows) if noise else cs.bench_batch(rng, n, sr, rows))[0]
            if bad:
                sig = nonfinite(sig, sr)
            offset0, nw = t.step_offsets[0], cs.grid_windows(t, n)
            if serving:
                span = at.OnlineSndEnv(cs.flagship_cfg(at), sr, device=dev)._span
                sig, offset0, nw = np.ascontiguousarray(sig[:, :span]), 0, t.segment_steps
            got = framefft.fused_frame_power_mel(
                torch.as_tensor(sig, device=dev), t.step_samples, offset0, nw, *consts,
                n_bins=t.n_bins, n_mel=n_mel, dft=at.DFTParams(), fbank=fb)
            outs[label] = tuple(x.cpu() for x in got)
            print(f"{label}: {tuple(outs[label][2].shape)} mel", flush=True)
    torch.save(outs, out_path)


def compare(a_path: str, b_path: str) -> None:
    """Whether two dumps are equal bit for bit, per case and output."""
    a, b = torch.load(a_path), torch.load(b_path)
    differ = []
    for label in a:
        same = []
        for name, x, y in zip(("power", "log power", "log mel"), a[label], b[label]):
            nan = torch.isnan(x)
            eq = (torch.equal(nan, torch.isnan(y))
                  and torch.equal(x.masked_fill(nan, 0).view(torch.int32),
                                  y.masked_fill(nan, 0).view(torch.int32)))
            same.append(f"{name} {'equal' if eq else 'DIFFERS'} (NaN {int(nan.sum())}, "
                        f"inf {int(torch.isinf(x).sum())})")
            if not eq:
                differ.append((label, name))
        print(f"{label}: " + ", ".join(same), flush=True)
    print(f"{len(a)} cases: " + ("every output equal bit for bit" if not differ
                                 else f"{len(differ)} outputs differ: {differ}"))
    if differ:
        raise SystemExit(1)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--ablate":
        ablate()
    elif len(sys.argv) > 1 and sys.argv[1] == "--dump":
        dump(sys.argv[2], sys.argv[4] if len(sys.argv) > 4 and sys.argv[3] == "--tree"
             else str(ROOT))
    elif len(sys.argv) > 1 and sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        main()
