"""Headless equivalent of the reference examples/gaborview app (PyTorch
counterpart of ``examples/gabor_view.py``): build a sounds table from WAV +
.PHN.MS pairs, pick a phone row, process its time slice through the
gaborview pipeline (resize + byTime + KWTALayer; on a CUDA device the
frontend is the fused kernel), print the results, then compare two
parameter stacks over the first row.

Usage: python -m auditory_tpu_torch.examples.gabor_view
       <dir-with-wav-and-PHN.MS> [phone] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional

from ..config import GaborSet, default_gabor_specs
from ..io.wav import load_wav
from ..pipeline.segments import (
    SegmentPipeline,
    SegmentWindowParams,
    compare_segments,
)
from ..speech.table import SoundsTable, load_timit_sequence


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("phone", nargs="?", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs; no fallback")
    ap.add_argument("--cpu", action="store_true",
                    help="shorthand for --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    root, want = args.root, args.phone

    table = SoundsTable()
    for wav in sorted(glob.glob(os.path.join(root, "**/*.wav"), recursive=True)):
        table.add_sequence(load_timit_sequence(wav))
    if not table.rows:
        print(f"no wav/.PHN.MS pairs under {root}")
        return
    rows = table.filter_sound(want) if want else table.rows
    n_show = min(len(rows), 8)
    print(f"{len(table)} units loaded; processing {n_show} of "
          f"{len(rows)} matching rows")

    # gbv.go:318-357 InitGabors: 8x8, stride (6,3), gain 1.5, phase 0
    gset = GaborSet(
        size_x=8, size_y=8, stride_x=6, stride_y=3, gain=1.5,
        specs=default_gabor_specs(phases=(0.0,)),
    )
    pipes = {}
    for r in rows[:n_show]:
        w = load_wav(r.wav_path)
        if w.sample_rate not in pipes:
            pipes[w.sample_rate] = SegmentPipeline(
                w.sample_rate, SegmentWindowParams(), gabor=gset, device=device
            )
        out = pipes[w.sample_rate].process(w.sound_to_tensor(), r.start, r.end)
        kw = out["gabor_kwta"]
        print(
            f"{r.file} [{r.sound}] {r.start:.0f}-{r.end:.0f} ms -> "
            f"gabor {tuple(kw.shape)}, active "
            f"{float((kw > 0.1).float().mean()):.3f}"
        )

    if not rows:
        print(f"no rows match sound {want!r}")
        return
    # the reference app's core capability: two parameter stacks over the
    # same phone, side by side (gbv.go:243-258 WParams/PParams/GParams 1&2)
    r = rows[0]
    w = load_wav(r.wav_path)
    gset_b = GaborSet(
        size_x=8, size_y=8, stride_x=3, stride_y=3, gain=2.0,
        specs=default_gabor_specs(phases=(0.0, 1.5708)),
    )
    pipe_b = SegmentPipeline(
        w.sample_rate, SegmentWindowParams(), gabor=gset_b, device=device
    )
    res = compare_segments(
        pipes[w.sample_rate], pipe_b, w.sound_to_tensor(), r.start, r.end
    )
    print(f"\nA/B compare on [{r.sound}] {r.start:.0f}-{r.end:.0f} ms:")
    for key in ("mel_fbank_segment", "gabor_kwta"):
        d = res["diff"][key]
        print(
            f"  {key}: A {d['a']['shape']} active {d['a']['active_frac']:.3f}"
            f" | B {d['b']['shape']} active {d['b']['active_frac']:.3f}"
        )


if __name__ == "__main__":
    main()
