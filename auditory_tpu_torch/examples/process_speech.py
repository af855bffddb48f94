"""Headless equivalent of the reference examples/processspeech app
(PyTorch counterpart of ``examples/process_speech.py``): load a WAV,
stream through segments with the multi-stride geometry, print summary
stats per segment (the reference renders tensor grids in a GoGi GUI).

The path is the StreamingProcessor's window gather and DFT matmul, as in
the JAX package: the fused frontend kernel does not run here.

Usage: python -m auditory_tpu_torch.examples.process_speech [file.wav]
       [--device cuda|cpu]

The default file is the reference app's ``sounds/bug.wav``, relative to
the root of a checkout of the reference repository; a missing file exits
with an error naming the path.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import DFTParams, GaborSet, MelParams, WindowParams, default_gabor_specs
from ..io.wav import load_wav
from ..pipeline.streaming import StreamingProcessor

DEFAULT_WAV = "examples/processspeech/sounds/bug.wav"


def process(signal: np.ndarray, sample_rate: int, device) -> List[Dict[str, torch.Tensor]]:
    """Every segment's outputs of ``signal`` through the processspeech
    StreamingProcessor, in order."""
    # processspeech.go:226-253 gabor setup: 9x9, stride 3, gain 2, two phases
    gset = GaborSet(
        size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
        specs=default_gabor_specs(phases=(0.0, 1.5708)),
    )
    sp = StreamingProcessor(WindowParams(), DFTParams(), MelParams(), gset,
                            sample_rate, device=device)
    sp.load(signal)
    outs = []
    while sp.more_segments:
        outs.append(sp.process_segment())
    return outs


def main(argv: Optional[List[str]] = None) -> List[Dict[str, torch.Tensor]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("wav", nargs="?", default=DEFAULT_WAV)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs; no fallback")
    ap.add_argument("--cpu", action="store_true",
                    help="shorthand for --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if not os.path.isfile(args.wav):
        raise SystemExit(f"process_speech: no WAV file at {args.wav}")
    w = load_wav(args.wav)
    sig = w.sound_to_tensor()
    outs = process(sig, w.sample_rate, device)
    print(f"{args.wav}: {w.sample_rate} Hz, {len(sig)} samples")
    for seg, out in enumerate(outs):
        mel = out["mel_fbank_segment"][:, :, 0].cpu().numpy()
        gab = out["gabor"].cpu().numpy()
        hot = int(np.argmax(mel.mean(axis=1)))
        print(
            f"segment {seg}: mel[{mel.shape[0]}x{mel.shape[1]}] "
            f"range [{mel.min():.2f}, {mel.max():.2f}] hottest band {hot}; "
            f"gabor {gab.shape} active {(np.abs(gab) > 0.1).mean():.3f}"
        )
    return outs


if __name__ == "__main__":
    main()
