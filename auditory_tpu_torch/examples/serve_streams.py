"""Multi-stream serving demo: N concurrent audio streams, one device
(PyTorch counterpart of ``examples/serve_streams.py``).

Shows the recommended production-serving setup for
:class:`auditory_tpu_torch.MultiStreamOnline`:

- select only the serving outputs (mel + gabor + validity), so the poll
  program computes and ships nothing else;
- pick a transfer tier (float16 halves the per-poll host copy, which is
  what caps stream capacity on a byte-bound link);
- feed arbitrary chunk sizes per stream; poll runs ONE batched device call
  for every stream with a segment pending (on a CUDA device the frontend
  is one launch of the fused kernel on the 16 kHz uniform grid);
- bound the per-stream buffers and pick an overload policy
  (``max_buffer_seconds`` + ``overflow='error'|'drop_oldest'``) so
  producers that outrun poll() get backpressure or bounded shedding
  instead of unbounded memory growth.

Outputs equal each stream's offline run within float32 rounding (the
float32 tier) -- the contract tests/test_torch_online.py pins.

Usage: python -m auditory_tpu_torch.examples.serve_streams [--streams 16]
       [--seconds 2] [--chunk-ms 100] [--f16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import GaborSet, SndEnvConfig, default_gabor_specs
from ..pipeline.online import MultiStreamOnline

SR = 16000
OUTPUTS = ("mel_fbank_segment", "gabor_kwta", "step_valid")


class Served(NamedTuple):
    """What one serving run emitted: every (stream, segment index,
    outputs) in emission order, the wall ms of each poll that emitted, and
    the streams' signals."""

    results: list
    poll_ms: List[float]
    signals: List[np.ndarray]


def example_cfg() -> SndEnvConfig:
    return SndEnvConfig(
        gabor=GaborSet(
            size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
            specs=default_gabor_specs(phases=(0.0, 1.5708)),
        )
    )


def stream_signal(freq: float, n: int) -> np.ndarray:
    """A stream's ``n`` samples: a 0.3-amplitude tone."""
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def serve(ms: MultiStreamOnline, signals: List[np.ndarray], chunk_n: int) -> Served:
    """Feed every stream its signal in chunks of ``chunk_n`` samples,
    polling after each round of feeds; then close every stream and drain."""
    results, poll_ms = [], []
    for pos in range(0, len(signals[0]), chunk_n):
        for s, sig in enumerate(signals):
            ms.feed(s, sig[pos:pos + chunk_n])
        t0 = time.perf_counter()
        emitted = ms.poll()
        # only polls that actually ran the device batch count (empty polls
        # return early in microseconds and would skew the median)
        if emitted:
            poll_ms.append((time.perf_counter() - t0) * 1e3)
        results.extend(emitted)
    for s in range(len(signals)):
        ms.close(s)
    results.extend(ms.drain())
    return Served(results, poll_ms, signals)


def main(argv: Optional[List[str]] = None) -> Served:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--chunk-ms", type=float, default=100.0)
    ap.add_argument("--f16", action="store_true",
                    help="float16 poll copies (halves poll bytes)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs; no fallback")
    ap.add_argument("--cpu", action="store_true",
                    help="shorthand for --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    ms = MultiStreamOnline(
        example_cfg(), SR, n_streams=args.streams, outputs=OUTPUTS,
        transfer_dtype=torch.float16 if args.f16 else None,
        # production overload policy: bounded buffers + backpressure (a
        # feed that would overflow raises BufferOverflow; this demo's
        # feed/poll cadence never accumulates more than one chunk)
        max_buffer_seconds=10.0, overflow="error", device=device,
    )
    rng = np.random.default_rng(0)
    chunk_n = int(SR * args.chunk_ms / 1000.0)
    n_chunks = int(args.seconds * 1000.0 / args.chunk_ms)
    freqs = rng.uniform(300, 3000, size=args.streams)
    served = serve(ms, [stream_signal(f, n_chunks * chunk_n) for f in freqs],
                   chunk_n)

    got = {s: 0 for s in range(args.streams)}
    for s, _, out in served.results:
        got[s] += 1
        assert out["mel_fbank_segment"].ndim == 2  # [n_mel, steps]
    segs = sum(got.values())
    audio_sec = args.streams * args.seconds
    print(f"streams: {args.streams}, segments emitted: {segs} "
          f"({segs // args.streams}/stream)")
    if served.poll_ms:
        print(f"median poll: {np.median(served.poll_ms):.2f} ms per "
              f"{args.streams}-stream batch")
    print(f"audio processed: {audio_sec:.1f} s")
    # segs > 0 first: with zero emissions the balance check is vacuously
    # true and SERVE_OK would be a false positive
    assert segs > 0, "no segments emitted (audio shorter than one segment?)"
    assert all(v == segs // args.streams for v in got.values())
    print("SERVE_OK")
    return served


if __name__ == "__main__":
    main()
