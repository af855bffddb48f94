"""End-to-end demo: auditory features -> neural network (PyTorch counterpart
of ``examples/train_phone_classifier.py``), the role the reference plays in
the emergent ecosystem (an A1-cortex-like input layer).

Synthesizes CV-like tokens (distinct formant pairs per class), extracts
gabor-kWTA features with the batched SndEnv pipeline (on a CUDA device its
frontend is the fused kernel), and trains a 2-layer MLP on them with Adam.

Usage: python -m auditory_tpu_torch.examples.train_phone_classifier
       [--steps 200] [--device cuda|cpu] [--features inline|device|npz]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import GaborSet, SndEnvConfig, default_gabor_specs
from ..dsp.frame import pad_signal
from ..pipeline.batch import BatchedSndEnv, CorpusRunner, bucket_length
from ..pipeline.sndenv import SndEnv, precision_tier

SR = 16000


def synth_token(cls: int, rng: np.random.Generator, sr: int = 16000,
                dur: float = 0.15) -> np.ndarray:
    """A CV-ish token: two formant tones + onset transient + noise."""
    formants = [
        (300, 2300), (600, 1200), (800, 1800),
        (400, 900), (350, 1700), (700, 2500),
    ]
    f1, f2 = formants[cls % len(formants)]
    n = int(dur * sr)
    t = np.arange(n) / sr
    jit1 = rng.uniform(0.95, 1.05)
    jit2 = rng.uniform(0.95, 1.05)
    env = np.minimum(t / 0.02, 1.0) * np.exp(-t * 3.0)
    sig = env * (
        0.5 * np.sin(2 * np.pi * f1 * jit1 * t)
        + 0.35 * np.sin(2 * np.pi * f2 * jit2 * t)
    )
    sig += 0.01 * rng.standard_normal(n)
    return sig.astype(np.float32)


def assemble_batch(sigs, timing):
    """Pack variable-length signals into one zero-padded [N, n_pad] batch
    (bucketed length) + true lengths; shared by the training examples."""
    n_pad = bucket_length(max(len(s) for s in sigs), timing)
    batch = np.zeros((len(sigs), n_pad), np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    lengths = np.array([len(s) for s in sigs], np.int32)
    return batch, lengths


def example_cfg() -> SndEnvConfig:
    """The examples' configuration: the processspeech gabor bank (9x9,
    stride 3, gain 2, two phases), everything else default (kWTA on)."""
    return SndEnvConfig(gabor=GaborSet(
        size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
        specs=default_gabor_specs(phases=(0.0, 1.5708)),
    ))


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--n-per-class", type=int, default=40)
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where features and training run; no fallback")
    ap.add_argument("--cpu", action="store_true",
                    help="shorthand for --device cpu")


def device_of(args) -> torch.device:
    return torch.device("cpu" if args.cpu else args.device)


class MLP(nn.Module):
    """x -> relu(x W1 + b1) W2 + b2. W ~ N(0, 2/fan_in) drawn from
    ``generator`` in the JAX layout [in, out] and stored transposed, biases
    zero (the JAX example's initialization; its random numbers differ)."""

    def __init__(self, din: int, dh: int, dout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(din, dh)
        self.fc2 = nn.Linear(dh, dout)
        with torch.no_grad():
            for fc, (i, o) in ((self.fc1, (din, dh)), (self.fc2, (dh, dout))):
                w = torch.randn(i, o, generator=generator) * (2.0 / i) ** 0.5
                fc.weight.copy_(w.T)
                fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


def extract_features(args, cfg, sigs, labels, dev):
    """The three feature routes -> (features [N, D] on ``dev``, labels)."""
    n_total = len(sigs)
    env = SndEnv(cfg, SR, outputs=("gabor_kwta", "step_valid"), device=dev)
    if args.features == "inline":
        batch, lengths = assemble_batch(sigs, env.timing)
        with torch.no_grad():
            out, _ = BatchedSndEnv(env).process(batch, lengths)
        return out.gabor_kwta.reshape(n_total, -1), labels

    from ..io.wav import float_to_wave, write_wav

    tmp = tempfile.TemporaryDirectory()
    try:
        paths = []
        for i, (c, s) in enumerate(zip(labels, sigs)):
            p = f"{tmp.name}/tok_c{c}_{i:04d}.wav"
            write_wav(p, float_to_wave(s, SR))
            paths.append(p)
        # one parser for the tok_c<class>_<idx>.wav stem scheme
        cls_of = lambda name: int(name.rsplit("_c", 1)[1].split("_")[0])
        runner = CorpusRunner(cfg, SR, batch_size=64, save_keys=("gabor_kwta",),
                              feature_stats=False, device=dev)
        t0 = time.perf_counter()
        rows, lab_rows = [], []
        if args.features == "device":
            # corpus -> device memory -> training, no device->host copy
            with torch.no_grad():
                for bpaths, out, _valid, n_segs in runner.iter_device_features(paths):
                    # one duration, one bucket: trim the bucket's padded
                    # segment axis to the files' true count
                    if len(set(n_segs)) != 1:
                        raise ValueError(f"tokens of unequal length: {n_segs}")
                    g = out.gabor_kwta[:, : n_segs[0]]
                    rows.append(g.reshape(len(bpaths), -1))
                    lab_rows.extend(cls_of(p) for p in bpaths)
        else:  # npz: materialize, then read back through FeatureDataset
            from ..pipeline.dataset import FeatureDataset

            out_dir = f"{tmp.name}/out"
            runner.run(paths, out_dir)
            ds = FeatureDataset(out_dir, keys=("gabor_kwta",), label_fn=cls_of)
            for b in ds.batches(64, device=dev):
                rows.append(b["gabor_kwta"].reshape(len(b["stem"]), -1))
                lab_rows.extend(b["label"].tolist())
        feats = torch.cat(rows)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        audio_s = sum(len(s) for s in sigs) / SR
        print(f"[{args.features}] corpus->features: {audio_s:.1f} s audio in "
              f"{dt:.3f} s wall (RTF {audio_s / dt:.0f}x)")
    finally:
        tmp.cleanup()
    return feats, np.asarray(lab_rows)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the example; returns the final test accuracy, the first and last
    training loss, and the wall ms per training step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    add_common_args(ap)
    ap.add_argument(
        "--features", choices=("inline", "device", "npz"), default="inline",
        help="feature route: 'inline' = the batched pipeline in-process; "
        "'device' = a wav corpus through CorpusRunner.iter_device_features "
        "(features never leave the device); 'npz' = CorpusRunner.run + "
        "FeatureDataset (the materialized route)",
    )
    args = ap.parse_args(argv)
    dev = device_of(args)
    cfg = example_cfg()
    rng = np.random.default_rng(0)

    # ---- data: synthetic CV tokens -> pipeline features -----------------
    timing = cfg.params.derive(SR)
    n_total = args.classes * args.n_per_class
    labels = np.repeat(np.arange(args.classes), args.n_per_class)
    sigs = [pad_signal(synth_token(c, rng, SR), timing) for c in labels]
    feats, labels = extract_features(args, cfg, sigs, labels, dev)
    feats = feats.reshape(n_total, -1)  # A1 input layer
    print(f"features: {tuple(feats.shape)} from {n_total} tokens")

    perm = rng.permutation(n_total)
    split = int(0.8 * n_total)
    tr = torch.as_tensor(perm[:split], device=dev)
    te = torch.as_tensor(perm[split:], device=dev)
    labels_d = torch.as_tensor(labels, dtype=torch.int64, device=dev)
    xtr, xte, ytr, yte = feats[tr], feats[te], labels_d[tr], labels_d[te]

    # ---- model: 2-layer MLP ---------------------------------------------
    gen = torch.Generator().manual_seed(0)
    model = MLP(feats.shape[1], 64, args.classes, generator=gen).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    def accuracy():
        with torch.no_grad():
            return float((model(xte).argmax(-1) == yte).float().mean())

    losses = []
    with precision_tier("highest"):
        t0 = time.perf_counter()
        for i in range(args.steps):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(xtr), ytr)
            loss.backward()
            opt.step()
            if i % 50 == 0 or i == args.steps - 1:
                losses.append(float(loss.detach()))
                print(f"step {i}: loss {losses[-1]:.4f} test acc "
                      f"{accuracy():.3f}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        acc = accuracy()
    print(f"final test accuracy: {acc:.3f} ({args.classes} classes)")
    return {"acc": acc, "first_loss": losses[0] if losses else float("nan"),
            "last_loss": losses[-1] if losses else float("nan"),
            "ms_per_step": 1e3 * train_s / max(args.steps, 1)}


if __name__ == "__main__":
    main()
