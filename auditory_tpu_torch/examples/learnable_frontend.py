"""Learnable gabor frontend: backpropagate through the feature extractor
(PyTorch counterpart of ``examples/learnable_frontend.py``).

The reference's gabor bank is a fixed, hand-designed prior (agabor.Filter
specs rendered once, agabor/gabor.go:89-221). The port's convolution stage
(``dsp.gabor.convolve``) is differentiable with respect to its filter
tensor, so the bank can be trained jointly with a classifier head as an
``nn.Parameter`` initialised from the biological prior.

Pipeline: signal -> (frozen) frame+DFT+mel via SndEnv (the fused kernel on a
CUDA device) -> learnable gabor convolve -> mean-pooled features -> linear
head, trained with Adam. The mel features are computed once; no gradient
flows above the gabor stage.

Checkpoint/resume: ``--ckpt-dir DIR`` saves the model and optimizer state
with ``torch.save`` every ``--ckpt-every`` steps (and at the end) into
``DIR/step_N``; rerunning with the same directory restores the latest
committed checkpoint and continues exactly where it stopped.

Usage: python -m auditory_tpu_torch.examples.learnable_frontend
       [--steps 300] [--device cuda|cpu] [--ckpt-dir DIR --ckpt-every 50]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import GaborSet
from ..dsp.design import gabor_filters
from ..dsp.gabor import convolve
from ..pipeline.batch import BatchedSndEnv
from ..pipeline.sndenv import SndEnv, precision_tier
from .train_phone_classifier import (
    SR,
    add_common_args,
    assemble_batch,
    device_of,
    example_cfg,
    synth_token,
)


class LearnableFrontend(nn.Module):
    """A gabor bank (``filters`` [nf, sy, sx], initialised from
    ``design.gabor_filters``) convolved over mel segments, mean-pooled over
    segments and positions to [N, 2*nf], and a linear ``head``. The head's
    W ~ N(0, 2/fan_in) is drawn from ``generator`` in the JAX layout and
    stored transposed; its bias is zero."""

    def __init__(self, gset: GaborSet, n_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gset = gset
        self.register_buffer(
            "prior", torch.as_tensor(gabor_filters(gset), dtype=torch.float32)
        )
        self.filters = nn.Parameter(self.prior.clone())
        din = 2 * self.prior.shape[0]
        self.head = nn.Linear(din, n_classes)
        with torch.no_grad():
            w = torch.randn(din, n_classes, generator=generator) * (2.0 / din) ** 0.5
            self.head.weight.copy_(w.T)
            self.head.bias.zero_()

    def featurize(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [N, seg, n_mel, steps] -> [N, 2*nf] mean gabor activations."""
        g = convolve(mel, self.filters, self.gset)  # [N, seg, fI, tI, 2, nf]
        return g.mean(dim=(1, 2, 3)).reshape(mel.shape[0], -1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.head(self.featurize(mel))


def committed_checkpoints(ckdir: str):
    """[(step, dir name)] of the committed checkpoints, oldest first: only
    directories named exactly ``step_<N>`` (a save in progress is a
    ``step_<N>.tmp-<pid>`` directory, which resume must not read)."""
    return sorted(
        (int(m.group(1)), d)
        for d in os.listdir(ckdir)
        for m in [re.fullmatch(r"step_(\d+)", d)]
        if m
    )


def save_checkpoint(ckdir: str, step: int, model, opt) -> None:
    """Write ``ckdir/step_<step>``: the state goes into a staging directory
    first and is renamed into place once written (replacing an older one)."""
    final = os.path.join(ckdir, f"step_{step}")
    staging = f"{final}.tmp-{os.getpid()}"
    os.makedirs(staging)
    torch.save({"model": model.state_dict(), "opt": opt.state_dict(),
                "step": step}, os.path.join(staging, "state.pt"))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(staging, final)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the example; returns the first and last loss, the filter drift,
    the final test accuracy and the wall ms per training step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    add_common_args(ap)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory; if it already holds "
                    "checkpoints, training resumes from the latest")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)
    dev = device_of(args)

    rng = np.random.default_rng(0)
    cfg = example_cfg()
    gset = cfg.gabor
    env = SndEnv(cfg, SR, outputs=("mel_fbank_segment", "step_valid"),
                 device=dev)

    # ---- data: synthetic CV tokens -> frozen mel features ----------------
    n_total = args.classes * args.n_per_class
    labels = np.repeat(np.arange(args.classes), args.n_per_class)
    sigs = [env.pad(synth_token(c, rng, SR)) for c in labels]
    batch, lengths = assemble_batch(sigs, env.timing)
    with torch.no_grad():
        out, _ = BatchedSndEnv(env).process(batch, lengths)
    # [N, seg, n_mel, steps]: the [freq, time] plane convolve consumes
    mel = out.mel_fbank_segment
    print(f"mel features: {tuple(mel.shape)}")

    perm = rng.permutation(n_total)
    split = int(0.8 * n_total)
    labels_d = torch.as_tensor(labels, dtype=torch.int64, device=dev)
    tr = torch.as_tensor(perm[:split], device=dev)
    te = torch.as_tensor(perm[split:], device=dev)

    # ---- model: learnable gabor bank (prior init) + linear head ----------
    gen = torch.Generator().manual_seed(0)
    model = LearnableFrontend(gset, args.classes, generator=gen).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    def accuracy(idx):
        with torch.no_grad():
            return float((model(mel[idx]).argmax(-1) == labels_d[idx])
                         .float().mean())

    # ---- optional checkpoint/resume ---------------------------------------
    start_step = 0
    ckdir = os.path.abspath(args.ckpt_dir) if args.ckpt_dir else ""
    if ckdir:
        os.makedirs(ckdir, exist_ok=True)
        done = committed_checkpoints(ckdir)
        if done:
            st = torch.load(os.path.join(ckdir, done[-1][1], "state.pt"),
                            map_location=dev, weights_only=True)
            model.load_state_dict(st["model"])
            opt.load_state_dict(st["opt"])
            start_step = int(st["step"])
            print(f"resumed from {done[-1][1]} (step {start_step})")

    xtr, ytr = mel[tr], labels_d[tr]
    # the feature convolution and its backward run in the env's tier (cuDNN
    # would otherwise take TF32)
    with precision_tier(env.matmul_precision):
        with torch.no_grad():
            # on a resumed run: the resumed parameters' loss
            first_loss = float(F.cross_entropy(model(xtr), ytr))
        loss_val = first_loss
        t0 = time.perf_counter()
        for i in range(start_step, args.steps):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(xtr), ytr)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if (i + 1) % args.ckpt_every == 0 and ckdir:
                save_checkpoint(ckdir, i + 1, model, opt)
            if i % 50 == 0 or i == args.steps - 1:
                print(f"step {i}: loss {float(loss):.4f} "
                      f"test acc {accuracy(te):.3f}")
            loss_val = loss
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        loss_val = float(loss_val)
        if ckdir and args.steps > start_step:
            save_checkpoint(ckdir, args.steps, model, opt)
        acc = accuracy(te)

    with torch.no_grad():
        drift = float(torch.linalg.norm(model.filters - model.prior)
                      / torch.linalg.norm(model.prior))
    print(f"filter drift from prior: {drift:.4f} (relative L2)")
    print(f"loss: {first_loss:.4f} -> {loss_val:.4f}")
    print(f"final test accuracy: {acc:.3f} ({args.classes} classes)")
    n = max(args.steps - start_step, 1)
    return {"first_loss": first_loss, "last_loss": loss_val, "drift": drift,
            "acc": acc, "ms_per_step": 1e3 * train_s / n}


if __name__ == "__main__":
    main()
