"""Training-consumer reader for CorpusRunner output directories (PyTorch
counterpart of ``auditory_tpu/pipeline/dataset.py``).

The corpus runner writes one ``.npz`` per utterance plus ``manifest.jsonl``
and ``feature_stats.json``. :class:`FeatureDataset` enumerates the
artifacts, applies the corpus-wide per-mel-band normalization, and yields
padded, masked, fixed-shape batches as tensors on one device (variable
segment counts are padded to the batch max with an explicit validity mask).

Usage::

    ds = FeatureDataset("corpus_out/", keys=("mel_fbank_segment",))
    for batch in ds.batches(32, seed=0, normalize=True, device="cuda"):
        x = batch["mel_fbank_segment"]        # [B, max_seg, n_mel, steps]
        mask = batch["seg_valid"]             # [B, max_seg] bool
        ...
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["FeatureDataset"]


class FeatureDataset:
    """Reader over a :class:`..pipeline.batch.CorpusRunner` output dir."""

    def __init__(
        self,
        out_dir: str,
        keys: Optional[Sequence[str]] = None,
        label_fn: Optional[Callable[[str], int]] = None,
    ):
        """``keys``: feature keys to load (None = every key in the first
        npz). ``label_fn``: optional stem -> integer label; batches then
        carry a ``label`` tensor."""
        self.out_dir = out_dir
        self.label_fn = label_fn
        self.stems = sorted(
            f[:-4] for f in os.listdir(out_dir) if f.endswith(".npz")
        )
        if not self.stems:
            raise FileNotFoundError(f"no .npz feature files in {out_dir}")
        # key discovery reads the npz directory only (z.files)
        with np.load(os.path.join(out_dir, self.stems[0] + ".npz")) as z:
            first = tuple(z.files)
        self.keys = tuple(keys) if keys is not None else first
        missing = set(self.keys) - set(first)
        if missing:
            raise ValueError(
                f"keys {sorted(missing)} not in the corpus npz "
                f"(available: {sorted(first)})"
            )
        self._stats = None
        stats_path = os.path.join(out_dir, "feature_stats.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                self._stats = json.load(f)

    def __len__(self) -> int:
        return len(self.stems)

    def load(
        self, stem: str, keys: Optional[Sequence[str]] = None
    ) -> Dict[str, np.ndarray]:
        """One utterance's feature dict (per-file [n_seg, ...] NumPy arrays);
        ``keys`` restricts which npz members are read (None reads all)."""
        with np.load(os.path.join(self.out_dir, stem + ".npz")) as z:
            return {k: z[k] for k in (keys if keys is not None else z.files)}

    def normalizer(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) per mel band from the corpus feature_stats.json
        (std floored at 1e-6 so constant bands stay finite)."""
        if self._stats is None:
            raise FileNotFoundError(
                f"{self.out_dir}/feature_stats.json not found (run the "
                "corpus with feature_stats=True, or merge shards first)"
            )
        if self._stats.get("partial"):
            raise ValueError(
                f"{self.out_dir}/feature_stats.json is marked partial (a "
                "resumed run without prior moments); its statistics cover "
                "only that run's files -- re-run the corpus without resume"
            )
        mean = np.asarray(self._stats["mel_mean"], dtype=np.float32)
        std = np.maximum(
            np.asarray(self._stats["mel_std"], dtype=np.float32), 1e-6
        )
        return mean, std

    def batches(
        self,
        batch_size: int,
        seed: Optional[int] = None,
        normalize: bool = False,
        drop_remainder: bool = False,
        device=None,
    ) -> Iterator[Dict[str, object]]:
        """Yield fixed-shape batches on ``device`` (default the card; see
        :func:`~auditory_tpu_torch.config.resolve_device`).

        Each batch dict has, per requested key, a [B, max_seg, ...] tensor
        padded with zeros over the segment axis, plus ``seg_valid``
        [B, max_seg] bool, ``n_seg`` [B] int32, ``stem`` (list of str) and,
        with ``label_fn``, ``label`` [B] int32. The order for a ``seed`` is
        the JAX package's (the same seeded NumPy shuffle), and the values
        are the npz contents bit for bit.

        ``normalize=True`` applies the corpus (x - mean) / std per mel band
        to ``mel_fbank_segment`` (on the host, in float32, as the JAX
        package does). Padded segments are re-masked to exact zero
        afterwards; zero-masked steps inside valid segments are normalized
        like data.

        A CUDA ``device`` gets each tensor from pinned host memory with a
        non-blocking copy on the current stream."""
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if normalize and "mel_fbank_segment" not in self.keys:
            raise ValueError(
                "normalize=True requires 'mel_fbank_segment' among the "
                f"loaded keys (have {sorted(self.keys)})"
            )
        device = resolve_device(device)
        pin = device.type == "cuda"

        def to_device(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            return t.to(device, non_blocking=pin)

        order = np.arange(len(self.stems))
        if seed is not None:
            np.random.default_rng(seed).shuffle(order)
        norm = self.normalizer() if normalize else None
        for lo in range(0, len(order), batch_size):
            idx = order[lo : lo + batch_size]
            if drop_remainder and len(idx) < batch_size:
                return
            stems = [self.stems[i] for i in idx]
            recs = [self.load(s, self.keys) for s in stems]
            n_segs = np.array([r[self.keys[0]].shape[0] for r in recs],
                              dtype=np.int32)
            max_seg = int(n_segs.max()) if len(n_segs) else 0
            out: Dict[str, np.ndarray] = {}
            for k in self.keys:
                rows = []
                for r in recs:
                    a = r[k]
                    pad = max_seg - a.shape[0]
                    if pad:
                        a = np.concatenate(
                            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]
                        )
                    rows.append(a)
                out[k] = np.stack(rows)
            seg_valid = np.arange(max_seg)[None, :] < n_segs[:, None]
            if norm is not None:
                mean, std = norm
                x = out["mel_fbank_segment"].astype(np.float32)
                # [B, seg, n_mel, steps]: bands are axis -2
                x = (x - mean[:, None]) / std[:, None]
                out["mel_fbank_segment"] = np.where(
                    seg_valid[:, :, None, None], x, np.float32(0)
                )
            out["seg_valid"] = seg_valid
            out["n_seg"] = n_segs
            if self.label_fn is not None:
                out["label"] = np.array(
                    [self.label_fn(s) for s in stems], dtype=np.int32
                )
            batch: Dict[str, object] = {k: to_device(v) for k, v in out.items()}
            batch["stem"] = stems
            yield batch
