"""Batched processing and corpus extraction on one device (counterpart of
``auditory_tpu/pipeline/batch.py``).

The reference processes one window at a time; at corpus scale the batched
form pads utterances into [B, S_max] batches (bucketed by length), runs the
whole SndEnv program for every segment of every utterance at once, and masks
invalid segments and steps:

- step-invalid: window end beyond the signal -> zero columns
  (sndenv.go:353-359 break semantics; see dsp/frame.py);
- segment-invalid: segment index >= SegCnt(len) (sndenv.go:263-265) -> the
  reference never runs ProcessSegment for these; all outputs are zeroed and
  ``seg_valid`` is False.

:class:`CorpusRunner` overlaps four stages: host WAV decode (a thread pool)
|| batch dispatch to the device (the calling thread) || the device->host
copy of each finished batch (one download thread, into pinned memory, on a
copy stream that waits for the batch's compute) || ``.npz`` and manifest
writes (a thread pool). Decode and writes never touch the device. The JSONL
manifest makes a run resumable.

Transfer-volume controls (the device->host copy and the writes, not device
compute, bound corpus extraction):

- ``transfer='auto'`` uploads 8/16-bit PCM as raw int16 (half the bytes of
  float32) and divides by the reference's divisor (sound/sound.go:130-141)
  on the device; this can differ from the host float path by <= 1 ulp of
  float32 per sample. ``transfer='float32'`` takes the host float path.
- ``transfer_dtype=torch.float16`` casts the saved features to half
  precision (saturating at 65504) before the copy.
- ``transfer_dtype='int8'`` quantizes the packed features per utterance and
  channel (lossy, <= half a quantization step; see :class:`PackedBatch`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SndEnvConfig
from ..io.wav import load_wav
from ..parallel.mesh import batch_sharding, check_mesh, split_range
from .sndenv import SndEnv, SndEnvOutputs

__all__ = [
    "BatchedSndEnv", "CorpusRunner", "CorpusStats", "PackEntry",
    "PackedBatch", "bucket_length",
]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class PackEntry:
    """Layout of one key inside a :class:`PackedBatch` buffer."""

    key: str
    kind: str                       # "seg" (rows = segments) | "global"
                                    # | "meta" (row count never trimmed)
    view_shape: Tuple[int, ...]     # per-row trailing shape (post-fold)
    final_shape: Tuple[int, ...]    # true per-row trailing shape
    fold_ax: Optional[int]          # on/off axis in view_shape, or None
    rows: int                       # current row count in the buffer
    qchan_ax: Optional[int] = None  # int8 mode: channel axis in view_shape
    n_chan: int = 0                 # int8 mode: channels (0 = unquantized)

    @property
    def row_cols(self) -> int:
        n = 1
        for d in self.view_shape:
            n *= d
        if self.fold_ax is not None:
            n //= 2
        return n

    @property
    def cols(self) -> int:
        return self.rows * self.row_cols


@dataclass
class PackedBatch:
    """One flat buffer [B, C] holding a whole batch's saved features, so a
    batch leaves the device in a single copy.

    Byte reductions applied at pack time (all lossless):

    - gabor on/off **fold**: the reference's half-rectified on/off pair
      (agabor/gabor.go:284-308) has at most one nonzero per (on, off) unit
      -- kWTA keeps exact zeros under the :func:`_onoff_fold_exact`
      condition -- so the pair is stored as one signed value ``on - off``
      and rebuilt exactly as (max(v, 0), max(-v, 0));
    - **global-grid dedup**: a ``kind='global'`` entry (mel on the shared
      window grid) carries each window once instead of once per overlapping
      segment; callers expand it with ``SndEnv.global_grid``;
    - no validity column: per-file segment counts are a pure function of the
      host-known lengths.

    Opt-in lossy reduction (``transfer_dtype='int8'``): every float entry is
    quantized to int8 with per-row (utterance), per-channel ranges -- affine
    over [min, max] for spectral tensors, symmetric around zero for the
    signed gabor fold so exact zeros and on/off routing survive. NaN (the
    mel triangle quirk can emit them) takes the reserved code -128. The
    float32 (scale, offset) pairs ride inside the same buffer as each row's
    trailing ``__qmeta__`` bytes. The error is at most half a quantization
    step: (max - min)/508 per row-channel (affine) or max|x|/254
    (symmetric)."""

    data: torch.Tensor              # [B, C], on the device or the host
    entries: Tuple[PackEntry, ...]
    sps: int                        # stride/step ratio (global-row trim)
    steps: int                      # segment_steps (global-row trim)

    def _rows_for(self, kind: str, max_seg: int) -> int:
        if kind == "seg":
            return max_seg
        if kind == "meta":
            return 1 << 62  # never trimmed (trim min()s against e.rows)
        return (max_seg - 1) * self.sps + self.steps if max_seg > 0 else 0

    def trim(self, max_seg: int) -> "PackedBatch":
        """Slice to the first ``max_seg`` segments (the rest are invalid
        padding for every file in the batch), where the buffer lies; this
        shrinks the copy."""
        parts, new_entries, off = [], [], 0
        changed = False
        for e in self.entries:
            rows = min(self._rows_for(e.kind, max_seg), e.rows)
            parts.append(self.data[:, off : off + rows * e.row_cols])
            new_entries.append(dataclasses.replace(e, rows=rows))
            changed |= rows != e.rows
            off += e.cols
        if not changed:
            return self
        return dataclasses.replace(
            self, data=torch.cat(parts, dim=-1), entries=tuple(new_entries)
        )

    def unpack(self) -> Dict[str, np.ndarray]:
        """The host buffer -> {key: [B, rows, ...]} with folds expanded
        (``global`` entries stay on the global grid) and, in int8 mode,
        values dequantized to float32 (NaN code restored). A buffer on the
        device is copied to the host first."""
        host = self.data.cpu().numpy()
        b = host.shape[0]
        qscales = None
        if host.dtype == np.int8 and self.entries and (
            self.entries[-1].key == "__qmeta__"
        ):
            meta = self.entries[-1]
            tail = np.ascontiguousarray(host[:, host.shape[1] - meta.cols:])
            # [B, n_floats]; per entry: scale [B, n], offset [B, n]
            qscales = tail.view(np.float32)
        out, off, qoff = {}, 0, 0
        for e in self.entries:
            if e.key == "__qmeta__":
                continue
            block = host[:, off : off + e.cols]
            off += e.cols
            folded_shape = list(e.view_shape)
            if e.fold_ax is not None:
                folded_shape[e.fold_ax] = 1
            v = block.reshape((b, e.rows) + tuple(folded_shape))
            if qscales is not None and e.n_chan:
                scale = qscales[:, qoff : qoff + e.n_chan]
                qo = qscales[:, qoff + e.n_chan : qoff + 2 * e.n_chan]
                qoff += 2 * e.n_chan
                bshape = [b] + [1] * (v.ndim - 1)
                if e.qchan_ax is not None:
                    bshape[2 + e.qchan_ax] = e.n_chan
                x = v.astype(np.float32) * scale.reshape(bshape) + qo.reshape(bshape)
                v = np.where(v == -128, np.float32(np.nan), x)
            if e.fold_ax is None:
                out[e.key] = v.reshape((b, e.rows) + e.view_shape)
                continue
            on = np.maximum(v, 0)
            off_ch = np.maximum(-v, 0)
            full = np.concatenate([on, off_ch], axis=2 + e.fold_ax)
            out[e.key] = full.reshape((b, e.rows) + e.final_shape)
        return out


def _quant_chan_axis(
    key: str, view_shape: Tuple[int, ...], fold_ax: Optional[int]
) -> Optional[int]:
    """int8 mode: which axis of the per-row view indexes feature channels
    (each channel gets its own quantization range). Gabor layouts quantize
    per filter (4-D) / per freq row (2-D); spectral [C, steps] tensors per
    band/coefficient; mel_fbank_global rows are [n_mel] vectors; a 1-D
    [steps] row (energy) is one channel."""
    if fold_ax is not None:
        return 3 if len(view_shape) == 4 else 0
    if len(view_shape) >= 2 or key == "mel_fbank_global":
        return 0
    return None


def _saturate_cast(x: torch.Tensor, td: torch.dtype) -> torch.Tensor:
    """Cast to the transfer dtype, saturating float -> float16 at the f16
    max (65504) instead of overflowing to +-inf: the unnormalized DFT power
    reaches (win*amp)^2 ~ 1.6e5 on full-scale 16 kHz input. NaN passes
    through the clamp unchanged. Non-float tensors are cast without the
    clamp (a packed buffer has one dtype)."""
    if td == torch.float16 and x.is_floating_point():
        x = torch.clamp(x, -65504.0, 65504.0)
    return x.to(td)


def _quantize_int8(
    a: torch.Tensor,
    chan_ax: Optional[int],
    symmetric: bool,
    per_row: bool = False,
):
    """Quantize [B, rows, *view] to int8 with per-channel ranges computed
    where ``a`` lies. Returns (q int8, scale f32, offset f32);
    dequantization is ``q * scale + offset`` with the reserved code -128
    restoring non-finite values as NaN. ``symmetric`` centers the grid on
    zero (q=0 <-> exactly 0.0), for the signed gabor fold. ``per_row`` keeps
    axis 0 (the utterance) out of the range reductions: each row gets its
    own scales ([B, n_chan] instead of [n_chan]), so a quiet row batched
    with a loud one keeps its own precision."""
    a = a.to(torch.float32)
    red = tuple(
        i for i in range(a.ndim)
        if (chan_ax is None or i != 2 + chan_ax) and (i != 0 or not per_row)
    )
    finite = torch.isfinite(a)
    inf = torch.tensor(float("inf"), device=a.device)
    amax = torch.where(finite, a, -inf).amax(dim=red, keepdim=True)
    amin = torch.where(finite, a, inf).amin(dim=red, keepdim=True)
    empty = amin > amax  # channel with no finite values
    zero = torch.zeros((), device=a.device)
    amax = torch.where(empty, zero, amax)
    amin = torch.where(empty, zero, amin)
    if symmetric:
        scale = torch.maximum(amax.abs(), amin.abs()) / 127.0
        offv = torch.zeros_like(scale)
    else:
        scale = (amax - amin) / 254.0
        offv = amin + 127.0 * scale
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round((a - offv) / safe), -127.0, 127.0)
    q = torch.where(scale == 0, zero, q)
    q = torch.where(finite, q, torch.full((), -128.0, device=a.device))
    sshape = (a.shape[0], -1) if per_row else (-1,)
    return q.to(torch.int8), scale.reshape(sshape), offv.reshape(sshape)


def _onoff_fold_exact(kwta) -> bool:
    """Whether the gabor on/off fold is exact through the kWTA settle.

    The fold relies on 'at most one of each (on, off) pair is nonzero'. The
    convolution guarantees it for the raw output; the settle keeps it iff a
    zero-drive unit stays exactly zero, i.e. the noisy-XX1 shoulder (which
    extends 4*nvar below 0) cannot reach the minimum threshold drive
    ge_thr(gi=0) = gbar_l*(thr - erev_l)/(erev_e - thr). With the defaults
    (nvar=0.01 -> 0.04 <= 0.08) it holds; a raised nvar can break it, and
    then the pack keeps both channels."""
    if not kwta.on:
        return True
    min_thr = (
        kwta.gbar_l * (kwta.thr - kwta.erev_l) / (kwta.erev_e - kwta.thr)
    )
    return 4.0 * kwta.xx1_nvar <= min_thr


def bucket_length(
    n: int,
    timing,
    min_samples: Optional[int] = None,
    quantum: int = 0,
) -> int:
    """Round a padded signal length up to the next stride boundary, so that
    utterances of similar length share one padded batch shape. ``quantum``
    (samples) coarsens the buckets further; masking makes the extra padding
    free."""
    stride = timing.stride_samples
    base = timing.segment_samples
    step = max(stride, quantum)
    if n <= base:
        out = base
    else:
        k = -(-(n - base) // step)
        out = base + k * step
        # keep the stride alignment the masking math expects
        out = base + (-(-(out - base) // stride)) * stride
    if min_samples is not None:
        out = max(out, min_samples)
    return out


def _pad_batch_rows(signals, lengths, divisors, multiple, min_rows=0):
    """Pad the batch to a multiple of ``multiple`` rows with inert rows
    (zero signal, length 0, divisor 1: the validity masks and the stats
    moments ignore them). On one device the multiple is 1; a device mesh
    pads to its local shard count. Returns (signals [B', S],
    lengths int32 [B'], divisors float32 [B'] or None, pad count)."""
    b = signals.shape[0]
    pad = _round_up(max(b, min_rows), multiple) - b
    dev = signals.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    if divisors is not None:
        divisors = torch.as_tensor(divisors, dtype=torch.float32, device=dev)
    if pad:
        signals = torch.cat(
            [signals, signals.new_zeros((pad,) + tuple(signals.shape[1:]))]
        )
        lengths = torch.cat([lengths, lengths.new_zeros(pad)])
        if divisors is not None:
            divisors = torch.cat([divisors, divisors.new_ones(pad)])
    return signals, lengths, divisors, pad


def _map_outputs(fn, out: SndEnvOutputs) -> SndEnvOutputs:
    return dataclasses.replace(out, **{
        f.name: fn(getattr(out, f.name)) for f in dataclasses.fields(out)
    })


def _join(parts, axis: int, dev, packed: bool):
    """Shard results ([out or PackedBatch, seg_valid?, stats?] each) joined
    on ``dev``: outputs, the packed buffer and seg_valid concatenated along
    ``axis``, the stats moments summed."""
    if len(parts) == 1 and parts[0][0] is not None:
        first = parts[0]
        move = lambda x: None if x is None else x.to(dev)
        out = (dataclasses.replace(first[0], data=first[0].data.to(dev))
               if packed else _map_outputs(move, first[0]))
        rest = [move(x) if torch.is_tensor(x) else x for x in first[1:]]
        if rest and isinstance(rest[-1], dict):
            rest[-1] = {k: v.to(dev) for k, v in rest[-1].items()}
        return (out,) + tuple(rest)

    def cat(xs):
        if xs[0] is None:
            return None
        if xs[0].ndim <= axis:
            # no batch/segment axis (mel_fbank_global's flat rows under
            # segment sharding are refused at construction)
            return xs[0].to(dev)
        return torch.cat([x.to(dev) for x in xs], dim=axis)

    if packed:
        out = dataclasses.replace(
            parts[0][0], data=cat([p[0].data for p in parts]))
    else:
        out = SndEnvOutputs(**{
            f.name: cat([getattr(p[0], f.name) for p in parts])
            for f in dataclasses.fields(parts[0][0])
        })
    res = [out]
    n_rest = len(parts[0]) - 1
    for i in range(1, n_rest + 1):
        vals = [p[i] for p in parts]
        if isinstance(vals[0], dict):
            res.append({k: sum(v[k].to(dev) for v in vals) for k in vals[0]})
        else:
            res.append(cat(vals))
    return tuple(res)


def _as_transfer_dtype(td) -> Optional[torch.dtype]:
    if td is None or isinstance(td, torch.dtype):
        return td
    dtype = getattr(torch, str(td), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown transfer dtype {td!r}")
    return dtype


class BatchedSndEnv:
    """The SndEnv pipeline over a padded utterance batch, on ``env``'s
    device or sharded over a device mesh (:mod:`..parallel.mesh`).

    ``shard_axis='batch'`` (default): data parallelism over utterances --
    each shard of the mesh takes a contiguous block of rows (padded with
    inert rows to a multiple of the shard count); only the feature-stats
    moments are summed over shards.

    ``shard_axis='segment'``: the segment axis of few very long utterances
    is split instead -- every shard reads the whole (replicated) signal and
    computes a contiguous range of its segments, exactly as they are in the
    whole run (the same SegCnt, step validity, border and window grid);
    segments are independent when ``prev_smooth == 0``.

    On a mesh one SndEnv copy runs per distinct device, each on that
    device's current stream (launches are asynchronous, so the devices
    compute concurrently); the results are gathered onto the mesh's first
    device. A device may be listed more than once, each entry its own shard.

    ``transfer_dtype``: cast the floating outputs to this dtype before they
    are returned (``torch.float16`` halves the device->host bytes), or
    ``'int8'`` for per-channel quantized transfer (packed mode only; see
    :class:`PackedBatch`). ``pack_keys``: return these output fields packed
    into one :class:`PackedBatch` buffer instead of the SndEnvOutputs."""

    def __init__(
        self,
        env: SndEnv,
        mesh=None,
        shard_axis: str = "batch",
        transfer_dtype=None,
        pack_keys: Optional[Tuple[str, ...]] = None,
    ):
        if shard_axis not in ("batch", "segment"):
            raise ValueError("shard_axis must be 'batch' or 'segment'")
        if shard_axis == "segment" and env.cfg.dft.prev_smooth != 0.0:
            raise ValueError(
                "segment sharding requires prev_smooth == 0 (the smoothing "
                "recurrence couples the steps of a segment)"
            )
        if shard_axis == "segment" and mesh is not None and pack_keys:
            raise ValueError(
                "shard_axis='segment' cannot be combined with pack_keys: "
                "the packed [B, C] buffer flattens the segment axis into "
                "byte columns, so segment shards cannot be joined; pack on "
                "the batch axis, or use unpacked outputs with segment "
                "sharding"
            )
        if (shard_axis == "segment" and mesh is not None and env.outputs
                and "mel_fbank_global" in env.outputs):
            raise ValueError(
                "shard_axis='segment' cannot return mel_fbank_global: its "
                "rows are the windows shared across segment boundaries"
            )
        self.env = env
        self.mesh = check_mesh(mesh)
        self.shard_axis = shard_axis
        self.transfer_dtype = _as_transfer_dtype(transfer_dtype)
        self.pack_keys = tuple(pack_keys) if pack_keys is not None else None
        self.quantize = self.transfer_dtype == torch.int8
        if self.quantize and self.pack_keys is None:
            raise ValueError(
                "transfer_dtype='int8' (quantized transfer) requires the "
                "packed mode (pack_keys); the unpacked API returns the true "
                "float tensors"
            )
        self._envs: Dict[torch.device, SndEnv] = {env.device: env}

    @property
    def batch_multiple(self) -> int:
        if self.mesh is None or self.shard_axis != "batch":
            return 1
        return self.mesh.local_size

    def _env_on(self, dev: torch.device) -> SndEnv:
        """The SndEnv copy on ``dev`` (made once: the constants are copied
        there, the configuration and caches are the env's own)."""
        if dev not in self._envs:
            self._envs[dev] = copy.deepcopy(self.env).to(dev)
        return self._envs[dev]

    def process(self, signals, lengths, add_ms: int = 0, divisors=None):
        """signals [B, S] (padded), lengths [B] -> (outputs with leading
        [B, seg] axes, seg_valid [B, seg]), plus the feature-stats dict when
        the env has ``feature_stats``. In packed mode the first element is a
        :class:`PackedBatch` and ``seg_valid`` is left out (it is a pure
        function of the lengths).

        With ``divisors`` [B], signals are raw integer samples (int16) and
        are normalized on the device: ``signals.to(dtype) / divisors``. NumPy
        input is copied to the device.

        On a mesh any batch size works: the batch is padded internally with
        zero-length rows (inert in the validity masks and the stats
        moments), and the pad rows are sliced off the returned outputs,
        which lie on the mesh's first device."""
        signals = torch.as_tensor(
            signals, device=self.env.device if self.mesh is None else None
        )
        if divisors is None and not signals.is_floating_point():
            raise ValueError(
                f"integer signals ({signals.dtype}) need divisors= to be "
                "normalized on the device"
            )
        if self.mesh is None:
            # one device needs no pad rows (multiple 1): this only puts
            # lengths and divisors on the device in their dtypes
            signals, lengths, divisors, _ = _pad_batch_rows(
                signals, lengths, divisors, 1
            )
            return self._run(self.env.device, signals, lengths, divisors,
                             add_ms)
        b = signals.shape[0]
        if self.shard_axis == "segment":
            signals, lengths, divisors, _ = _pad_batch_rows(
                signals, lengths, divisors, 1
            )
            n_seg = max(self.env.seg_cnt(signals.shape[-1]), 1)
            ranges = split_range(n_seg, self.mesh.local_size)
            return self._run_segments(
                list(zip(self.mesh.local_devices, ranges)), signals, lengths,
                divisors, add_ms,
            )
        signals, lengths, divisors, pad = _pad_batch_rows(
            signals, lengths, divisors, self.batch_multiple
        )
        res = self._run_rows(signals, lengths, divisors, add_ms)
        if pad:
            trim = lambda x: None if x is None else x[:b]
            out = (dataclasses.replace(res[0], data=res[0].data[:b])
                   if self.pack_keys is not None
                   else _map_outputs(trim, res[0]))
            rest = tuple(res[1:])
            if self.pack_keys is None:
                rest = (rest[0][:b],) + rest[1:]
            res = (out,) + rest
        return res

    def process_local(self, signals, lengths, add_ms: int = 0, divisors=None):
        """Multi-process entry (:func:`..parallel.distributed.initialize`):
        each process passes only its LOCAL batch rows and computes them on
        its own shards of the mesh; the feature-stats moments are summed
        over all ranks (the one collective). Ranks may pass different row
        counts.

        Rows are padded internally to the local shard count with
        zero-length rows (inert) and are NOT trimmed: ``pad_rows`` says how
        many (:func:`..parallel.distributed.gather_local_rows` drops them).

        With ``shard_axis='segment'`` every process passes the SAME full
        batch and computes its contiguous range of the segments over the
        mesh's global shard order (ranks past the last segment get an empty
        range); ``pad_rows`` is then 0 and
        :func:`..parallel.distributed.allgather` with ``axis=1`` joins the
        ranks' segments.

        Returns ``(res, pad_rows)``: ``res`` is the tuple :meth:`process`
        returns (outputs or packed buffer, seg_valid unless packed, and the
        all-reduced stats when ``feature_stats``), this process' block
        only, on its first local device."""
        from ..parallel import distributed

        if self.mesh is None:
            raise ValueError("process_local requires a mesh")
        mesh = self.mesh
        rank = distributed.process_index()
        mine = [i for i, p in enumerate(mesh.layout) if p.rank == rank]
        if not mine or mesh.local_size == 0:
            raise ValueError(
                "this process owns no shards of the mesh; every "
                "participating process must contribute devices"
            )
        signals = torch.as_tensor(signals)
        if divisors is None and not signals.is_floating_point():
            raise ValueError(
                f"integer signals ({signals.dtype}) need divisors= to be "
                "normalized on the device"
            )
        if self.shard_axis == "segment":
            signals, lengths, divisors, _ = _pad_batch_rows(
                signals, lengths, divisors, 1
            )
            n_seg = max(self.env.seg_cnt(signals.shape[-1]), 1)
            ranges = split_range(n_seg, mesh.size)
            jobs = [(mesh.local_devices[j], ranges[i])
                    for j, i in enumerate(mine)]
            res = self._run_segments(jobs, signals, lengths, divisors, add_ms)
            pad = 0
        else:
            signals, lengths, divisors, pad = _pad_batch_rows(
                signals, lengths, divisors, mesh.local_size, min_rows=1
            )
            res = self._run_rows(signals, lengths, divisors, add_ms)
        if self.env.feature_stats:
            stats = {k: distributed.all_reduce_sum(v)
                     for k, v in res[-1].items()}
            res = tuple(res[:-1]) + (stats,)
        return res, pad

    # ------------------------------------------------------------ execution

    def _run(self, dev, signals, lengths, divisors, add_ms, segments=None):
        """One block through the SndEnv copy on ``dev``: normalization,
        the pipeline, the transfer cast and the packing."""
        env = self._env_on(dev)
        signals = signals.to(dev)
        lengths = lengths.to(dev)
        if divisors is not None:
            # the reference normalization (sound/sound.go:130-141): divide,
            # not reciprocal-multiply, to stay within 1 ulp of the host path
            signals = signals.to(env.dtype) / divisors.to(dev)[:, None].to(
                env.dtype)
        res = env(signals, lengths, add_ms, segments)
        out, rest = res[0], tuple(res[1:])
        if self.transfer_dtype is not None and not self.quantize:
            out = dataclasses.replace(out, **{
                f.name: _saturate_cast(v, self.transfer_dtype)
                for f in dataclasses.fields(out)
                if (v := getattr(out, f.name)) is not None
                and v.is_floating_point()
            })
        if self.pack_keys is not None:
            return (self._pack(out),) + rest[1:]
        return (out,) + rest

    def _run_rows(self, signals, lengths, divisors, add_ms):
        """Row blocks over the local shards, joined on the first device."""
        dev0 = self.mesh.local_devices[0]
        blocks = batch_sharding(self.mesh, signals.shape[0])
        parts = [
            self._run(dev, signals[sl], lengths[sl],
                      None if divisors is None else divisors[sl], add_ms)
            for dev, sl in zip(self.mesh.local_devices, blocks)
        ]
        return _join(parts, 0, dev0, self.pack_keys is not None)

    def _run_segments(self, jobs, signals, lengths, divisors, add_ms):
        """(device, (s0, s1)) segment ranges, joined along the segment axis
        on the first local device. A process whose ranges are all empty
        computes one segment and returns none of it (its stats are zero), so
        it still takes part in the collectives."""
        dev0 = self.mesh.local_devices[0]
        live = [(d, r) for d, r in jobs if r[1] > r[0]]
        if not live:
            res = self._run(dev0, signals, lengths, divisors, add_ms, (0, 1))
            empty = lambda x: None if x is None else x[:, :0]
            out = (_map_outputs(empty, res[0]), res[1][:, :0])
            if len(res) > 2:
                out += ({k: torch.zeros_like(v) for k, v in res[2].items()},)
            return out
        parts = [self._run(d, signals, lengths, divisors, add_ms, r)
                 for d, r in live]
        return _join(parts, 1, dev0, False)

    def _pack(self, out: SndEnvOutputs) -> PackedBatch:
        """The saved features in one flat [B, C] buffer: gabor on/off pairs
        folded into one signed channel, global-grid entries once per shared
        window, and in int8 mode the per-row scales as a byte trailer."""
        env = self.env
        ptd = self.transfer_dtype or env.dtype
        cols, entries, qscales = [], [], []
        for k in self.pack_keys:
            a = getattr(out, k)
            if a is None:
                continue
            final_shape = tuple(a.shape[2:])
            view_shape, fold_ax = final_shape, None
            kind = "global" if k == "mel_fbank_global" else "seg"
            foldable = k == "gabor_raw" or (
                k == "gabor_kwta" and _onoff_fold_exact(env.cfg.kwta)
            )
            if foldable:
                if env.is_4d and len(final_shape) == 4:
                    fold_ax = 2  # [py, px, 2, nf]
                elif len(final_shape) == 2 and final_shape[0] % 2 == 0:
                    # the 2-D layout interleaves on/off rows (2f, 2f+1)
                    view_shape = (final_shape[0] // 2, 2, final_shape[1])
                    fold_ax = 1
            if fold_ax is not None:
                v = a.reshape(a.shape[:2] + view_shape)
                on, off = torch.chunk(v, 2, dim=2 + fold_ax)
                a = on - off  # exact: at most one of the pair is nonzero
            qchan_ax, n_chan = None, 0
            if self.quantize:
                if not a.is_floating_point():
                    raise ValueError(
                        f"int8 quantized transfer: key {k!r} is {a.dtype}, "
                        "not float"
                    )
                qchan_ax = _quant_chan_axis(k, view_shape, fold_ax)
                n_chan = 1 if qchan_ax is None else view_shape[qchan_ax]
                a, scale, offv = _quantize_int8(
                    a, qchan_ax, symmetric=fold_ax is not None, per_row=True
                )
                qscales += [scale, offv]  # each [B, n_chan]
                flat = a.reshape(a.shape[0], -1)
            else:
                flat = _saturate_cast(a.reshape(a.shape[0], -1), ptd)
            cols.append(flat)
            entries.append(PackEntry(
                key=k, kind=kind, view_shape=view_shape,
                final_shape=final_shape, fold_ax=fold_ax, rows=a.shape[1],
                qchan_ax=qchan_ax, n_chan=n_chan,
            ))
        if self.quantize:
            # per-row trailer: each row carries its own float32 scale and
            # offset bytes (little-endian, as the host reads them back)
            svec = torch.cat(qscales, dim=1)  # [B, n_floats]
            sbytes = svec.contiguous().view(torch.int8)  # [B, 4 * n_floats]
            cols.append(sbytes)
            entries.append(PackEntry(
                key="__qmeta__", kind="meta",
                view_shape=(int(sbytes.shape[1]),),
                final_shape=(int(sbytes.shape[1]),), fold_ax=None, rows=1,
            ))
        t = env.timing
        sps = (
            t.stride_samples // t.step_samples
            if t.step_samples and t.stride_samples % t.step_samples == 0
            else 0
        )
        return PackedBatch(
            data=torch.cat(cols, dim=-1), entries=tuple(entries), sps=sps,
            steps=t.segment_steps,
        )


@dataclass
class CorpusStats:
    files_done: int = 0
    files_failed: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0


_SENTINEL = object()


def _rate_mismatch_msg(got: int, want: int) -> str:
    """Shared by the Python and native decode paths (they must not drift)."""
    return f"sample rate {got} != pipeline rate {want}"


def _multichannel_msg(channels: int) -> str:
    """SegCnt divides by Channels() (sndenv.go:263-265): a multi-channel
    file in a mono batch would get ~channels x the segments, so it is
    refused as a failure record. Shared by both decode paths."""
    return (
        f"{channels}-channel WAV: corpus batching is single-channel; "
        "de-interleave first (e.g. cli process --channel N)"
    )


class CorpusRunner:
    """Resumable overlapped batched extraction over a corpus of WAV files.

    Stages, all concurrent:

    - a decode thread feeds a bounded queue from a thread pool of WAV
      decoders;
    - the calling thread forms length buckets and dispatches device
      batches: PyTorch returns before the device finishes, so batch N
      computes while N+1 decodes and N-1 is copied and written. After each
      batch it records a CUDA event;
    - one download thread waits on that event from a copy stream and copies
      the batch's single packed buffer into pinned host memory;
    - a write pool saves per-utterance ``.npz`` files and the manifest.

    ``manifest.jsonl`` in ``out_dir`` holds one record per file ({path,
    status: ok|error, error?}); on resume, files already 'ok' are skipped.
    Undecodable files are recorded as errors, never fatal.
    ``pipeline_depth`` bounds the dispatched-but-not-downloaded batches
    (device memory backpressure).

    ``mesh``: shard every batch over a device mesh (:class:`BatchedSndEnv`);
    :meth:`run_distributed` spreads the corpus over processes.
    Files are decoded by the native threaded decoder (:mod:`..io.native`)
    when its library builds, else by :mod:`..io.wav`; :attr:`decode_counts`
    counts the files each decoder read.
    """

    # batches per float32 device partial of the feature-stats moments before
    # a float64 host fold: 64 batches of <= 2^18 steps each stay far below
    # float32's 2^24 integer limit
    _MOMENTS_FOLD = 64

    def __init__(
        self,
        cfg: SndEnvConfig,
        sample_rate: int,
        batch_size: int = 128,
        dtype: torch.dtype = torch.float32,
        save_keys: Sequence[str] = ("mel_fbank_segment", "gabor_kwta"),
        decode_threads: int = 8,
        bucket_quantum_s: float = 1.0,
        feature_stats: bool = True,
        transfer: str = "auto",
        transfer_dtype=None,
        pipeline_depth: int = 3,
        dedup_mel: Optional[bool] = None,
        matmul_precision: str = "highest",
        device=None,
        mesh=None,
    ):
        if transfer not in ("auto", "float32"):
            raise ValueError("transfer must be 'auto' or 'float32'")
        if mesh is not None and device is None:
            device = mesh.local_devices[0]
        # mel dedup: ship the global-grid mel (each shared window once) and
        # expand it host-side; needs the uniform window grid.
        # dedup_mel=None: auto; False: force the per-segment transfer
        t = cfg.params.derive(sample_rate)
        self._dedup_mel = (
            "mel_fbank_segment" in save_keys
            and t.step_samples > 0
            and t.stride_samples % t.step_samples == 0
            and cfg.dft.prev_smooth == 0.0
            and dedup_mel is not False
        )
        if dedup_mel is True and not self._dedup_mel:
            raise ValueError(
                "dedup_mel requires mel_fbank_segment in save_keys, a "
                "stride divisible by the step, and prev_smooth == 0"
            )
        # requesting mel_fbank_segment and mel_fbank_global under dedup must
        # not pack the grid twice
        env_keys = tuple(dict.fromkeys(
            "mel_fbank_global"
            if (k == "mel_fbank_segment" and self._dedup_mel) else k
            for k in save_keys
        ))
        # only what gets saved is computed; validity is never shipped
        self.env = SndEnv(
            cfg, sample_rate, dtype=dtype, outputs=env_keys,
            feature_stats=feature_stats, matmul_precision=matmul_precision,
            device=device,
        )
        self.batched = BatchedSndEnv(
            self.env, mesh=mesh, transfer_dtype=transfer_dtype,
            pack_keys=env_keys,
        )
        self._grid_cache: Dict[Tuple[int, int], Tuple] = {}
        self._batched_dev = None  # lazy: iter_device_features' unpacked env
        self.batch_size = batch_size
        self.save_keys = tuple(save_keys)
        self.decode_threads = decode_threads
        self._bucket_quantum = int(bucket_quantum_s * sample_rate)
        self.sample_rate = sample_rate
        self.transfer = transfer
        self.pipeline_depth = max(int(pipeline_depth), 1)
        # pre-pad audio lengths recorded at decode (reset per run): the
        # decoder returns padded signals, whose length would inflate the
        # reported corpus RTF by the pad fraction
        self._true_lens: Dict[str, int] = {}
        self._copy_stream = None
        self.decode_counts = {"native": 0, "python": 0}

    # ---------------------------------------------------------------- decode

    def _decode(self, path: str):
        """Single-file host decode -> (path, signal, divisor|None, err|None).

        divisor is set when the signal is raw int16 audio to be normalized
        on the device; None means the signal is already reference-normalized
        float32."""
        try:
            w = load_wav(path)
            if w.sample_rate != self.sample_rate:
                return path, None, None, _rate_mismatch_msg(
                    w.sample_rate, self.sample_rate
                )
            if w.channels > 1:
                return path, None, None, _multichannel_msg(w.channels)
            if self.transfer == "auto" and w.source_bit_depth <= 16:
                sig = w.data[: w.num_frames].astype(np.int16)
                self._true_lens[path] = len(sig)
                return path, self.env.pad(sig), np.float32(w._norm_divisor()), None
            sig = w.sound_to_tensor(dtype=np.float32)
            self._true_lens[path] = len(sig)
            return path, self.env.pad(sig), None, None
        except Exception as e:  # noqa: BLE001 - a failure record, never fatal
            return path, None, None, f"{type(e).__name__}: {e}"

    def _decode_many(self, paths):
        """Decode paths in order -> iterable of (path, signal|None,
        divisor|None, err|None): the native threaded batch decoder
        (csrc/auditory_io.cpp) when it builds, else the Python decoder on a
        thread pool."""
        from ..io import native

        if not native.available() or not paths:
            self.decode_counts["python"] += len(paths)
            with ThreadPoolExecutor(self.decode_threads) as pool:
                yield from pool.map(self._decode, paths)
            return

        # chunked native decode: bounds the [chunk, max_frames] buffer and
        # keeps host decode overlapping with device compute
        chunk_files = max(self.batch_size, 32)
        for lo in range(0, len(paths), chunk_files):
            group = paths[lo : lo + chunk_files]
            max_frames = 0
            metas = {}
            for p in group:
                try:
                    sr, ch, bd, nf = native.wav_info(p)
                    if ch > 1:
                        metas[p] = ValueError(_multichannel_msg(ch))
                        continue
                    metas[p] = (sr, nf)
                    max_frames = max(max_frames, nf)
                except Exception as e:  # noqa: BLE001 - a failure record
                    # as broad as the Python decoder's: any per-file error
                    # is a manifest record, never the end of the run
                    metas[p] = e
            ok_paths = [p for p in group if not isinstance(metas[p], Exception)]
            self.decode_counts["native"] += len(ok_paths)
            yield from self._native_decode_group(
                group, ok_paths, max(max_frames, 1), metas
            )

    def _native_decode_group(self, group, ok_paths, max_frames, metas):
        from ..io import native

        results: Dict[str, Tuple] = {}
        float_paths = ok_paths
        if self.transfer == "auto" and native.has_i16() and ok_paths:
            out, lengths, srs, divs, sts = native.decode_batch_i16(
                ok_paths, max_frames, n_threads=self.decode_threads
            )
            float_paths = []
            for i, p in enumerate(ok_paths):
                st = int(sts[i])
                if st == native.STATUS_NOT_I16:
                    float_paths.append(p)  # the float path below
                elif st != 0:
                    results[p] = (p, None, None,
                                  native.STATUS_NAMES.get(st, str(st)))
                elif srs[i] != self.sample_rate:
                    results[p] = (p, None, None, _rate_mismatch_msg(
                        srs[i], self.sample_rate
                    ))
                else:
                    sig = out[i, : lengths[i]]
                    self._true_lens[p] = int(lengths[i])
                    results[p] = (
                        p, self.env.pad(sig), np.float32(divs[i]), None
                    )
        if float_paths:
            out, lengths, srs, errors = native.decode_batch(
                float_paths, max_frames, n_threads=self.decode_threads
            )
            for i, p in enumerate(float_paths):
                if errors[i] is not None:
                    results[p] = (p, None, None, errors[i])
                elif srs[i] != self.sample_rate:
                    results[p] = (p, None, None, _rate_mismatch_msg(
                        srs[i], self.sample_rate
                    ))
                else:
                    sig = out[i, : lengths[i]]
                    self._true_lens[p] = int(lengths[i])
                    results[p] = (p, self.env.pad(sig), None, None)
        for p in group:
            meta = metas[p]
            if isinstance(meta, Exception):
                yield p, None, None, str(meta)
            else:
                yield results[p]

    # ---------------------------------------------------------------- naming

    @staticmethod
    def _out_names(paths: Sequence[str]) -> Dict[str, str]:
        """Unique output stem per input path. Same-named WAVs in different
        directories (the TIMIT layout: DR1/FCJF0/SA1.WAV, DR1/FVMH0/SA1.WAV)
        must not clobber each other, so stems come from the path relative to
        the corpus' common directory with separators flattened to '_'."""
        if not paths:
            return {}
        dirs = {os.path.dirname(os.path.abspath(p)) for p in paths}
        common = os.path.commonpath(list(dirs)) if len(dirs) > 1 else dirs.pop()
        naturals = [
            os.path.splitext(
                os.path.relpath(os.path.abspath(p), common)
            )[0].replace(os.sep, "_")
            for p in paths
        ]
        # flattening separators can itself collide (DR1/A/S1 vs DR1/A_S1);
        # disambiguate deterministically, with a '-n' suffix that also
        # avoids every natural stem
        natural_set = set(naturals)
        out = {}
        used = set()
        counts: Dict[str, int] = {}
        for p, stem in zip(paths, naturals):
            if stem not in used:
                used.add(stem)
                out[p] = stem
                continue
            n = counts.get(stem, 0) + 1
            cand = f"{stem}-{n}"
            while cand in used or cand in natural_set:
                n += 1
                cand = f"{stem}-{n}"
            counts[stem] = n
            used.add(cand)
            out[p] = cand
        return out

    # ------------------------------------------------------------------- run

    def run(
        self,
        wav_paths: Sequence[str],
        out_dir: str,
        resume: bool = True,
        add_ms: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> CorpusStats:
        """Extract features for ``wav_paths`` into ``out_dir``.

        Scale-out over hosts (``num_shards > 1``): each host runs its own
        runner over the interleaved slice ``wav_paths[shard_index::
        num_shards]`` with per-shard manifest and feature-stats files, and
        :meth:`merge_shards` combines them (moment sums add exactly). All
        hosts pass the same full ``wav_paths`` list (output stems are
        disambiguated against the full list)."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"{num_shards} shards"
            )
        os.makedirs(out_dir, exist_ok=True)
        self._stems = self._out_names(list(wav_paths))
        self._true_lens = {}
        suffix = f".shard{shard_index}of{num_shards}" if num_shards > 1 else ""
        wav_paths = list(wav_paths)[shard_index::num_shards]
        self._stats_path = os.path.join(out_dir, f"feature_stats{suffix}.json")
        manifest_path = os.path.join(out_dir, f"manifest{suffix}.jsonl")
        done = set()
        if resume and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("status") == "ok":
                        done.add(rec["path"])
        todo = [p for p in wav_paths if p not in done]

        stats = CorpusStats()
        # per-mel-band moments accumulate on the device (float32) batch by
        # batch and fold into a float64 host accumulator every
        # _MOMENTS_FOLD batches, so corpus-scale sums keep float64 precision
        self._moments_dev = None
        self._moments_host = None
        self._moments_pending = 0
        # resume: the moments of the already-done files live only in the
        # previous stats file. Seed from its raw float64 moments when they
        # cover exactly the resumed 'ok' set; otherwise the rewritten stats
        # cover only this run's files and are marked partial
        self._stats_partial = False
        self._stats_covered = 0  # ok-files whose moments the accumulator holds
        if done and self.env.feature_stats:
            prior = None
            if os.path.exists(self._stats_path):
                try:
                    with open(self._stats_path) as f:
                        prior = json.load(f)
                except (OSError, json.JSONDecodeError):
                    prior = None
            if (
                prior and "mel_sum" in prior and not prior.get("partial")
                and prior.get("files_covered") == len(done)
            ):
                self._moments_host = {
                    "sum": np.asarray(prior["mel_sum"], dtype=np.float64),
                    "sumsq": np.asarray(prior["mel_sumsq"], dtype=np.float64),
                    "count": np.float64(prior["count_steps"]),
                }
                self._stats_covered = len(done)
            else:
                self._stats_partial = True
        dev = self.env.device
        self._copy_stream = (
            torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        )
        t0 = time.perf_counter()

        # stage queues: decoded items in, dispatched batches out
        dq: queue.Queue = queue.Queue(maxsize=max(4 * self.batch_size, 64))
        wq: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        failures: List[BaseException] = []

        def decode_worker():
            try:
                for rec in self._decode_many(todo):
                    dq.put(rec)
            except BaseException as e:  # noqa: BLE001 - re-raised by run()
                failures.append(e)
            finally:
                dq.put(_SENTINEL)

        # one download thread drains batches in order; the write pool does
        # the npz/manifest writes without stalling it. The manifest, stats
        # and moments are guarded by one lock
        manifest = open(manifest_path, "a")
        manifest_lock = threading.Lock()
        pool = ThreadPoolExecutor(max(self.decode_threads, 4))
        write_futures: List = []
        # bounded download->write hand-off: each queued write pins a whole
        # batch's host arrays, so on a slow out_dir the download thread
        # blocks here, which propagates backpressure through wq to dispatch
        self._write_slots = threading.BoundedSemaphore(
            max(2 * self.pipeline_depth, 4)
        )

        def write_worker():
            while True:
                entry = wq.get()
                if entry is _SENTINEL:
                    return
                if failures:
                    continue  # drain so producers never block
                try:
                    self._write_entry(
                        entry, out_dir, manifest, manifest_lock, stats, pool,
                        write_futures,
                    )
                except BaseException as e:  # noqa: BLE001 - re-raised by run()
                    failures.append(e)

        dec_t = threading.Thread(target=decode_worker, name="corpus-decode")
        wrt_t = threading.Thread(target=write_worker, name="corpus-download")
        dec_t.start()
        wrt_t.start()
        try:
            buckets: Dict[Tuple[int, bool], List[Tuple]] = {}
            while True:
                rec = dq.get()
                if rec is _SENTINEL:
                    break
                if failures:
                    # a later stage failed: stop dispatching now instead of
                    # computing the rest of the corpus to discard it
                    break
                path, sig, div, err = rec
                if err is not None:
                    wq.put(("error", path, err))
                    continue
                blen = bucket_length(
                    len(sig), self.env.timing, quantum=self._bucket_quantum
                )
                key = (blen, div is not None)
                buckets.setdefault(key, []).append((path, sig, div))
                if len(buckets[key]) >= self.batch_size:
                    wq.put(self._dispatch(buckets.pop(key), blen, add_ms))
            if not failures:
                for (blen, _), items in list(buckets.items()):
                    wq.put(self._dispatch(items, blen, add_ms))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            failures.append(e)
        finally:
            wq.put(_SENTINEL)
            # the decode thread may be blocked on a full dq (e.g. when
            # dispatch raised); drain until it exits so join() cannot hang
            while dec_t.is_alive():
                try:
                    dq.get(timeout=0.05)
                except queue.Empty:
                    pass
            dec_t.join()
            wrt_t.join()
            for fut in write_futures:
                try:
                    fut.result()
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    failures.append(e)
            pool.shutdown(wait=True)
            manifest.close()
        if failures:
            raise failures[0]

        self._fold_moments_to_host()
        if (
            self.env.feature_stats
            and self._moments_host is None
            and not self._stats_partial
            and not done
        ):
            # a shard that processed no files still writes its stats: zero
            # moments merge exactly, and merge_shards wants a complete
            # 0..N-1 set. Gated on this run's state, not on the file's
            # existence, so a no-resume rerun of an emptied shard
            # overwrites stale moments
            nf = self.env.cfg.mel.fbank.n_filters
            self._moments_host = {
                "sum": np.zeros(nf, dtype=np.float64),
                "sumsq": np.zeros(nf, dtype=np.float64),
                "count": np.float64(0.0),
            }
        if self.env.feature_stats and self._moments_host is not None:
            # corpus-wide per-mel-band normalization statistics
            moments = self._moments_host
            cnt = max(float(moments["count"]), 1.0)
            mean = moments["sum"] / cnt
            var = np.maximum(moments["sumsq"] / cnt - mean**2, 0.0)
            payload = {
                "mel_mean": mean.tolist(),
                "mel_std": np.sqrt(var).tolist(),
                # the true step count: an empty shard contributes 0
                "count_steps": float(moments["count"]),
                # raw float64 moments, so shard files merge exactly and a
                # resumed run can seed its accumulator
                "mel_sum": moments["sum"].tolist(),
                "mel_sumsq": moments["sumsq"].tolist(),
                # the ok files these moments cover (the resume seed checks)
                "files_covered": self._stats_covered + stats.files_done,
            }
            if self._stats_partial:
                payload["partial"] = True  # this run's files only
            with open(self._stats_path, "w") as f:
                json.dump(payload, f)
        elif (
            self.env.feature_stats
            and self._stats_partial
            and os.path.exists(self._stats_path)
        ):
            # the resume seed refused the prior stats and this run made no
            # new moments: stamp the stale file partial in place so that
            # consumers refuse it too
            try:
                with open(self._stats_path) as f:
                    prior = json.load(f)
            except (OSError, json.JSONDecodeError):
                prior = {}
            prior["partial"] = True
            with open(self._stats_path, "w") as f:
                json.dump(prior, f)
        stats.wall_seconds = time.perf_counter() - t0
        return stats

    def iter_device_features(self, wav_paths: Sequence[str], add_ms: int = 0):
        """Stream the corpus through the batched pipeline and yield each
        batch's features on the device: no packing, no device->host copy,
        no npz round trip, for a consumer on the same device (e.g. a
        training loop).

        Yields ``(paths, outputs, seg_valid, n_segs)`` per length bucket:
        ``outputs`` is a :class:`SndEnvOutputs` of device tensors with
        leading ``[B, seg]`` axes (the runner's ``save_keys``, without the
        mel dedup), ``seg_valid`` the ``[B, seg]`` validity mask and
        ``n_segs`` the per-file segment counts. Decode errors raise (there
        is no manifest to record them in); the feature-stats moments are not
        accumulated."""
        if self._batched_dev is None:
            env = SndEnv(
                self.env.cfg, self.sample_rate, dtype=self.env.dtype,
                outputs=self.save_keys, feature_stats=False,
                matmul_precision=self.env.matmul_precision,
                device=self.env.device,
                # the runner env's frontend, so that a run through the
                # device-resident path measures the route the runner takes
                segment_frontend=self.env.segment_frontend,
            )
            self._batched_dev = BatchedSndEnv(env, mesh=self.batched.mesh)
        benv = self._batched_dev

        def flush(items, blen):
            signals, lengths, divisors, n_segs = self._assemble_batch(
                items, blen
            )
            out, seg_valid = benv.process(
                signals, lengths, add_ms, divisors=divisors
            )
            return [p for p, _, _ in items], out, seg_valid, n_segs

        buckets: Dict[Tuple[int, bool], List[Tuple]] = {}
        for path, sig, div, err in self._decode_many(list(wav_paths)):
            if err is not None:
                raise RuntimeError(f"decode failed for {path}: {err}")
            blen = bucket_length(
                len(sig), self.env.timing, quantum=self._bucket_quantum
            )
            key = (blen, div is not None)
            buckets.setdefault(key, []).append((path, sig, div))
            if len(buckets[key]) >= self.batch_size:
                yield flush(buckets.pop(key), blen)
        for (blen, _), items in list(buckets.items()):
            yield flush(items, blen)

    @staticmethod
    def merge_shards(out_dir: str) -> Dict[str, Any]:
        """Combine per-shard outputs of a multi-host run (see :meth:`run`)
        into the single-run artifacts: concatenates the ``manifest.shard*``
        records into ``manifest.jsonl`` and sums the shards' raw float64
        moments into ``feature_stats.json`` (exact: moments are additive).
        Returns a summary dict."""
        import glob
        import re

        def shard_set(pattern, regex):
            """{index: path}, enforcing one complete 0..N-1 set: a stale
            file of another N or a missing shard would corrupt the merge."""
            found = {}
            ns = set()
            for p in sorted(glob.glob(os.path.join(out_dir, pattern))):
                m = re.fullmatch(regex, os.path.basename(p))
                if not m:
                    continue
                i, n = int(m.group(1)), int(m.group(2))
                ns.add(n)
                found[i] = p
            if not found:
                return None, {}
            if len(ns) != 1:
                raise ValueError(
                    f"mixed shard generations in {out_dir}: found files "
                    f"for N in {sorted(ns)}; remove the stale set first"
                )
            n = ns.pop()
            missing = set(range(n)) - set(found)
            if missing:
                raise ValueError(
                    f"incomplete shard set in {out_dir}: missing shard "
                    f"indices {sorted(missing)} of {n} (is a host still "
                    "running?)"
                )
            return n, found

        n_man, man_shards = shard_set(
            "manifest.shard*.jsonl", r"manifest\.shard(\d+)of(\d+)\.jsonl"
        )
        if not man_shards:
            raise FileNotFoundError(
                f"no manifest.shard*.jsonl files in {out_dir}"
            )
        # last record per path wins (a resumed shard appends duplicates)
        by_path: Dict[str, str] = {}
        for i in sorted(man_shards):
            with open(man_shards[i]) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if "path" in rec:
                        by_path[rec["path"]] = line
        n_ok = n_err = 0
        with open(os.path.join(out_dir, "manifest.jsonl"), "w") as out:
            for line in by_path.values():
                rec = json.loads(line)
                n_ok += rec.get("status") == "ok"
                n_err += rec.get("status") == "error"
                out.write(line + "\n")

        n_stat, stat_map = shard_set(
            "feature_stats.shard*.json",
            r"feature_stats\.shard(\d+)of(\d+)\.json",
        )
        if stat_map and n_stat != n_man:
            raise ValueError(
                f"feature_stats shard count ({n_stat}) does not match the "
                f"manifest shard count ({n_man})"
            )
        stat_shards = [stat_map[i] for i in sorted(stat_map)]
        if stat_shards:
            tot_sum = tot_sq = None
            tot_cnt = 0.0
            tot_cov = 0
            for sp in stat_shards:
                with open(sp) as f:
                    s = json.load(f)
                if "mel_sum" not in s:
                    raise ValueError(
                        f"{sp} lacks raw moments (mel_sum); re-run the "
                        "shard with this version to enable merging"
                    )
                if s.get("partial"):
                    raise ValueError(
                        f"{sp} is marked partial (a resumed run without "
                        "prior moments); re-run that shard without resume "
                        "to get corpus-wide statistics"
                    )
                ssum = np.asarray(s["mel_sum"], dtype=np.float64)
                ssq = np.asarray(s["mel_sumsq"], dtype=np.float64)
                tot_sum = ssum if tot_sum is None else tot_sum + ssum
                tot_sq = ssq if tot_sq is None else tot_sq + ssq
                tot_cnt += float(s["count_steps"])
                tot_cov += int(s.get("files_covered", 0))
            cnt = max(tot_cnt, 1.0)
            mean = tot_sum / cnt
            var = np.maximum(tot_sq / cnt - mean**2, 0.0)
            merged_stats = {
                "mel_mean": mean.tolist(),
                "mel_std": np.sqrt(var).tolist(),
                # the true total (cnt is only the divide clamp)
                "count_steps": tot_cnt,
                "mel_sum": tot_sum.tolist(),
                "mel_sumsq": tot_sq.tolist(),
                "files_covered": tot_cov,
            }
            with open(os.path.join(out_dir, "feature_stats.json"), "w") as f:
                json.dump(merged_stats, f)
        return {
            "manifest_shards": len(man_shards),
            "stats_shards": len(stat_shards),
            "files_ok": n_ok,
            "files_failed": n_err,
        }

    def run_distributed(
        self,
        wav_paths: Sequence[str],
        out_dir: str,
        resume: bool = True,
        add_ms: int = 0,
    ) -> Tuple[CorpusStats, Optional[Dict[str, Any]]]:
        """Multi-process corpus extraction
        (:func:`..parallel.distributed.initialize`): this process runs the
        interleaved file shard ``wav_paths[rank::n_processes]`` (decode,
        compute and writes stay local), then rank 0 merges the per-shard
        manifests and float64 moments into the single-run artifacts
        (:meth:`merge_shards`; moment sums add exactly).

        Every rank first exchanges a digest of ``wav_paths`` over the gloo
        control plane and refuses a list that differs on any rank. Each
        rank's ``run()`` (and rank 0's merge) is caught, and the ranks
        exchange an ok/fail flag before the next barrier: when any rank
        failed, every rank raises, so one failing rank never leaves its
        siblings waiting.

        ``out_dir`` must be a filesystem every process writes to. Returns
        ``(local CorpusStats, merge summary on rank 0 else None)``."""
        import hashlib

        from ..parallel import distributed

        pid, nproc = distributed.process_index(), distributed.process_count()
        if nproc == 1:
            # one process: run() writes the unsuffixed artifacts directly
            return self.run(wav_paths, out_dir, resume=resume,
                            add_ms=add_ms), None
        wav_paths = list(wav_paths)
        digest = hashlib.sha256("\n".join(wav_paths).encode()).hexdigest()
        if len(set(distributed.all_gather_object(digest))) != 1:
            raise ValueError(
                "run_distributed: wav_paths differ across processes "
                "(path-list digests disagree); every process must pass "
                "the same ordered list"
            )

        def settle(step, fn):
            """Run ``fn`` here, then agree on every rank's outcome."""
            err, value = None, None
            try:
                value = fn()
            except Exception as e:  # noqa: BLE001 - re-raised on every rank
                err = e
            flags = distributed.all_gather_object(
                None if err is None else f"{type(err).__name__}: {err}")
            failed = {r: m for r, m in enumerate(flags) if m is not None}
            if failed:
                msg = (f"run_distributed: {step} failed on rank(s) "
                       f"{sorted(failed)}: " + "; ".join(
                           f"rank {r}: {m}" for r, m in failed.items()))
                raise RuntimeError(msg) from err
            return value

        stats = settle("run", lambda: self.run(
            wav_paths, out_dir, resume=resume, add_ms=add_ms,
            shard_index=pid, num_shards=nproc,
        ))
        distributed.barrier("corpus_run_distributed")
        summary = settle("merge", lambda: (
            self.merge_shards(out_dir) if pid == 0 else None))
        return stats, summary

    def _fold_moments_to_host(self):
        """Fold the device float32 moment partial into the float64 host
        accumulator (one small copy per _MOMENTS_FOLD batches)."""
        if self._moments_dev is None:
            return
        part = {
            k: v.cpu().numpy().astype(np.float64)
            for k, v in self._moments_dev.items()
        }
        if self._moments_host is None:
            self._moments_host = part
        else:
            self._moments_host = {
                k: self._moments_host[k] + part[k] for k in part
            }
        self._moments_dev = None
        self._moments_pending = 0

    def _assemble_batch(self, items, blen):
        """Decoded (path, signal, divisor) items -> the padded batch arrays
        (the int16 tier when the decoder produced raw int16) plus the
        per-file segment counts (sndenv.go:263-265)."""
        int16_mode = items[0][2] is not None
        signals = np.zeros(
            (len(items), blen), dtype=np.int16 if int16_mode else np.float32
        )
        lengths = np.zeros(len(items), dtype=np.int32)
        divisors = np.ones(len(items), dtype=np.float32) if int16_mode else None
        for i, (_, sig, div) in enumerate(items):
            signals[i, : len(sig)] = sig
            lengths[i] = len(sig)
            if int16_mode:
                divisors[i] = div
        n_segs = [max(self.env.seg_cnt(int(n)), 0) for n in lengths]
        return signals, lengths, divisors, n_segs

    def _dispatch(self, items, blen, add_ms):
        """Build the padded batch and dispatch it to the device; returns the
        entry the download thread waits on, with the CUDA event recorded
        after the batch's work (None on the CPU)."""
        signals, lengths, divisors, n_segs = self._assemble_batch(items, blen)
        res = self.batched.process(signals, lengths, add_ms, divisors=divisors)
        # trim the packed buffer to the batch max (quantized, so the slice
        # shapes stay few) before it is copied
        seg_full = max(self.env.seg_cnt(blen), 0)
        max_seg = min(_round_up(max(n_segs) if n_segs else 0, 4), seg_full)
        res = (res[0].trim(max_seg),) + tuple(res[1:])
        # host expansion metadata for the deduped mel (cached per bucket)
        grid = None
        if self._dedup_mel:
            gkey = (blen, add_ms)
            if gkey not in self._grid_cache:
                self._grid_cache[gkey] = self.env.global_grid(blen, add_ms)
            grid = self._grid_cache[gkey]
        event = None
        dev = self.env.device
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return ("batch", res, items, n_segs, grid, event)

    def _after(self, event):
        """Make the batch's device current and its work visible: the copy
        stream waits on the dispatch thread's event, and the block's device
        work (moment sums, the copy) is ordered after the batch's compute.
        A no-op on the CPU."""
        if event is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.env.device))
        self._copy_stream.wait_event(event)
        stack.enter_context(torch.cuda.stream(self._copy_stream))
        return stack

    def _to_host(self, packed: PackedBatch) -> PackedBatch:
        """The batch's one device->host copy, into pinned memory on the
        copy stream, waited for before the host reads it."""
        data = packed.data
        if data.device.type != "cuda":
            return packed
        host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
        host.copy_(data, non_blocking=True)
        self._copy_stream.synchronize()
        return dataclasses.replace(packed, data=host)

    def _write_entry(
        self, entry, out_dir, manifest, manifest_lock, stats, pool,
        write_futures,
    ):
        """Download-stage handler: wait for one dispatched batch, copy it to
        the host on this single thread, then hand the host arrays to the
        pool for the npz/manifest writes, so the next batch's copy starts at
        once."""
        if entry[0] == "error":
            _, path, err = entry
            with manifest_lock:
                stats.files_failed += 1
                manifest.write(
                    json.dumps({"path": path, "status": "error", "error": err})
                    + "\n"
                )
            return
        _, res, items, n_segs, grid, event = entry
        with self._after(event):
            if len(res) > 1 and res[1] is not None:
                # device-side accumulation (no per-batch copy), folded into
                # the float64 host accumulator every _MOMENTS_FOLD batches
                mom = res[1]
                with manifest_lock:
                    self._moments_dev = (
                        mom if self._moments_dev is None
                        else {k: self._moments_dev[k] + mom[k] for k in mom}
                    )
                    self._moments_pending += 1
                    if self._moments_pending >= self._MOMENTS_FOLD:
                        self._fold_moments_to_host()
            packed = self._to_host(res[0])
        host = packed.unpack()

        def write_batch():
            # the dedup-mel expansion runs here on the write pool, not on
            # the download thread, whose copies it would delay
            if grid is not None and "mel_fbank_global" in host:
                # expand the deduped global-grid mel to the per-segment
                # tensor and re-apply the step mask the device path applies
                # (SndEnv.global_grid)
                map_idx, win_ends = grid
                if "mel_fbank_global" in self.save_keys:
                    mg = host["mel_fbank_global"]  # the raw grid is saved too
                else:
                    mg = host.pop("mel_fbank_global")  # [B, n_flat_t, n_mel]
                seg_t = min(
                    (mg.shape[1] - packed.steps) // packed.sps + 1
                    if mg.shape[1] >= packed.steps else 0,
                    map_idx.shape[0],
                )
                mi = map_idx[:seg_t]
                # [B, seg_t, steps, n_mel] -> [B, seg_t, n_mel, steps]
                exp = mg[:, mi].transpose(0, 1, 3, 2)
                lens = np.asarray([len(sig) for _, sig, _ in items])
                valid = win_ends[None, :seg_t, :] <= lens[:, None, None]
                # where, not multiply: the mel NaN-triangle quirk means
                # masked values can be NaN, and NaN * 0 != 0
                host["mel_fbank_segment"] = np.where(
                    valid[:, :, None, :], exp, exp.dtype.type(0)
                )

            def write_one(i, path, n_audio):
                n_seg = n_segs[i]
                rec = {}
                for k, v in host.items():
                    if k == "mel_fbank_global":
                        # global-grid rows are windows, not segments
                        rows = (
                            (n_seg - 1) * packed.sps + packed.steps
                            if n_seg > 0 else 0
                        )
                    else:
                        rows = n_seg
                    rec[k] = v[i][:rows]
                stem = self._stems.get(
                    path, os.path.splitext(os.path.basename(path))[0]
                )
                np.savez(os.path.join(out_dir, stem + ".npz"), **rec)
                return path, n_audio

            # true (pre-pad) audio lengths for the stats: len(sig) is the
            # padded length, which would inflate the corpus RTF
            results = [
                write_one(i, path, self._true_lens.get(path, len(sig)))
                for i, (path, sig, _) in enumerate(items)
            ]
            with manifest_lock:
                for path, n_audio in results:
                    manifest.write(
                        json.dumps({"path": path, "status": "ok"}) + "\n"
                    )
                    stats.files_done += 1
                    stats.audio_seconds += n_audio / self.sample_rate
                manifest.flush()

        self._write_slots.acquire()  # bounded hand-off (see run())

        def bounded_write():
            try:
                write_batch()
            finally:
                self._write_slots.release()

        write_futures.append(pool.submit(bounded_write))
