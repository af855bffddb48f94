"""Online (streaming) processing: feed audio chunks, get segments out
(counterpart of ``auditory_tpu/pipeline/online.py``).

The reference is strictly offline (whole WAV in memory); its only streaming
notion is the segment cursor (processspeech MoreSegments). For serving,
:class:`OnlineSndEnv` accepts arbitrary-size sample chunks and emits the same
per-segment outputs as the offline :class:`..pipeline.sndenv.SndEnv` as soon
as each segment's samples (including its right border windows) are
available, with O(segment) memory and one fixed input shape per call.

Equivalence: segment k of the offline pipeline needs stream samples
[k*stride - border*step, k*stride + (steps-1-border)*step + win). The online
processor keeps a rolling buffer of exactly that span and runs the offline
program on it with an ``add`` offset that shifts the window grid onto the
buffered history. At the default geometry the shifted grid starts at sample
0 of the buffer, so each call runs the fused frontend kernel on the uniform
window grid; off that grid (e.g. 22.05 kHz) the window gather runs.

:class:`MultiStreamOnline` serves N streams through one [N, span] call per
poll: the per-stream state is host (NumPy) bookkeeping over one flat ring,
and every output leaf of a poll leaves the device in ONE packed [N, C]
buffer (float32, float16 or per-row int8). With ``pipeline_depth`` >= 2 the
packed copy into pinned host memory runs on a copy stream while the next
poll's work is enqueued.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import SndEnvConfig, msec_to_samples, samples_to_msec
from ..dsp.frame import pad_len
from ..parallel.mesh import batch_sharding, check_mesh
from .batch import (
    _as_transfer_dtype,
    _quant_chan_axis,
    _quantize_int8,
    _saturate_cast,
)
from .sndenv import SndEnv, SndEnvOutputs

__all__ = ["OnlineSndEnv", "MultiStreamOnline", "BufferOverflow"]

PHASES = ("gather", "h2d", "dispatch", "compute", "d2h", "unpack", "emit")


class BufferOverflow(RuntimeError):
    """A feed() would exceed a stream's bounded buffer under the ``"error"``
    overflow policy (backpressure: the producer must poll or shed load)."""


class OnlineSndEnv:
    """Streaming wrapper around the SndEnv pipeline.

    Usage::

        online = OnlineSndEnv(cfg, 16000, device="cuda")
        for chunk in audio_chunks:          # any sizes
            for seg_idx, out in online.feed(chunk):
                consume(out.mel_fbank_segment, out.gabor_kwta, ...)
        for seg_idx, out in online.flush(): # zero-pad the tail
            ...

    Outputs are :class:`SndEnvOutputs` of tensors on the env's device, one
    segment each (no batch or segment axis).
    """

    def __init__(
        self,
        cfg: SndEnvConfig,
        sample_rate: int,
        dtype: torch.dtype = torch.float32,
        outputs: Optional[Tuple[str, ...]] = None,
        **env_kw,
    ):
        if outputs is not None and "mel_fbank_global" in outputs:
            raise ValueError(
                "mel_fbank_global is a corpus-transfer optimization on the "
                "shared window grid; the online paths emit per-segment "
                "tensors -- request mel_fbank_segment instead"
            )
        if env_kw.get("feature_stats"):
            raise ValueError(
                "feature_stats is a corpus-level reduction (CorpusRunner "
                "accumulates it across batches); the online paths would "
                "compute and silently discard it every poll"
            )
        self.env = SndEnv(
            cfg, sample_rate, dtype=dtype, outputs=outputs, **env_kw
        )
        t = self.env.timing
        border = cfg.params.border_steps
        self._pre = border * t.step_samples
        # last window of a segment starts at (steps-1-border)*step and spans win
        self._post = (t.segment_steps - 1 - border) * t.step_samples + t.win_samples
        self._span = self._pre + self._post
        # the add offset must convert to exactly _pre samples
        add_ms = samples_to_msec(self._pre, sample_rate)
        if msec_to_samples(add_ms, sample_rate) != self._pre:
            raise ValueError(
                "border offset does not round-trip through milliseconds; "
                "choose step_ms with integral sample counts"
            )
        self._add_ms = add_ms
        self._span_len_dev = None  # cached device length for full-span emits

        # np.dtype(torch.float32) raises; a 0-d tensor knows its numpy dtype
        self._np_dtype = torch.empty((), dtype=self.env.dtype).numpy().dtype
        self._buf = np.zeros(0, dtype=self._np_dtype)
        self._stream_pos = 0  # stream index of _buf[0]
        self._next_seg = 0
        self._closed = False

    @property
    def stride_duration_s(self) -> float:
        """Seconds of new audio per emitted segment."""
        return self.env.timing.stride_samples / self.env.sample_rate

    @property
    def segment_duration_s(self) -> float:
        """Seconds of audio one segment covers (>= stride when overlapping)."""
        return self.env.timing.segment_samples / self.env.sample_rate

    def _ready(self) -> bool:
        t = self.env.timing
        seg_start = self._next_seg * t.stride_samples
        return self._stream_pos + len(self._buf) >= seg_start + self._post

    def _emit(self, valid_until: Optional[int] = None) -> Tuple[int, SndEnvOutputs]:
        t = self.env.timing
        seg_start = self._next_seg * t.stride_samples
        lo = seg_start - self._pre
        # slice [lo, seg_start + _post); left-pad zeros before stream start
        pad_left = max(0, -lo)
        buf_lo = max(0, lo - self._stream_pos)
        buf_hi = seg_start + self._post - self._stream_pos
        window = np.concatenate(
            [
                np.zeros(pad_left, dtype=self._np_dtype),
                self._buf[buf_lo:buf_hi],
            ]
        )
        assert len(window) == self._span, (len(window), self._span)
        dev = self.env.device
        # a step is valid while its window ends within `valid_until` (stream
        # coordinates) -- matches the offline break-on-overrun semantics
        sig_len = (
            self._span if valid_until is None
            else max(0, min(self._span, valid_until - lo))
        )
        if sig_len == self._span:
            # the steady-state value: cache the device tensor (a fresh one
            # would pay a host->device copy per segment)
            if self._span_len_dev is None:
                self._span_len_dev = torch.tensor([self._span], device=dev)
            sl = self._span_len_dev
        else:
            sl = torch.tensor([sig_len], device=dev)
        # one upload per segment; the [B=1, seg=1] axes are indexed away
        # as views
        res = self.env.forward(
            torch.as_tensor(window, device=dev)[None], sl, add_ms=self._add_ms
        )[0]
        out = SndEnvOutputs(**{
            f.name: (None if getattr(res, f.name) is None
                     else getattr(res, f.name)[0, 0])
            for f in dataclasses.fields(res)
        })
        seg_idx = self._next_seg
        self._next_seg += 1
        # drop history no future segment needs
        keep_from = (self._next_seg * t.stride_samples - self._pre) - self._stream_pos
        if keep_from > 0:
            self._buf = self._buf[keep_from:]
            self._stream_pos += keep_from
        return seg_idx, out

    def feed(self, samples: np.ndarray) -> Iterator[Tuple[int, SndEnvOutputs]]:
        """Append samples (eagerly -- the chunk is buffered even if the
        returned iterator is never consumed); iterating yields
        (segment_index, outputs) for every segment completed by this chunk."""
        if self._closed:
            raise RuntimeError(
                "stream closed by flush(); create a new OnlineSndEnv"
            )
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, dtype=self._np_dtype)]
        )
        return self._drain()

    def _drain(self) -> Iterator[Tuple[int, SndEnvOutputs]]:
        while self._ready():
            yield self._emit()

    def flush(self) -> Iterator[Tuple[int, SndEnvOutputs]]:
        """Zero-pad the tail exactly like SndEnv.Pad (sndenv.go:510-519) and
        emit the remaining segments the offline pipeline would produce on the
        padded signal (steps whose windows overrun the padded end are masked
        to zero, matching the break-on-overrun semantics). Closes the stream
        EAGERLY (at call time, not first iteration -- a dropped iterator
        must still leave the stream closed with its audio end frozen); a
        second flush emits nothing and further feed() raises."""
        if self._closed:
            return iter(())
        self._closed = True
        t = self.env.timing
        stream_end = self._stream_pos + len(self._buf)  # real audio end, fixed
        padded_end = stream_end + pad_len(stream_end, t)
        return self._flush_emit(padded_end)

    def _flush_emit(self, padded_end: int) -> Iterator[Tuple[int, SndEnvOutputs]]:
        t = self.env.timing
        # offline SegCnt on the padded signal (sndenv.go:263-265) -- use the
        # quirk-preserving seg_cnt, NOT `k*stride + SegmentSamples <=
        # padded_end`: Go's truncation-toward-zero yields ONE (fully masked)
        # segment even when the padded signal is shorter than a segment, and
        # the offline pipeline emits it
        while self._next_seg < max(self.env.seg_cnt(padded_end), 0):
            buf_end = self._stream_pos + len(self._buf)
            need = self._next_seg * t.stride_samples + self._post - buf_end
            if need > 0:
                self._buf = np.concatenate(
                    [self._buf, np.zeros(need, dtype=self._np_dtype)]
                )
            yield self._emit(valid_until=padded_end)


class MultiStreamOnline:
    """N concurrent audio streams through ONE [N, span] call per poll -- the
    serving form: per-poll device cost is about one single-stream call, so
    throughput scales about N-fold at single-stream latency.

    Semantics per stream are identical to :class:`OnlineSndEnv` (same
    rolling-buffer math, same offline equivalence, same flush padding).

    Not thread-safe: feed/poll/close mutate shared flat state, so callers
    must serialize access (one poller thread; producers hand chunks to it
    via a queue).

    Usage::

        ms = MultiStreamOnline(cfg, 16000, n_streams=16, device="cuda",
                               outputs=("mel_fbank_segment", "gabor_kwta"))
        ms.feed(3, chunk)                  # buffer audio for stream 3
        for i, seg_idx, out in ms.poll():  # ONE device call for all ready
            serve(i, out["gabor_kwta"])    # host numpy arrays
        ms.close(5)                        # pad + drain stream 5's tail
    """

    def __init__(
        self,
        cfg: SndEnvConfig,
        sample_rate: int,
        n_streams: int,
        dtype: torch.dtype = torch.float32,
        outputs: Optional[Tuple[str, ...]] = None,
        transfer_dtype=None,
        max_buffer_seconds: Optional[float] = 60.0,
        overflow: str = "error",
        profile: bool = False,
        max_segments_per_poll: int = 1,
        pipeline_depth: int = 1,
        mesh=None,
        **env_kw,
    ):
        """``transfer_dtype``: dtype of the per-poll packed host copy.
        None ships the pipeline dtype; ``torch.float16`` (or ``'float16'``)
        halves poll bytes (saturating cast); ``'int8'`` quarters them via
        per-stream, per-channel quantized transfer (lossy, the scheme of the
        corpus :class:`..pipeline.batch.PackedBatch`). The poll copy's bytes
        scale with n_streams.

        Overload policy (producers outrunning ``poll()``):
        ``max_buffer_seconds`` bounds each stream's pending-audio buffer
        (default 60 s; ``None`` = unbounded, buffers grow geometrically).
        When a ``feed()`` would exceed the bound, ``overflow`` decides:

        - ``"error"`` (default): the feed raises :class:`BufferOverflow`
          (backpressure -- the producer must poll or shed load). The buffer
          is left unchanged, so the stream stays consistent.
        - ``"drop_oldest"``: the oldest buffered audio is discarded in
          whole-segment strides and the corresponding segment indices are
          SKIPPED (never emitted; the next emitted ``seg_idx`` jumps).
          ``dropped_segments(stream)`` counts them for monitoring.

        ``max_segments_per_poll`` (K): each poll() drains up to K pending
        segments per stream in ONE device call, which amortizes the fixed
        per-call costs (dispatch, the packed copy) when producers outrun
        real time (overload, batch backfill). K=1 (default) is
        latency-optimal for real-time producers: larger K uploads a
        K-segment window span per poll even when only one segment is
        pending. Outputs equal K=1 polls (same window grid, one segment-axis
        batch).

        ``pipeline_depth`` (D): with D >= 2, poll() keeps up to D-1 device
        calls in flight and returns the OLDEST completed one, so a poll's
        packed copy to the host overlaps the next poll's dispatch and
        compute, at the price of one poll of added result latency (the
        first D-1 polls return []). Per-stream state still advances only at
        harvest: a failed harvest rolls back EVERY in-flight claim (results
        are never skipped; the next poll re-assembles the same segments
        from the ring, whose history is only trimmed at successful
        harvest). D=1 (default) is the synchronous behavior.

        ``mesh``: split the stream axis over this process' devices of a
        mesh (:mod:`..parallel.mesh`; data parallelism over streams, with no
        collectives: the pipeline is pointwise per stream). Each shard's
        block runs on its device's SndEnv copy and the packed buffers join
        on the mesh's first device. ``n_streams`` must divide evenly over
        the mesh.

        ``profile``: poll() appends per-phase wall seconds to
        ``poll_phases`` (gather/h2d/dispatch/compute/d2h/unpack/emit); the
        compute phase synchronizes the device (nothing to wait for on the
        CPU).
        """
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if overflow not in ("error", "drop_oldest"):
            raise ValueError(
                f"overflow must be 'error' or 'drop_oldest', got {overflow!r}"
            )
        if check_mesh(mesh) is not None:
            if mesh.process_count > 1:
                raise ValueError(
                    "MultiStreamOnline serves on this process' devices: "
                    "pass a mesh of local devices (make_mesh(devices=...))"
                )
            if n_streams % mesh.size != 0:
                raise ValueError(
                    f"n_streams ({n_streams}) must be a multiple of the mesh "
                    f"size ({mesh.size}): every poll runs the full "
                    "fixed-shape stream batch"
                )
            env_kw.setdefault("device", mesh.local_devices[0])
        self.n_streams = n_streams
        self.mesh = mesh
        self.transfer_dtype = _as_transfer_dtype(transfer_dtype)
        self._quantize = self.transfer_dtype == torch.int8
        # ONE shared pipeline (filter design etc. built once); per-stream
        # state is just the rolling buffer bookkeeping
        tpl = OnlineSndEnv(cfg, sample_rate, dtype=dtype, outputs=outputs,
                           **env_kw)
        self.env = tpl.env
        self._envs = {self.env.device: self.env}  # one copy per mesh device
        self._pre = tpl._pre
        self._post = tpl._post
        self._span = tpl._span
        self._add_ms = tpl._add_ms
        self._np_dtype = tpl._np_dtype
        self._layout = None  # filled by the first poll program
        self._copy_stream = None
        self.overflow = overflow
        if max_segments_per_poll < 1:
            raise ValueError("max_segments_per_poll must be >= 1")
        self._k = int(max_segments_per_poll)
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._depth = int(pipeline_depth)
        # in-flight device calls (pipeline_depth >= 2): FIFO of dicts
        # {packed, host, done, ready, seg0, k_arr}. _claim_end[i] = ABSOLUTE
        # end of the segment range claimed by in-flight calls for stream i;
        # the effective assembly cursor is max(_next_seg, _claim_end), NOT
        # next_seg + count -- drop_oldest can advance the committed cursor
        # PAST an in-flight claim, after which a relative count would make
        # assembly skip one segment per drop event permanently
        self._inflight: list = []
        self._claim_end = np.zeros(n_streams, np.int64)
        t = self.env.timing
        self._span_poll = (
            self._pre + (self._k - 1) * t.stride_samples + self._post
        )
        # The program emits seg_cnt(span_poll) segments. With overlapping
        # segments (stride < segment span, e.g. stride_ms=50 at the default
        # 100 ms segment) that exceeds K: the span that backs segment K-1
        # also covers the head of later segments. Those trailing segments
        # are computed and DISCARDED (the poll program slices to the first K
        # before packing) -- the poll still advances exactly up-to-K
        # segments.
        self._prog_segs = max(self.env.seg_cnt(self._span_poll), 0)
        if self._prog_segs < self._k:
            raise ValueError(
                f"max_segments_per_poll={self._k}: a {self._span_poll}"
                f"-sample poll span backs only {self._prog_segs} segments "
                "under this geometry (stride vs segment length); lower K "
                "or adjust stride_ms"
            )
        self._bounded = max_buffer_seconds is not None
        if self._bounded:
            cap = max(
                self._span_poll, int(round(max_buffer_seconds * sample_rate))
            )
        else:
            cap = 2 * self._span_poll  # grown geometrically on demand
        self._cap = cap
        # ALL per-stream state lives in flat arrays so poll() assembles every
        # window in one vectorized gather (no per-stream Python concat on
        # the hot path). The ring invariant: the sample at stream coordinate
        # p (samples since stream start) lives at _bufs[i, p % _cap]; valid
        # coords are [_start[i], _end[i]) with _end - _start <= _cap.
        self._bufs = np.zeros((n_streams, cap), self._np_dtype)
        self._start = np.zeros(n_streams, np.int64)
        self._end = np.zeros(n_streams, np.int64)
        self._next_seg = np.zeros(n_streams, np.int64)
        self._closed = np.zeros(n_streams, bool)
        self._padded_end = np.zeros(n_streams, np.int64)
        # segments the offline padded run would produce; set at close()
        self._total_segs = np.zeros(n_streams, np.int64)
        self._dropped = np.zeros(n_streams, np.int64)
        self.poll_phases: Optional[dict] = (
            {k: [] for k in PHASES} if profile else None
        )

    @property
    def _inflight_segs(self) -> np.ndarray:
        """Per-stream count of segments claimed by in-flight calls but not
        yet committed ([N] int64, diagnostic)."""
        return np.maximum(self._claim_end - self._next_seg, 0)

    def pending_samples(self, stream: int) -> int:
        """Samples currently buffered for one stream."""
        return int(self._end[stream] - self._start[stream])

    def dropped_segments(self, stream: int) -> int:
        """Segments skipped by the ``drop_oldest`` overflow policy."""
        return int(self._dropped[stream])

    def _ring_write(self, i: int, coord: int, data: np.ndarray) -> None:
        # write data at stream coords [coord, coord+len); len <= _cap, so
        # the (at most two) destination slices never self-overlap
        j = int(coord % self._cap)
        k = min(len(data), self._cap - j)
        self._bufs[i, j : j + k] = data[:k]
        if len(data) > k:
            self._bufs[i, : len(data) - k] = data[k:]

    def _grow(self, need_fill: int) -> None:
        """Unbounded mode: enlarge the ring so `need_fill` samples fit.
        The modulus changes, so every stream's live span is re-laid-out."""
        new_cap = self._cap
        while new_cap < need_fill:
            new_cap *= 2
        old, old_cap = self._bufs, self._cap
        self._bufs = np.zeros((self.n_streams, new_cap), self._np_dtype)
        self._cap = new_cap
        for i in range(self.n_streams):
            s, e = int(self._start[i]), int(self._end[i])
            if e <= s:
                continue
            j = s % old_cap
            k = min(e - s, old_cap - j)
            span = np.concatenate([old[i, j : j + k], old[i, : (e - s) - k]])
            self._ring_write(i, s, span)

    def _drop_oldest(self, i: int, new_end: int) -> None:
        """Advance stream i's cursor past whole segments so that fill
        (= new_end - start) fits in _cap. History is only ever trimmed to a
        future segment's left edge (k*stride - pre), so the retained span is
        exactly what the next emitted segment needs."""
        t = self.env.timing
        new_start_min = new_end - self._cap
        k = -(-(new_start_min + self._pre) // t.stride_samples)  # ceil div
        # floor at the EFFECTIVE cursor: segments claimed by in-flight
        # pipelined polls were already copied out of the ring at dispatch
        # and WILL be emitted, so they are neither droppable nor dropped
        ce = max(int(self._next_seg[i]), int(self._claim_end[i]))
        k = max(k, ce)
        self._dropped[i] += k - ce
        self._next_seg[i] = k
        self._start[i] = max(
            int(self._start[i]), k * t.stride_samples - self._pre
        )

    def feed(self, stream: int, samples: np.ndarray) -> None:
        """Buffer samples for one stream (no device work until poll).

        May raise :class:`BufferOverflow` under the ``"error"`` overflow
        policy -- see the constructor docstring."""
        if self._closed[stream]:
            raise RuntimeError(f"stream {stream} is closed")
        data = np.asarray(samples, dtype=self._np_dtype).ravel()
        if len(data) == 0:
            return
        end = int(self._end[stream])
        new_end = end + len(data)
        fill = new_end - int(self._start[stream])
        if fill > self._cap:
            if not self._bounded:
                self._grow(fill)
            elif self.overflow == "error":
                raise BufferOverflow(
                    f"stream {stream}: feeding {len(data)} samples would "
                    f"leave {fill} pending > capacity {self._cap} "
                    f"({self._cap / self.env.sample_rate:.1f} s). poll() "
                    "more often, raise max_buffer_seconds, or use "
                    "overflow='drop_oldest'"
                )
            else:
                self._drop_oldest(stream, new_end)
        if len(data) > self._cap:
            # a single chunk larger than the ring: only its tail survives
            data = data[-self._cap :]
        self._ring_write(stream, new_end - len(data), data)
        self._end[stream] = new_end

    def close(self, stream: int) -> None:
        """End-of-stream: apply the SndEnv.Pad tail padding; subsequent
        polls drain the remaining segments (then the stream goes idle)."""
        if self._closed[stream]:
            return
        self._closed[stream] = True
        t = self.env.timing
        stream_end = int(self._end[stream])
        padded_end = stream_end + pad_len(stream_end, t)
        self._padded_end[stream] = padded_end
        # seg_cnt's Go truncation-toward-zero quirk yields one (fully
        # masked) segment even for streams shorter than a segment
        self._total_segs[stream] = max(self.env.seg_cnt(padded_end), 0)

    def _ready_streams(self) -> np.ndarray:
        # readiness is judged at the EFFECTIVE cursor (committed +
        # in-flight claims) so pipelined polls never re-assemble segments
        # an un-harvested device call already covers
        t = self.env.timing
        eff = np.maximum(self._next_seg, self._claim_end)
        ready = np.where(
            self._closed,
            eff < self._total_segs,
            self._end >= eff * t.stride_samples + self._post,
        )
        return np.nonzero(ready)[0]

    def _shards(self):
        """(device, SndEnv copy, row slice) per shard of the stream axis:
        one shard on the env's device without a mesh."""
        if self.mesh is None:
            return [(self.env.device, self.env, slice(0, self.n_streams))]
        out = []
        for dev, sl in zip(self.mesh.local_devices,
                           batch_sharding(self.mesh, self.n_streams)):
            if dev not in self._envs:
                self._envs[dev] = copy.deepcopy(self.env).to(dev)
            out.append((dev, self._envs[dev], sl))
        return out

    def _poll_program(self, blocks) -> torch.Tensor:
        """The packed poll buffer [N, C] of every (env, windows, sig_lens)
        shard block (:meth:`_pack_poll`), joined on the env's device."""
        packed = [self._pack_poll(*blk) for blk in blocks]
        if len(packed) == 1:
            return packed[0]
        return torch.cat([p.to(self.env.device) for p in packed])

    def _pack_poll(self, env: SndEnv, windows: torch.Tensor,
                   sig_lens: torch.Tensor) -> torch.Tensor:
        """``env.forward`` on [n, span_poll] windows and [n] lengths, with
        every output leaf's first K segments packed into ONE [n, C] tensor
        (per-leaf host copies would each pay the copy's fixed cost per
        poll). The layout (key -> trailing shape incl. the K seg axis, column
        range, n_chan, chan_ax relative to the post-seg dims) is filled on
        the first call."""
        res = env.forward(windows, sig_lens, add_ms=self._add_ms)[0]
        quantize = self._quantize
        pack_dtype = (
            self.transfer_dtype
            if self.transfer_dtype is not None and not quantize
            else self.env.dtype
        )
        n = windows.shape[0]
        layout, cols, off, qscales = {}, [], 0, []
        for fld in dataclasses.fields(res):
            f, x = fld.name, getattr(res, fld.name)
            if x is None:
                continue
            assert x.shape[1] == self._prog_segs, (f, x.shape, self._prog_segs)
            if self._prog_segs > self._k:
                # overlapping-segment geometry: emit the first K only
                x = x[:, : self._k]
            n_chan, chan_ax = 0, None
            if quantize and x.is_floating_point():
                chan_ax = _quant_chan_axis(f, tuple(x.shape[2:]), None)
                n_chan = 1 if chan_ax is None else x.shape[2 + chan_ax]
                # per_row: every stream gets its own scales, so one stream's
                # precision never depends on co-polled tenants (the K seg
                # axis shares its stream's scales)
                q, sc, ofv = _quantize_int8(
                    x, chan_ax, symmetric=False, per_row=True
                )
                qscales += [sc, ofv]  # each [N, n_chan]
                flat = q.reshape(n, -1)
            elif quantize:
                # bool/int leaves (step_valid) ship as raw int8
                flat = x.reshape(n, -1).to(torch.int8)
            else:
                # _saturate_cast: f32->f16 saturates at 65504 instead of
                # overflowing to +-inf (unnormalized DFT power exceeds the
                # f16 range on full-scale input)
                flat = _saturate_cast(x.reshape(n, -1), pack_dtype)
            layout[f] = (
                tuple(x.shape[1:]), off, off + flat.shape[-1], n_chan, chan_ax,
            )
            cols.append(flat)
            off += flat.shape[-1]
        if quantize:
            # per-row trailer: each stream's float32 scales as raw bytes in
            # its own row (little-endian, read back with .view(np.float32))
            svec = torch.cat(qscales, dim=1)  # [N, n_floats]
            sbytes = svec.contiguous().view(torch.int8)  # [N, 4 n_floats]
            layout["__qmeta__"] = (
                (int(sbytes.shape[1]),), off, off + int(sbytes.shape[1]),
                0, None,
            )
            cols.append(sbytes)
        if self._layout is None:
            self._layout = layout
        return torch.cat(cols, dim=-1)

    def _host_zeros(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A zeroed host tensor to assemble an upload in: pinned for a CUDA
        env, so the copy to the card is asynchronous."""
        return torch.zeros(
            shape, dtype=dtype, pin_memory=self.env.device.type == "cuda"
        )

    def _start_copy(self, packed: torch.Tensor):
        """Enqueue the packed buffer's copy into pinned host memory on a
        copy stream that waits for the work producing it. Returns (host
        tensor, completion event); on the CPU (packed, None)."""
        dev = packed.device
        if dev.type != "cuda":
            return packed, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=dev)
        computed = torch.cuda.Event()
        computed.record(torch.cuda.current_stream(dev))
        self._copy_stream.wait_event(computed)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        with torch.cuda.stream(self._copy_stream):
            host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._copy_stream)
        return host, done

    def poll(self):
        """Run ONE batched device call covering every stream with a
        complete segment pending; returns a list of
        (stream, seg_idx, {key: np.ndarray}) with host arrays.

        Per-stream state advances only AFTER the call's results reach the
        host, so a failed call loses nothing: the next poll retries the same
        segments.

        With ``pipeline_depth`` D >= 2 the call instead dispatches the
        current ready segments, keeps up to D-1 calls in flight, and
        returns the OLDEST completed call's results -- the first D-1 polls
        return [] while the pipeline fills, and a failure rolls back every
        in-flight claim (nothing is skipped)."""
        prof = self.poll_phases
        if prof is not None:
            t0 = time.perf_counter()

            def _mark(phase):
                nonlocal t0
                now = time.perf_counter()
                prof[phase].append(now - t0)
                t0 = now
        else:
            _mark = lambda phase: None

        entry = self._assemble_and_dispatch(_mark)
        if self._depth == 1:
            return self._harvest(entry, _mark) if entry is not None else []
        if entry is not None:
            self._inflight.append(entry)
        if self._inflight and (
            entry is None or len(self._inflight) >= self._depth
        ):
            return self._harvest(self._inflight.pop(0), _mark)
        return []

    def _assemble_and_dispatch(self, _mark):
        """Gather every ready stream's window span from the ring, upload,
        and enqueue the poll program (no wait for the device). Returns None
        when no stream is ready, else the in-flight entry. The drained
        segments are CLAIMED (``_inflight_segs``) so the next assemble
        starts past them, but the committed cursor only advances at
        :meth:`_harvest`."""
        ready = self._ready_streams()
        if len(ready) == 0:
            return None
        t = self.env.timing
        eff_next = np.maximum(self._next_seg, self._claim_end)[ready]
        # segments drained this call: up to K per ready stream (open
        # streams: how many whole segments the buffered audio backs;
        # closed: the remaining padded total)
        open_pending = (
            self._end[ready] - eff_next * t.stride_samples - self._post
        ) // t.stride_samples + 1
        k_arr = np.where(
            self._closed[ready],
            self._total_segs[ready] - eff_next,
            open_pending,
        )
        k_arr = np.clip(k_arr, 1, self._k).astype(np.int64)
        # ONE vectorized gather assembles every ready window from the shared
        # ring, straight into the (pinned) upload buffer. Coords outside
        # [0, end) read as zero: negative = pre-stream left pad; >= end =
        # the flush zero tail of closed streams (step validity is masked by
        # sig_lens) or not-yet-fed audio of trailing segments beyond k_arr
        # (computed then discarded -- only the first k_arr are emitted).
        lo = eff_next * t.stride_samples - self._pre
        coords = lo[:, None] + np.arange(self._span_poll, dtype=np.int64)
        vals = self._bufs[
            ready[:, None], (coords % self._cap).astype(np.intp)
        ]
        valid = (coords >= 0) & (coords < self._end[ready][:, None])
        win_host = self._host_zeros(
            (self.n_streams, self._span_poll), self.env.dtype
        )
        win_host.numpy()[ready] = np.where(valid, vals, 0)
        len_host = self._host_zeros(self.n_streams, torch.int32)
        len_host.numpy()[ready] = np.where(
            self._closed[ready],
            np.clip(self._padded_end[ready] - lo, 0, self._span_poll),
            self._span_poll,
        ).astype(np.int32)
        _mark("gather")
        blocks = [
            (env, win_host[sl].to(dev, non_blocking=True),
             len_host[sl].to(dev, non_blocking=True))
            for dev, env, sl in self._shards()
        ]
        _mark("h2d")
        packed = self._poll_program(blocks)
        entry = {"packed": packed, "ready": ready, "seg0": eff_next,
                 "k_arr": k_arr}
        if self._depth > 1:
            # the copy runs as soon as the device reaches it, while the
            # host goes on to the next poll; the entry keeps `packed`
            # referenced until harvest, so the caching allocator cannot
            # hand its memory to later work before the copy has read it
            entry["host"], entry["done"] = self._start_copy(packed)
        _mark("dispatch")
        self._claim_end[ready] = eff_next + k_arr
        return entry

    def _rollback(self) -> None:
        # failed call: un-claim the failed entry AND everything behind it in
        # the pipeline (later in-flight calls were assembled assuming this
        # one's segments were drained, so partial rollback would emit out of
        # order); the next poll re-assembles everything from the ring, whose
        # history is only trimmed at successful harvest
        self._inflight.clear()
        self._claim_end = self._next_seg.copy()

    def _harvest(self, entry, _mark):
        """Wait for one dispatched call, unpack its packed buffer, COMMIT
        the cursor advance, and return its results."""
        prof = self.poll_phases
        t = self.env.timing
        ready, seg0, k_arr = entry["ready"], entry["seg0"], entry["k_arr"]
        try:
            if prof is not None:
                if self.env.device.type == "cuda":
                    torch.cuda.synchronize(self.env.device)
                _mark("compute")
            if "host" not in entry:
                entry["host"], entry["done"] = self._start_copy(entry["packed"])
            if entry["done"] is not None:
                entry["done"].synchronize()
            # ONE host copy for the whole batch, split per key host-side
            buf = entry["host"].numpy()
        except BaseException:
            self._rollback()
            raise
        _mark("d2h")
        qscales = None
        if self._quantize and "__qmeta__" in self._layout:
            _, qlo, qhi, _, _ = self._layout["__qmeta__"]
            # [N, n_floats]; per key: scale[N, n], off[N, n]
            qscales = np.ascontiguousarray(buf[:, qlo:qhi]).view(np.float32)
        host, qoff = {}, 0
        for f, (shape, lo, hi, n_chan, chan_ax) in self._layout.items():
            if f == "__qmeta__":
                continue
            v = buf[:, lo:hi].reshape((buf.shape[0],) + shape)
            if qscales is not None and n_chan:
                sc = qscales[:, qoff : qoff + n_chan]
                ofv = qscales[:, qoff + n_chan : qoff + 2 * n_chan]
                qoff += 2 * n_chan
                # v is [N, K, *view]; chan_ax indexes into *view
                bshape = [v.shape[0]] + [1] * (v.ndim - 1)
                if chan_ax is not None:
                    bshape[2 + chan_ax] = n_chan
                sc = sc.reshape(bshape)
                ofv = ofv.reshape(bshape)
                x = v.astype(np.float32) * sc + ofv
                v = np.where(v == -128, np.float32(np.nan), x)
            host[f] = v
        if "step_valid" in host:
            host["step_valid"] = host["step_valid"] > 0.5
        _mark("unpack")
        # the call succeeded: NOW advance stream cursors and trim history.
        # Per-stream leaves are COPIES, not views: a view of buf[i] would
        # pin the entire [N, C] poll buffer (all streams x all keys) alive
        # for as long as a consumer retains any single output.
        results = [
            (
                int(i),
                int(s0) + j,
                {k: v[i, j].copy() for k, v in host.items()},
            )
            for i, s0, ki in zip(ready, seg0, k_arr)
            for j in range(int(ki))
        ]
        # drop_oldest may have advanced the committed cursor past this
        # call's claim while it was in flight -- never move it backwards
        self._next_seg[ready] = np.maximum(
            self._next_seg[ready], seg0 + k_arr
        )
        new_lo = self._next_seg[ready] * t.stride_samples - self._pre
        self._start[ready] = np.minimum(
            np.maximum(self._start[ready], np.maximum(new_lo, 0)),
            self._end[ready],
        )
        _mark("emit")
        return results

    def flush_pipeline(self):
        """Harvest every in-flight pipelined call WITHOUT dispatching new
        work, oldest-first; returns their combined results ([] when
        nothing is in flight, always at ``pipeline_depth=1``). Use to
        quiesce the pipeline without draining buffered backlog."""
        results = []
        while self._inflight:
            results.extend(
                self._harvest(self._inflight.pop(0), lambda phase: None)
            )
        return results

    def drain(self):
        """Poll until no stream has pending segments (e.g. after close).
        With ``pipeline_depth`` >= 2 this also flushes the in-flight
        pipeline (a poll may return [] while calls are still in flight)."""
        while True:
            got = self.poll()
            if not got and not self._inflight:
                return
            yield from got
