"""Fused frame extraction + DFT power + log + mel filterbank on the uniform
window grid ``start_i = step*i + offset0``: the Hopper port of the Pallas
kernel ``auditory_tpu/ops/framefft.py::fused_frame_power_mel``.

The kernel is CUDA C++ (``csrc/framefft.cu``), built for ``sm_90a`` at first
use and bound with ctypes (:mod:`._build`). One kernel replaces the Pallas
grouped, masked and merged modes: those exist because Mosaic only loads at
128-aligned offsets and budgets VMEM, while Hopper loads at any offset. It
runs the DFT contraction on the tensor cores (``wgmma``, bf16 limbs, FP32
accumulation) at JAX's three grades, ``passes`` = 6 (three limbs, six
products: the exact float32 grade), 3 (two limbs, ~2^-16 relative) or 1
(bf16-rounded operands). A prologue launch packs the basis limbs from the
live tensors on every call and builds the mel bank's band table
(:func:`prologue_on_card`; the plain versions are :func:`pack_basis_limbs`
and :func:`band_table`). The mel sum is FP32 on the CUDA cores at every
grade, each filter summed only over its band (:func:`mel_bands`): bit for
bit the dense sum over every bin in ascending order.

Semantics (dft/dft.go:62-85, mel/mel.go:120-153), per window of each row:
- zero fill left of sample 0 and past the buffer's end (the caller masks
  steps that overrun the true length, as the JAX pipeline does);
- power[k] = re^2 + im^2 of the unnormalized DFT, bins 0..N/2;
- log power = ln(power + LogOffSet) with the exact ==0 -> LogMin floor;
- mel = ln(sum_k W[k,f] power[k] + LogOff), ==0 -> LogMin; NaN weights
  propagate. The renorm clamp, if on, is the caller's (as in JAX).

The plain version emulates the 3- and 1-pass grades in float32 (the same
limb split and products, each an FP32 matmul of bf16 values, which is exact
per product); at the exact grade, and in float64 whatever ``passes``, it is
the plain matmul.

:func:`fused_frame_power_mel` is differentiable: it applies
:class:`FusedFramePowerMel`, whose forward launches the kernel for a CUDA
tensor and runs :func:`fused_frame_power_mel_reference`, the plain PyTorch
version, for a CPU tensor, and whose backward is the chain rule in plain
tensor ops (:func:`fused_frame_power_mel_backward`; the JAX package has no
backward kernel either: ``jax.grad`` differentiates its XLA frontend).
:data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..config import DFTParams, FilterBank
from ..dsp.dft import floored_log, power_spectrum
from ..dsp.frame import extract_windows

__all__ = [
    "BINS_PER_PASS", "K_CHUNK", "LAUNCHES", "FusedFramePowerMel", "Layout",
    "band_table", "fused_frame_power_mel", "fused_frame_power_mel_backward",
    "fused_frame_power_mel_reference", "launch_shape", "limb_terms",
    "mel_bands", "n_limbs", "overlap_add", "pack_basis_limbs", "pad_basis",
    "layouts", "plan_layout", "prologue_on_card", "shared_bytes", "sm_count",
    "split_limbs", "table_words", "tf32_flags",
]

# kernel launches since import (or since a caller reset it to 0), and the
# same launches by block layout (``Layout.kind``)
LAUNCHES = 0
LAUNCHES_BY_LAYOUT: Dict[str, int] = {}

_MAX_SHARED_BYTES = 232448  # per block on sm_90, opted in above 48 KB
_INT32_MAX = 2**31 - 1
# the kernel's tiles (csrc/framefft.cu): bins per N pass (7 groups of 8 bins,
# each a group of cos rows and one of sin rows) and k per TMA tile
BINS_PER_PASS = 56
K_CHUNK = 64
# the mel epilogue (csrc/framefft.cu): carry slots a window, band-table
# entries (a header first) and weights the consumers stage a pass, an
# entry's flags, the cost of an entry beside its weights where a pass's
# entries are split between a window's two threads, and the most filters
# the prologue's band table takes
CARRY_SLOTS = 4
STAGED_ENTRIES = 256
STAGED_WEIGHTS = 512
_OPENS, _CLOSES = 1 << 16, 1 << 17
_ENTRY_COST = 4
_MAX_MEL = 16384


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_basis(
    cos_m: np.ndarray, sin_m: np.ndarray, mel_w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad DFT basis columns (bins) and mel rows/cols to multiples of 128.

    mel_w comes in as [n_mel, n_bins] (design layout) and is returned
    transposed-padded as [k_pad, m_pad] with zero rows for the padding bins,
    so padded power bins contribute exactly 0 to every mel sum. The dtype
    of the inputs is kept (the JAX version returns float32)."""
    n_bins = cos_m.shape[1]
    n_mel = mel_w.shape[0]
    k_pad = _round_up(n_bins, 128)
    m_pad = _round_up(n_mel, 128)
    cos_p = np.zeros((cos_m.shape[0], k_pad), dtype=cos_m.dtype)
    sin_p = np.zeros((sin_m.shape[0], k_pad), dtype=sin_m.dtype)
    cos_p[:, :n_bins] = cos_m
    sin_p[:, :n_bins] = sin_m
    w_p = np.zeros((k_pad, m_pad), dtype=mel_w.dtype)
    w_p[:n_bins, :n_mel] = mel_w.T
    return cos_p, sin_p, w_p


def n_limbs(passes: int) -> int:
    """bf16 limbs per float32 operand for a pass count (JAX's ``_n_limbs``):
    1 -> 1 (native single product), 3 -> 2 (hi/lo, no lo*lo), 6 -> 3 (the
    six products b_i * c_j with i + j <= 2: exact float32)."""
    if passes == 1:
        return 1
    if passes == 3:
        return 2
    if passes == 6:
        return 3
    raise ValueError(f"passes must be 1, 3 or 6, got {passes}")


def split_limbs(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, ...]:
    """float32 -> ``n`` bf16 limbs, each the round-to-nearest bf16 of what
    the previous ones left (every residual subtraction is exact in float32):
    three limbs sum back to ``x`` exactly."""
    limbs = []
    r = x
    for _ in range(n):
        h = r.to(torch.bfloat16)
        limbs.append(h)
        r = r - h.float()
    return tuple(limbs)


def limb_terms(n: int) -> Tuple[Tuple[int, int], ...]:
    """The (x limb, basis limb) products with i + j < n in JAX's
    ``_limb_dot`` order: smallest terms first."""
    terms = [(i + j, i, j) for i in range(n) for j in range(n) if i + j < n]
    return tuple((i, j) for _, i, j in sorted(terms, reverse=True))


def pack_basis_limbs(cos_basis: torch.Tensor, sin_basis: torch.Tensor,
                     n_bins: int, passes: int) -> torch.Tensor:
    """The kernel's B operand from the live basis tensors: bf16
    [limbs, n_pass, 112, k_pad] flattened to [limbs * n_pass * 112, k_pad],
    K-major (k contiguous). Pass p holds bins p*56 .. p*56 + 55 as 7 groups
    of (8 cos rows, 8 sin rows), so a bin's re and im land in one thread's
    registers; bins at or past ``n_bins`` and k at or past ``win`` are zero
    rows and columns, ``k_pad`` is ``win`` rounded up to 64."""
    win = cos_basis.shape[0]
    n_pass = -(-n_bins // BINS_PER_PASS)
    k_pad = _round_up(win, K_CHUNK)

    def part(b):
        t = b.new_zeros((n_pass * BINS_PER_PASS, k_pad), dtype=torch.float32)
        t[:n_bins, :win] = b[:, :n_bins].T
        return t.reshape(n_pass, BINS_PER_PASS // 8, 1, 8, k_pad)

    bt = torch.cat([part(cos_basis), part(sin_basis)], dim=2)
    bt = bt.reshape(n_pass * 2 * BINS_PER_PASS, k_pad)
    return torch.stack(split_limbs(bt, n_limbs(passes))).reshape(-1, k_pad)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/framefft.cu`` at first use."""
    from . import _build

    lib = _build.load("framefft")
    lib.framefft_shared_bytes.argtypes = [ctypes.c_int] * 7
    lib.framefft_shared_bytes.restype = ctypes.c_int
    lib.framefft_table_words.argtypes = [ctypes.c_int] * 2
    lib.framefft_table_words.restype = ctypes.c_longlong
    lib.framefft_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_float] * 4
        + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.framefft_launch.restype = ctypes.c_int
    lib.framefft_prologue_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    )
    lib.framefft_prologue_launch.restype = ctypes.c_int
    sizes = (lib.framefft_bins_per_pass(), lib.framefft_k_chunk(),
             lib.framefft_carry_slots(), lib.framefft_staged_entries(),
             lib.framefft_staged_weights())
    if sizes != (BINS_PER_PASS, K_CHUNK, CARRY_SLOTS, STAGED_ENTRIES,
                 STAGED_WEIGHTS):
        raise RuntimeError("csrc/framefft.cu and ops/framefft.py disagree "
                           "on the kernel's tile and table sizes")
    return lib


def _check(signals, step, offset0, n_windows, cos_b, sin_b, mel_w, n_bins,
           n_mel, dft):
    if dft.prev_smooth != 0.0:
        raise ValueError("fused_frame_power_mel requires prev_smooth == 0")
    if signals.ndim != 2:
        raise ValueError(f"signals must be [B, S], got {tuple(signals.shape)}")
    win, k_pad = cos_b.shape
    if sin_b.shape != cos_b.shape:
        raise ValueError(
            f"cos/sin basis shapes differ: {tuple(cos_b.shape)} vs "
            f"{tuple(sin_b.shape)}"
        )
    if not 0 < n_bins <= k_pad or mel_w.shape[0] != k_pad:
        raise ValueError(
            f"basis [win, k_pad]={tuple(cos_b.shape)}, mel weights "
            f"{tuple(mel_w.shape)} and n_bins={n_bins} disagree"
        )
    if not 0 < n_mel <= mel_w.shape[1]:
        raise ValueError(
            f"n_mel={n_mel} does not fit mel weights {tuple(mel_w.shape)}"
        )
    if step <= 0 or n_windows <= 0:
        raise ValueError(f"step={step}, n_windows={n_windows} must be > 0")
    last_end = offset0 + (n_windows - 1) * step + win
    if abs(offset0) > _INT32_MAX or last_end > _INT32_MAX:
        raise ValueError(
            f"window grid reaches sample {last_end}: beyond int32 indexing"
        )
    dtypes = {t.dtype for t in (signals, cos_b, sin_b, mel_w)}
    devices = {t.device for t in (signals, cos_b, sin_b, mel_w)}
    if len(dtypes) != 1 or len(devices) != 1:
        raise ValueError(
            f"inputs must share one dtype and device, got {dtypes}, {devices}"
        )
    return win, k_pad


def fused_frame_power_mel(
    signals: torch.Tensor,   # [B, S]
    step_samples: int,
    offset0: int,            # start of window 0 (may be negative)
    n_windows: int,
    cos_basis: torch.Tensor,  # [win, k_pad]
    sin_basis: torch.Tensor,  # [win, k_pad]
    mel_weights: torch.Tensor,  # [k_pad, m_pad]
    *,
    n_bins: int,
    n_mel: int,
    dft: DFTParams,
    fbank: FilterBank,
    emit: Tuple[bool, bool] = (True, True),
    passes: int = 6,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
    """Fused frontend on the uniform grid start_i = step*i + offset0.

    Returns (power, log_power, log_mel): [B, n_windows, n_bins] x2 and
    [B, n_windows, n_mel]. ``emit`` = (power, log_power) gates the two wide
    outputs; a gated-off output is returned as None and never written.
    ``passes`` (1, 3 or 6) is the DFT contraction's grade, as JAX's kernel
    takes it: 6 is exact float32, 3 ~2^-16 relative, 1 bf16-rounded
    operands.

    A CUDA tensor launches the kernel (float32, contiguous; anything else
    raises), also when a gradient is wanted. A CPU tensor runs
    :func:`fused_frame_power_mel_reference`. Gradients flow to the signals
    and to the three constants through :class:`FusedFramePowerMel`; the
    backward is that of the exact float32 function at every grade."""
    n_limbs(passes)
    _check(signals, step_samples, offset0, n_windows, cos_basis, sin_basis,
           mel_weights, n_bins, n_mel, dft)
    geom = (int(step_samples), int(offset0), int(n_windows), int(n_bins),
            int(n_mel), dft, fbank, (bool(emit[0]), bool(emit[1])),
            int(passes))
    return FusedFramePowerMel.apply(
        signals, cos_basis, sin_basis, mel_weights, geom
    )


@contextlib.contextmanager
def tf32_flags(flags: Tuple[bool, bool]):
    """Set (cuBLAS, cuDNN) allow_tf32 inside the block, then restore."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class FusedFramePowerMel(torch.autograd.Function):
    """The fused frontend as an autograd node.

    Forward: the CUDA kernel for a CUDA tensor (never the plain version, a
    gradient wanted or not), the plain version for a CPU tensor. Backward:
    :func:`fused_frame_power_mel_backward`, run under the TF32 flags the
    forward ran under, so a forward inside the 'highest' tier has an IEEE
    float32 backward wherever ``backward()`` is called from. Only the
    signals and the three constants take gradients; a gated-off output
    (None) takes none."""

    @staticmethod
    def forward(ctx, signals, cos_basis, sin_basis, mel_weights, geom):
        step, offset0, n_windows, n_bins, n_mel, dft, fbank, emit, passes = geom
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(signals, cos_basis, sin_basis, mel_weights)
        ctx.geom = geom
        ctx.tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        args = (signals, step, offset0, n_windows, cos_basis, sin_basis,
                mel_weights)
        kw = dict(n_bins=n_bins, n_mel=n_mel, dft=dft, fbank=fbank, emit=emit,
                  passes=passes)
        if signals.device.type == "cpu":
            return fused_frame_power_mel_reference(*args, **kw)
        return _launch(*args, **kw)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_power, g_logp, g_mel):
        signals, cos_b, sin_b, mel_w = ctx.saved_tensors
        step, offset0, n_windows, n_bins, n_mel, dft, fbank, _, _ = ctx.geom
        with tf32_flags(ctx.tf32):
            grads = fused_frame_power_mel_backward(
                signals, step, offset0, n_windows, cos_b, sin_b, mel_w,
                g_power, g_logp, g_mel, n_bins=n_bins, n_mel=n_mel, dft=dft,
                fbank=fbank, needs=ctx.needs_input_grad[:4],
            )
        return grads + (None,)


class Layout(NamedTuple):
    """A block layout of the kernel: consumer warpgroups (64 windows each),
    basis ring stages, the signal span staged whole (``piece`` 0) or
    ``piece`` samples of each window at a time through a ring of ``pbufs``
    buffers, and the block's dynamic shared memory in bytes (the mel
    epilogue's share is the same at every mel bank)."""

    consumers: int
    ring: int
    piece: int
    pbufs: int
    bytes: int

    @property
    def kind(self) -> str:
        """Its instantiation of the kernel: the span whole or in pieces."""
        return "pieces" if self.piece else "whole span"


# csrc/framefft.cu's layout constants: basis ring stages (at most 6; the
# picker takes no fewer than 4), piece buffers, bytes of one basis stage,
# power row stride
_MAX_RING, _MIN_RING = 6, 4
_MIN_PBUF, _MAX_PBUF = 3, 4
_STAGE_BYTES = 2 * BINS_PER_PASS * K_CHUNK * 2
_PLD = BINS_PER_PASS + 1
# shared memory of one SM (228 KB; a block holds 1 KB more than it asks)
_SM_SHARED_BYTES = 233472
# a block of two warpgroups in pieces takes ~1.6x the time of one
# warpgroup's block, for twice the windows (framefft_phases.py on the
# H100, B=512 x 3 s: 1.60-1.66 at 32-96 kHz)
_PAIR_BLOCK_COST = 1.6


def _skew_pad(step: int) -> int:
    return 0 if step < 16 else (8 - step) % 32


def _span_cap(step: int, win: int, n_windows: int, consumers: int) -> int:
    m = 64 * consumers
    nseg = min(m, 2 + (m - 2) // n_windows)
    cap = m * step + nseg * max(win - step, 0)
    skewed = cap + _skew_pad(step) * (cap // step + nseg + 1)
    return _round_up(skewed, 4)


def shared_bytes(step: int, win: int, n_windows: int, consumers: int,
                 ring: int, piece: int, pbufs: int) -> int:
    """Dynamic shared memory of one block of this layout (the library's
    ``framefft_shared_bytes``): the basis ring, the staged signal, the
    power tiles, and the mel epilogue's carry slots, non-finite flags and
    staged band table, whose size does not depend on the mel bank."""
    m = 64 * consumers
    # in pieces the power tiles overlay a piece buffer
    staged = (m * (pbufs * (piece + 8) + 2) if piece
              else _span_cap(step, win, n_windows, consumers) + m * _PLD)
    return (1024 + ring * _STAGE_BYTES
            + 4 * (staged + m * (2 * CARRY_SLOTS + 1) + 4 * STAGED_ENTRIES
                   + STAGED_WEIGHTS)
            + 2 * (_MAX_RING + (_MAX_PBUF if piece else 0)) * 8)


def _preference(lay: Layout) -> tuple:
    span_ring = ((bool(lay.piece), -lay.ring) if lay.consumers == 2
                 else (-lay.ring, bool(lay.piece)))
    return (-lay.consumers, *span_ring, -lay.pbufs, -lay.piece)


def layouts(step: int, win: int, n_windows: int) -> List[Layout]:
    """Every layout that fits a block's shared memory at this geometry,
    best first for a large batch: two warpgroups before one. With two,
    the whole span staged once before the span in pieces, then the
    deepest basis ring (4-6 stages); with one, the deepest ring before the
    whole span (no second warpgroup hides the waits on a shallow ring). In
    pieces, then the piece ring (3-4 buffers), then the piece's length. On
    the H100 (framefft_phases.py, B=512 x 3 s): two warpgroups on pieces
    beat one warpgroup by 1.13-1.37x at 16-48 kHz; with two, the whole
    span is ~10% ahead of pieces; with one, pieces with 6 stages beat the
    whole span with 4-5 by 10-19%."""
    k_pad = _round_up(win, K_CHUNK)
    fits = []
    for consumers in (2, 1):
        for ring in range(_MAX_RING, _MIN_RING - 1, -1):
            shapes = [(0, 0)] + [(piece, pbufs)
                                 for pbufs in range(_MAX_PBUF, _MIN_PBUF - 1, -1)
                                 for piece in range(k_pad, K_CHUNK - 1, -K_CHUNK)]
            for piece, pbufs in shapes:
                nbytes = shared_bytes(step, win, n_windows, consumers, ring,
                                      piece, pbufs)
                if nbytes <= _MAX_SHARED_BYTES:
                    fits.append(Layout(consumers, ring, piece, pbufs, nbytes))
    return sorted(fits, key=_preference)


def _waves(lay: Layout, windows: int, sms: int) -> int:
    """Waves of ``lay``'s blocks over ``windows`` windows on ``sms`` SMs."""
    blocks = -(-windows // (64 * lay.consumers))
    per_sm = max(1, _SM_SHARED_BYTES // (lay.bytes + 1024))
    return -(-blocks // (sms * per_sm))


def plan_layout(step: int, win: int, n_windows: int,
                rows: Optional[int] = None, sms: Optional[int] = None) -> Layout:
    """The kernel's block layout at this geometry: the first of
    :func:`layouts`. Given the batch's ``rows`` and the card's ``sms``,
    two warpgroups on pieces give way to the first layout of one
    warpgroup where its blocks take fewer waves than theirs times
    ``_PAIR_BLOCK_COST`` (a small batch: at 64 rows x 3 s two warpgroups
    make 150 blocks, two waves on 132 SMs, the second 18 blocks; one
    warpgroup is 4-12% faster there on the H100, framefft_phases.py).
    Raises where no layout fits."""
    fits = layouts(step, win, n_windows)
    if not fits:
        raise ValueError(
            f"win={win}, step={step}: no block layout fits "
            f"{_MAX_SHARED_BYTES} bytes of shared memory")
    best = fits[0]
    if rows and sms and best.consumers == 2 and best.piece:
        one = next((lay for lay in fits if lay.consumers == 1), None)
        windows = rows * n_windows
        if one and (_waves(one, windows, sms)
                    < _PAIR_BLOCK_COST * _waves(best, windows, sms)):
            best = one
    return best


@functools.lru_cache(maxsize=256)
def launch_shape(step: int, win: int, n_windows: int,
                 rows: Optional[int] = None, sms: Optional[int] = None) -> Layout:
    """The kernel's block layout at this geometry: :func:`plan_layout`, with
    its bytes held equal to the library's ``framefft_shared_bytes`` (what
    the launch asks for). Raises where no layout fits a block's shared
    memory."""
    layout = plan_layout(step, win, n_windows, rows, sms)
    nbytes = _lib().framefft_shared_bytes(step, win, n_windows, *layout[:4])
    if nbytes != layout.bytes:
        raise RuntimeError(
            f"csrc/framefft.cu gives layout {tuple(layout[:4])} {nbytes} bytes of "
            f"shared memory, ops/framefft.py::shared_bytes {layout.bytes}")
    return layout


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(signals, step_samples, offset0, n_windows, cos_basis, sin_basis,
            mel_weights, *, n_bins, n_mel, dft, fbank, emit, passes):
    """One launch of the CUDA kernel into new output tensors."""
    global LAUNCHES
    if signals.device.type != "cuda":
        raise ValueError(f"unsupported device {signals.device}")
    if signals.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, got {signals.dtype}")
    tensors = (signals, cos_basis, sin_basis, mel_weights)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    win = cos_basis.shape[0]
    b, s = signals.shape
    m_pad = mel_weights.shape[1]
    if b <= 0 or s > _INT32_MAX or b * n_windows > _INT32_MAX:
        raise ValueError(f"signals [B, S]={tuple(signals.shape)} out of range")

    if n_mel > _MAX_MEL:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_MEL} mel "
                         f"filters, got {n_mel}")

    lib = _lib()
    layout = launch_shape(step_samples, win, n_windows, b,
                          sm_count(signals.device))
    if layout.piece and signals.data_ptr() % 16:
        # pieces are staged in 16-byte copies
        signals = signals.clone()
    if m_pad % 4 or mel_weights.data_ptr() % 16:
        # the band table's scan reads 4 filters at a time in 16-byte loads
        mel_weights = torch.nn.functional.pad(mel_weights, (0, -m_pad % 4))
        m_pad = mel_weights.shape[1]
    basis, table = prologue_on_card(cos_basis, sin_basis, mel_weights, n_bins,
                                    n_mel, passes)
    emit_power, emit_logp = bool(emit[0]), bool(emit[1])
    new = lambda k: torch.empty((b, n_windows, k), dtype=torch.float32,
                                device=signals.device)
    power = new(n_bins) if emit_power else None
    logp = new(n_bins) if emit_logp else None
    mel = new(n_mel)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(signals.device):
        stream = torch.cuda.current_stream(signals.device).cuda_stream
        err = lib.framefft_launch(
            ptr(signals), ptr(basis), basis.shape[1], ptr(mel_weights),
            ptr(table), ptr(power), ptr(logp), ptr(mel),
            b, s, step_samples, offset0, n_windows, win, n_bins, n_mel, m_pad,
            n_limbs(passes), layout.consumers, layout.ring, layout.piece,
            layout.pbufs, float(dft.log_offset), float(dft.log_min), float(fbank.log_off),
            float(fbank.log_min), int(bool(dft.comp_log_pow)),
            ctypes.c_void_p(stream),
        )
    if err == -1:
        raise RuntimeError("framefft: the CUDA driver has no cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"framefft: the basis tensor map was refused "
                           f"(CUresult {-1000 - err})")
    if err != 0:
        raise RuntimeError(f"framefft kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_LAYOUT[layout.kind] = LAUNCHES_BY_LAYOUT.get(layout.kind, 0) + 1
    return power, logp, mel


def prologue_on_card(cos_basis: torch.Tensor, sin_basis: torch.Tensor,
                     mel_weights: torch.Tensor, n_bins: int, n_mel: int,
                     passes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's prologue on the card, one launch into new tensors: the
    basis limbs (:func:`pack_basis_limbs`, the same bits) and the mel
    bank's band table (:func:`band_table`, the same words where the
    kernel reads them). ``mel_weights`` [k_pad, m_pad] float32 with m_pad a
    multiple of 4, 16-byte aligned."""
    win, ld = cos_basis.shape
    nl = n_limbs(passes)
    k_pad = _round_up(win, K_CHUNK)
    n_pass = -(-n_bins // BINS_PER_PASS)
    dev = cos_basis.device
    out = torch.empty((nl * n_pass * 2 * BINS_PER_PASS, k_pad),
                      dtype=torch.bfloat16, device=dev)
    table = torch.empty(table_words(n_bins, n_mel), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().framefft_prologue_launch(
            ctypes.c_void_p(cos_basis.data_ptr()),
            ctypes.c_void_p(sin_basis.data_ptr()), ld, win, n_bins, nl, k_pad,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(mel_weights.data_ptr()), mel_weights.shape[1],
            n_mel, ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"framefft prologue failed: CUDA error {err}")
    return out, table


def mel_bands(mel_weights: torch.Tensor, n_bins: int,
              n_mel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each filter's band of ``mel_weights`` [bins, filters]: the first and
    the last bin below ``n_bins`` whose weight is nonzero or NaN, as int64
    tensors [n_mel]; an empty band (every weight +-0) is (0, -1). Outside
    its band a filter's weights are +-0, so for finite power its sum over
    the band in ascending bin order is, bit for bit, the dense one."""
    nz = mel_weights[:n_bins, :n_mel] != 0  # NaN != 0
    k = torch.arange(n_bins, device=mel_weights.device)[:, None]
    lo = torch.where(nz, k, n_bins).amin(0)
    hi = torch.where(nz, k, -1).amax(0)
    return torch.where(hi >= 0, lo, 0), hi


def _table_strides(n_mel: int) -> Tuple[int, int]:
    # a pass's int4 entries (a header first) and weights: at least what the
    # consumers stage, so that a pass's staging copy stays in the table
    return (max(n_mel + 1, STAGED_ENTRIES),
            max(BINS_PER_PASS * n_mel, STAGED_WEIGHTS))


def table_words(n_bins: int, n_mel: int) -> int:
    """int32 words of the band table (the library's
    ``framefft_table_words``)."""
    entries, weights = _table_strides(n_mel)
    return -(-n_bins // BINS_PER_PASS) * (4 * entries + weights)


def band_table(mel_weights: torch.Tensor, n_bins: int,
               n_mel: int) -> torch.Tensor:
    """The plain version of the band table the kernel's prologue builds
    (``csrc/framefft.cu::build_band_table``): int32 [table_words], a pass
    after another [entries (int4)] then [weights (float32 bits)] per pass
    (the words past a pass's counts are 0 here and unwritten on the card).

    Entry 0 of pass p is the header (entries, the first entry of the
    second half, weights, 0). Entries list the filters whose band meets the
    pass's bins [56p, 56p + 56) in ascending filter order, and in the last
    pass also the filters with an empty band; each is (filter, first bin in
    the pass | length << 8 | OPENS (its band starts in the pass) | CLOSES
    (and ends in it), offset of its weights, carry slot in | carry slot out
    << 16), the slots numbered among the pass's entries that do not open
    and do not close (so among the filters open across its start and its
    end). A window's two epilogue threads take the entries before and from
    the split: an entry goes first where the middle of its cost (length +
    _ENTRY_COST) falls in the first half of the pass's."""
    lo, hi = mel_bands(mel_weights, n_bins, n_mel)
    w = mel_weights[:n_bins, :n_mel].to(torch.float32)
    dev = mel_weights.device
    n_pass = -(-n_bins // BINS_PER_PASS)
    e_stride, w_stride = _table_strides(n_mel)
    ent = torch.zeros((n_pass, e_stride, 4), dtype=torch.int64, device=dev)
    wts = torch.zeros((n_pass, w_stride), dtype=torch.float32, device=dev)
    filt = torch.arange(n_mel, device=dev)
    empty = hi < 0
    for q in range(n_pass):
        qs = q * BINS_PER_PASS
        qe = min(qs + BINS_PER_PASS, n_bins) - 1
        touch = ((lo <= qe) & (hi >= qs)) | (empty & (q == n_pass - 1))
        f, l, h, e = filt[touch], lo[touch], hi[touch], empty[touch]
        kb = torch.where(e, 0, l.clamp(min=qs) - qs)
        n = torch.where(e, 0, h.clamp(max=qe) - qs - kb + 1)
        opens, closes = e | (l >= qs), e | (h <= qe)
        woff = torch.cumsum(n, 0) - n
        c_in, c_out = (~opens).long(), (~closes).long()
        slot_in, slot_out = torch.cumsum(c_in, 0) - c_in, torch.cumsum(c_out, 0) - c_out
        cost = n + _ENTRY_COST
        before = torch.cumsum(cost, 0) - cost
        split = int((2 * before + cost <= int(cost.sum())).sum())
        nz = int(n.sum())
        ent[q, 0] = torch.tensor([len(f), split, nz, 0])
        ent[q, 1:1 + len(f)] = torch.stack([
            f, kb | n << 8 | opens.long() * _OPENS | closes.long() * _CLOSES,
            woff, slot_in | slot_out << 16], 1)
        rows = (qs + torch.repeat_interleave(kb - woff, n)
                + torch.arange(nz, device=dev))
        wts[q, :nz] = w[rows, torch.repeat_interleave(f, n)]
    return torch.cat([ent.to(torch.int32).reshape(-1),
                      wts.view(torch.int32).reshape(-1)])


def _floored_log_grad(g: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    """d/dx of floored_log at ``shifted = x + offset``: g / shifted, and 0
    where ``shifted == 0`` (the floor is a constant there). NaN stays NaN."""
    return torch.where(shifted == 0, torch.zeros_like(g), g / shifted)


def overlap_add(frames: torch.Tensor, step: int, offset0: int,
                length: int) -> torch.Tensor:
    """The adjoint of the window gather: frames [B, n, win] starting at
    ``offset0 + step*i`` summed into [B, length]; positions left of 0 or at
    or past ``length`` are dropped (the forward zero-filled them).

    Deterministic: ``ceil(win/step)`` shifted adds of [B, n, <=step] slices
    over a [B, n + r - 1, step] buffer, each a plain elementwise add (no
    atomics, so the sum order is fixed)."""
    b, n, win = frames.shape
    r = -(-win // step)
    buf = frames.new_zeros((b, n + r - 1, step))
    for j in range(r):
        width = min(step, win - j * step)
        buf[:, j:j + n, :width] += frames[:, :, j * step:j * step + width]
    buf = buf.reshape(b, -1)  # buf[:, k] is sample offset0 + k
    out = frames.new_zeros((b, length))
    lo, hi = max(offset0, 0), min(offset0 + buf.shape[1], length)
    if hi > lo:
        out[:, lo:hi] = buf[:, lo - offset0:hi - offset0]
    return out


def fused_frame_power_mel_backward(
    signals: torch.Tensor,
    step_samples: int,
    offset0: int,
    n_windows: int,
    cos_basis: torch.Tensor,
    sin_basis: torch.Tensor,
    mel_weights: torch.Tensor,
    g_power: Optional[torch.Tensor],
    g_logp: Optional[torch.Tensor],
    g_mel: Optional[torch.Tensor],
    *,
    n_bins: int,
    n_mel: int,
    dft: DFTParams,
    fbank: FilterBank,
    needs: Tuple[bool, bool, bool, bool] = (True, False, False, False),
) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of the fused frontend w.r.t. (signals, cos_basis,
    sin_basis, mel_weights) given the output gradients (None = no gradient
    for that output), in plain tensor ops: the windows and their re/im
    parts are recomputed from the signals (the gated outputs need not be
    kept), then

      g_p   = g_power + g_logp / (p + LogOffSet) + (g_mel / (melsum + LogOff)) @ W^T
      g_re  = 2 re g_p,  g_im = 2 im g_p
      g_win = g_re @ cos^T + g_im @ sin^T  -> overlap-added into the signal

    with the ``== 0`` floors taking no gradient, and NaN mel weights giving
    NaN, as autodiff of the plain version gives. ``needs`` selects which of
    the four gradients to compute (the others are None)."""
    if g_power is None and g_logp is None and g_mel is None:
        return (None,) * 4
    win, k_pad = cos_basis.shape
    starts = offset0 + step_samples * torch.arange(
        n_windows, device=signals.device
    )
    windows = extract_windows(signals, starts, win)   # [B, n, win]
    cos_m, sin_m = cos_basis[:, :n_bins], sin_basis[:, :n_bins]
    re = torch.matmul(windows, cos_m)
    im = torch.matmul(windows, sin_m)
    p = re * re + im * im
    g_p = torch.zeros_like(p) if g_power is None else g_power.clone()
    if g_logp is not None and dft.comp_log_pow:
        g_p += _floored_log_grad(g_logp, p + dft.log_offset)
    g_w = None
    if g_mel is not None:
        w = mel_weights[:n_bins, :n_mel]
        g_sum = _floored_log_grad(g_mel, torch.matmul(p, w) + fbank.log_off)
        g_p += torch.matmul(g_sum, w.T)
        if needs[3]:
            g_w = mel_weights.new_zeros(mel_weights.shape)
            g_w[:n_bins, :n_mel] = torch.matmul(
                p.reshape(-1, n_bins).T, g_sum.reshape(-1, n_mel)
            )
    g_re = 2.0 * re * g_p
    g_im = 2.0 * im * g_p
    del re, im, p, g_p

    def basis_grad(g_part):
        out = cos_basis.new_zeros(cos_basis.shape)
        out[:, :n_bins] = torch.matmul(
            windows.reshape(-1, win).T, g_part.reshape(-1, n_bins)
        )
        return out

    g_cos = basis_grad(g_re) if needs[1] else None
    g_sin = basis_grad(g_im) if needs[2] else None
    g_sig = None
    if needs[0]:
        g_win = torch.matmul(g_re, cos_m.T) + torch.matmul(g_im, sin_m.T)
        g_sig = overlap_add(g_win, step_samples, offset0, signals.shape[-1])
    return g_sig, g_cos, g_sin, g_w


class _LimbProduct(torch.autograd.Function):
    """``x @ b`` at a limb grade: both float32 operands split into ``nl``
    bf16 limbs and the products of :func:`limb_terms` summed in that order,
    each an FP32 matmul of bf16 values. The backward is that of the exact
    float32 product (as the kernel's Function), not of the bf16 casts."""

    @staticmethod
    def forward(ctx, x, b, nl):
        ctx.save_for_backward(x, b)
        x_limbs = [t.float() for t in split_limbs(x, nl)]
        b_limbs = [t.float() for t in split_limbs(b, nl)]
        acc = None
        for i, j in limb_terms(nl):
            d = torch.matmul(x_limbs[i], b_limbs[j])
            acc = d if acc is None else acc + d
        return acc

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        gx = torch.matmul(g, b.T) if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(x.reshape(-1, x.shape[-1]).T,
                              g.reshape(-1, g.shape[-1]))
        return gx, gb, None


def fused_frame_power_mel_reference(
    signals: torch.Tensor,
    step_samples: int,
    offset0: int,
    n_windows: int,
    cos_basis: torch.Tensor,
    sin_basis: torch.Tensor,
    mel_weights: torch.Tensor,
    *,
    n_bins: int,
    n_mel: int,
    dft: DFTParams,
    fbank: FilterBank,
    emit: Tuple[bool, bool] = (True, True),
    passes: int = 6,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
    """The plain PyTorch version of :func:`fused_frame_power_mel` (any
    device, float32 or float64): window gather, ``windows @ cos`` and
    ``windows @ sin``, power, log power and log-mel.

    In float32 at 3 and 1 passes the two DFT products are the kernel's
    grade, literally: both operands split into ``n_limbs(passes)`` bf16
    limbs and the products of :func:`limb_terms` summed in that order, each
    an FP32 matmul of bf16 values (exact products; run it with TF32 off).
    At 6 passes three limbs hold each float32 operand exactly and the six
    products leave out only terms below float32 rounding, so the exact
    grade is the float32 matmul itself. In float64 they are the exact
    matmul and ``passes`` only is validated. The mel sum is the FP32 (or
    float64) matmul at every grade."""
    nl = n_limbs(passes)
    starts = offset0 + step_samples * torch.arange(
        n_windows, device=signals.device
    )
    windows = extract_windows(signals, starts, cos_basis.shape[0])
    basis = (cos_basis[:, :n_bins], sin_basis[:, :n_bins])
    if windows.dtype == torch.float32 and nl < 3:
        re = _LimbProduct.apply(windows, basis[0], nl)
        im = _LimbProduct.apply(windows, basis[1], nl)
        power = re * re + im * im
        del re, im
    else:
        power = power_spectrum(windows, basis)
    mel = floored_log(
        torch.matmul(power, mel_weights[:n_bins, :n_mel]),
        fbank.log_off, fbank.log_min,
    )
    logp = None
    if emit[1]:
        logp = (
            floored_log(power, dft.log_offset, dft.log_min)
            if dft.comp_log_pow else torch.zeros_like(power)
        )
    return (power if emit[0] else None), logp, mel
