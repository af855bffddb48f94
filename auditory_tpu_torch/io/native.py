"""ctypes bindings for the native threaded WAV decoder (the port's copy of
``auditory_tpu/io/native.py``).

The C++ source ships with the port (``csrc/auditory_io.cpp``, equal to the
JAX package's ``csrc/auditory_io.cpp``) and is built at first use by
:mod:`..ops._build` with the host C++ compiler into
``build/auditory_tpu_torch/``. When the build fails (no compiler) the
library is unavailable and :class:`..pipeline.batch.CorpusRunner` decodes
with the pure-Python :mod:`.wav` instead, as the JAX package does.
:data:`DECODED` counts the files each native call decoded.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DECODED", "available", "build_error", "decode_batch", "decode_batch_i16",
    "has_i16", "wav_info", "STATUS_NAMES", "STATUS_NOT_I16",
]

STATUS_NAMES = {
    0: "ok",
    1: "open failed",
    2: "not a RIFF/WAVE file",
    3: "bad fmt chunk",
    4: "unsupported encoding",
    5: "truncated data",
    6: "file longer than buffer",
    7: "not representable as int16 (use the float path)",
}

#: decodable file whose samples need the float path (24/32-bit, float WAV)
STATUS_NOT_I16 = 7

#: files passed to the native batch decoders since import (or a reset to 0)
DECODED = 0

_lib: Optional[ctypes.CDLL] = None
_tried = False
_has_i16 = False
_build_error: Optional[str] = None


def has_i16() -> bool:
    """Whether the loaded native library exposes the raw-int16 batch
    decode."""
    _load()
    return _has_i16


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    _load()
    return _build_error


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _has_i16, _build_error
    if _tried:
        return _lib
    _tried = True
    try:
        from ..ops import _build

        lib = _build.load("auditory_io")
        _bind_base(lib)
    except (OSError, AttributeError, RuntimeError) as e:
        # no compiler, or a library missing a base symbol: the pure-Python
        # decoder takes over (available() -> False)
        _build_error = f"{type(e).__name__}: {e}"
        return None
    try:
        lib.auditory_wav_decode_batch_i16.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.auditory_wav_decode_batch_i16.restype = ctypes.c_int32
        _has_i16 = True
    except AttributeError:
        _has_i16 = False
    _lib = lib
    return lib


def _bind_base(lib: ctypes.CDLL) -> None:
    lib.auditory_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.auditory_wav_info.restype = ctypes.c_int32
    lib.auditory_wav_decode_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.auditory_wav_decode_batch.restype = ctypes.c_int32


def available() -> bool:
    return _load() is not None


def _need_lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable ({_build_error})")
    return lib


def wav_info(path: str) -> Tuple[int, int, int, int]:
    """(sample_rate, channels, bit_depth, n_frames); raises on error."""
    lib = _need_lib()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    bd = ctypes.c_int32()
    nf = ctypes.c_int64()
    st = lib.auditory_wav_info(os.fsencode(path), sr, ch, bd, nf)
    if st != 0:
        raise IOError(f"{path}: {STATUS_NAMES.get(st, st)}")
    return sr.value, ch.value, bd.value, nf.value


def decode_batch(
    paths: Sequence[str],
    max_samples: int,
    channel: int = -1,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Optional[str]]]:
    """Decode many WAVs in parallel (native threads).

    channel=-1 reproduces the reference SoundToTensor flattening
    (sound/sound.go:116-127); channel>=0 de-interleaves that channel.

    Returns (signals [n, max_samples] float32, lengths [n] int64,
    sample_rates [n] int32, errors [n] -- None when ok).
    """
    global DECODED
    lib = _need_lib()
    n = len(paths)
    # os.fsencode, not str.encode: surrogate-escaped (non-UTF-8)
    # filenames must reach fopen as their original filesystem bytes
    blob = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    # np.empty: the C workers memset every row before decoding into it
    out = np.empty((n, max_samples), dtype=np.float32)
    statuses = np.zeros(n, dtype=np.int32)
    lengths = np.zeros(n, dtype=np.int64)
    srs = np.zeros(n, dtype=np.int32)
    lib.auditory_wav_decode_batch(
        blob,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples,
        channel,
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    DECODED += n
    errors: List[Optional[str]] = [
        None if s == 0 else STATUS_NAMES.get(int(s), str(s)) for s in statuses
    ]
    return out, lengths, srs, errors


def decode_batch_i16(
    paths: Sequence[str],
    max_samples: int,
    channel: int = -1,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Raw-sample decode of 8/16-bit PCM WAVs: the integer samples as int16
    plus the reference normalization divisor per file
    (sound/sound.go:130-141), so the int->float divide runs on the device
    after a half-size host->device transfer.

    Returns (signals [n, max_samples] int16, lengths [n] int64,
    sample_rates [n] int32, divisors [n] float32, statuses [n] int32).
    A status of :data:`STATUS_NOT_I16` means the file is fine but needs
    :func:`decode_batch` (24/32-bit or float WAV)."""
    global DECODED
    lib = _need_lib()
    if not _has_i16:
        raise RuntimeError("native IO library lacks the int16 decoder")
    n = len(paths)
    blob = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    out = np.empty((n, max_samples), dtype=np.int16)  # C memsets rows
    statuses = np.zeros(n, dtype=np.int32)
    lengths = np.zeros(n, dtype=np.int64)
    srs = np.zeros(n, dtype=np.int32)
    divisors = np.zeros(n, dtype=np.float32)
    lib.auditory_wav_decode_batch_i16(
        blob,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        max_samples,
        channel,
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        divisors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    DECODED += n
    return out, lengths, srs, divisors, statuses
