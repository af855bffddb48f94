"""Graf Estes & Lew-Williams (2015) spoken-CV corpus metadata.

Analog of the reference ``speech/grafestes`` package
(speech/grafestes/grafestes.go).
"""

from __future__ import annotations

from typing import List, Tuple

from . import Unit
from .synthcvs import load_times as _load_times
from .synthcvs import load_transcription as _load_transcription

__all__ = [
    "CVS", "CVS_PER_WORD", "CVS_PER_POS",
    "load_transcription", "load_times", "idx_from_snd", "snd_from_idx",
]

CVS = ["ti", "do", "ga", "mo", "may", "bu", "pi", "ku"]  # grafestes.go:23
CVS_PER_WORD = 2
CVS_PER_POS = 4


def load_transcription(fn: str) -> List[str]:
    """Same format as synthcvs (grafestes.go:28-45)."""
    return _load_transcription(fn)


def load_times(fn: str, names: List[str]) -> List[Unit]:
    """Same format as synthcvs (grafestes.go:48-88)."""
    return _load_times(fn, names)


def idx_from_snd(s: str, set_id: str = "") -> Tuple[int, bool]:
    try:
        return CVS.index(s), True
    except ValueError:
        return -1, False


def snd_from_idx(idx: int, set_id: str = "") -> Tuple[str, bool]:
    if 0 <= idx < len(CVS):
        return CVS[idx], True
    return "", False
