"""Hillenbrand vowel corpus (American English vowels).

Analog of the reference ``speech/vowels`` package
(speech/vowels/vowels.go:24-115). See Hillenbrand et al. (1995, 2001);
wav files + docs at https://homepages.wmich.edu/~hillenbr/voweldata.html.

The reference's loaders are line-for-line identical to synthcvs's
(last-line transcription split; '<start-s> <end-s>' times with the
backslash-prefixed *frequency* lines skipped, blank-line stop, and the
names-bound early return) -- delegate like :mod:`.grafestes` does, so the
parser has one implementation.
"""

from __future__ import annotations

from typing import List, Tuple

from . import Unit
from .synthcvs import load_times as _load_times
from .synthcvs import load_transcription as _load_transcription

__all__ = ["CATS", "load_transcription", "load_times", "idx_from_snd", "snd_from_idx"]

# the 12 vowel categories (vowels.go:25)
CATS = ["ae", "ah", "aw", "eh", "ei", "er", "ih", "iy", "oa", "oo", "uh", "uw"]


def load_transcription(fn: str) -> List[str]:
    """Space-split *last* line of the file (vowels.go:30-47)."""
    return _load_transcription(fn)


def load_times(fn: str, names: List[str]) -> List[Unit]:
    """Per-line '<start-s> <end-s>' times in seconds -> ms. Blank line stops
    parsing; lines starting with a backslash carry start/end *frequency*
    data and are skipped; parsing also stops once every name is consumed
    (vowels.go:50-91)."""
    return _load_times(fn, names)


def idx_from_snd(s: str, set_id: str = "") -> Tuple[int, bool]:
    """Index of the vowel in :data:`CATS`; ``set_id`` is ignored -- the
    corpus has no subsets (vowels.go:95-107)."""
    try:
        return CATS.index(s), True
    except ValueError:
        return -1, False


def snd_from_idx(idx: int, set_id: str = "") -> Tuple[str, bool]:
    """Vowel at ``idx`` in :data:`CATS`; ``set_id`` ignored
    (vowels.go:111-122)."""
    if 0 <= idx < len(CATS):
        return CATS[idx], True
    return "", False
