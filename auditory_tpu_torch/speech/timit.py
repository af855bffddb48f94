"""TIMIT phone vocabularies and timing/transcription loaders.

Analog of the reference ``speech/timit`` package (speech/timit/timit.go).
Phone sets and fold maps transcribed from timit.go:27-183 (these are the
standard TIMIT tables of Lee & Hon 1989, not copyrightable logic).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import Unit, scan_lines

__all__ = [
    "PHONE_CATS_61",
    "PHONE_CATS_41",
    "PHONE_CATS_10",
    "PHONES_10",
    "PHONES_41",
    "PHONES_61",
    "idx_from_snd",
    "snd_from_idx",
    "is_stop",
    "load_times",
    "load_text",
    "load_transcription",
]

# full transcribed set (timit.go:27-30); order matters
PHONE_CATS_61 = [
    "iy", "ih", "eh", "ae", "ix", "ah", "ax", "ax-h", "uw", "ux", "uh", "ao",
    "aa", "ey", "ay", "oy", "aw", "ow", "l", "el", "r", "y", "w", "er", "axr",
    "m", "em", "n", "nx", "en", "ng", "eng", "ch", "jh", "dh", "b", "d", "dx",
    "g", "p", "t", "k", "z", "zh", "v", "f", "th", "s", "sh", "hh", "hv",
    "pcl", "tcl", "kcl", "bcl", "dcl", "gcl", "epi", "h#", "pau", "q",
]

# reduced set with confusables folded (timit.go:36-38)
PHONE_CATS_41 = [
    "iy", "ih", "eh", "ae", "ix", "ah", "uw", "uh", "ao", "ey", "ay", "oy",
    "aw", "ow", "l", "r", "y", "w", "er", "m", "n", "ng", "ch", "jh", "dh",
    "b", "d", "dx", "g", "p", "t", "k", "z", "zh", "v", "f", "th", "s", "hh",
    "pcl", "q",
]

# "begin with success" starter set (timit.go:40-55)
PHONE_CATS_10 = ["ah", "ao", "dh", "er", "ix", "iy", "l", "n", "r", "s"]

PHONES_10 = {p: i for i, p in enumerate(PHONE_CATS_10)}

# 61 -> 41 fold map (timit.go:57-119)
_FOLD_41 = {
    "ax": "ah", "ax-h": "ah", "ux": "uw", "aa": "ao", "el": "l", "axr": "er",
    "em": "m", "nx": "n", "en": "n", "eng": "ng", "sh": "zh", "hv": "hh",
    "tcl": "pcl", "kcl": "pcl", "bcl": "pcl", "dcl": "pcl", "gcl": "pcl",
    "h#": "pcl", "pau": "pcl", "epi": "pcl",
}
PHONES_41 = {}
for _p in PHONE_CATS_61:
    _t = _FOLD_41.get(_p, _p)
    if _t in PHONE_CATS_41:
        PHONES_41[_p] = PHONE_CATS_41.index(_t)

PHONES_61 = {p: i for i, p in enumerate(PHONE_CATS_61)}


def idx_from_snd(s: str, set_id: str) -> Tuple[int, bool]:
    """Phone -> index (timit.go:187-200). set_id in Phones10/41/61."""
    table = {"Phones10": PHONES_10, "Phones41": PHONES_41, "Phones61": PHONES_61}.get(
        set_id
    )
    if table is None:
        return -1, False
    if s in table:
        return table[s], True
    return -1, False


def snd_from_idx(idx: int, set_id: str) -> Tuple[str, bool]:
    """Index -> phone (timit.go:204-232). Like the reference (map iteration),
    a folded index returns one of its members; we return the last in table
    order to match Go's 'last write wins' only up to map-order nondeterminism,
    so callers should treat any member as valid."""
    table = {"Phones10": PHONES_10, "Phones41": PHONES_41, "Phones61": PHONES_61}.get(
        set_id
    )
    if table is None:
        return "", False
    out = ""
    ok = False
    for k, v in table.items():
        if v == idx:
            out, ok = k, True
    return out, ok


def is_stop(s: str) -> bool:
    """timit.go:241-246."""
    return s in ("b", "d", "g", "k", "p", "t")


def load_transcription(fn: str) -> List[str]:
    """A no-op for TIMIT; load_times does both (timit.go:235-238)."""
    return []


def load_times(fn: str, names: Optional[List[str]] = None, fuse: bool = False) -> List[Unit]:
    """Parse a ``.PHN.MS`` file into timed units (timit.go:251-319).

    Each line is ``<start-ms> <phone>``. A unit's end is the next unit's
    start. With ``fuse=True`` a stop closure and its consonant (e.g. ``bcl``
    + ``b``) merge into one unit named after the consonant. ``h#`` marks
    silence; a tail ``h#`` gets end = start + 1.
    """
    units: List[Unit] = []
    with open(fn, "r") as fp:
        lines = scan_lines(fp.read())

    i = 0
    prv_closure = False
    closure = ""
    for t in lines:
        if t == "":
            break
        fields = t.split()
        time_s, snd = fields[0], fields[1]

        if (not prv_closure) or (prv_closure and snd != closure[0]):
            prv_closure = False
            closure = ""
            u = Unit()
            units.append(u)
            try:
                u.start = float(time_s)
            except ValueError:
                pass

            if fuse and snd.endswith("cl"):
                prv_closure = True
                closure = snd
                u.name = snd[: -len("cl")]  # bcl -> b
                if i > 0:  # a leading closure would panic in the reference
                    units[i - 1].end = u.start
                i += 1
                continue
            if snd == "h#":
                u.silence = True
            if len(units) > 1:
                if snd == "h#":  # tail silence: unknown end = start + 1
                    u.end = u.start + 1
                units[i - 1].end = u.start
            u.name = snd
            i += 1
        else:
            prv_closure = False
    return units


def load_text(fn: str) -> str:
    """Full text of the TIMIT .TXT transcription, times stripped
    (timit.go:322-343)."""
    with open(fn, "r") as fp:
        s = ""
        for line in scan_lines(fp.read()):
            s = line  # literal last scanned line, blank or not (Go quirk)
    digits = "0123456789"
    s = s.lstrip(digits).lstrip(" ").lstrip(digits).lstrip(" ")
    return s
