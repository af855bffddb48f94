"""gnuspeech synthesized CV corpus (Saffran, Aslin & Newport-style).

Analog of the reference ``speech/synthcvs`` package
(speech/synthcvs/synthcvs.go).
"""

from __future__ import annotations

from typing import List, Tuple

from . import Unit, scan_lines

__all__ = [
    "CVS_I", "CVS_III", "CVS_IV", "CVS_V", "CVS_VI",
    "CVS_PER_WORD", "CVS_PER_POS",
    "load_transcription", "load_times", "idx_from_snd", "snd_from_idx",
]

# 3 groups of 4: first/second/third position of the trisyllabic words
# (synthcvs.go:25-30); order matters
CVS_I = ["da", "go", "pa", "ti", "ro", "la", "bi", "bu", "pi", "tu", "ku", "do"]
CVS_III = ["su", "ro", "pa", "ho", "ba", "lu", "go", "li", "hi", "ra", "di", "sa"]
CVS_IV = ["do", "na", "hu", "ki", "ka", "to", "mo", "mu", "ru", "si", "ta", "po"]
CVS_V = ["gu", "ma", "bi", "bu", "ri", "gi", "tu", "ni", "ha", "so", "ga", "bo"]
CVS_VI = ["da", "ti", "nu", "lo", "ku", "no", "pi", "du", "mi", "pu", "ko", "la"]

CVS_PER_WORD = 3
CVS_PER_POS = 4

_SETS = {"I": CVS_I, "III": CVS_III, "IV": CVS_IV, "V": CVS_V, "VI": CVS_VI}


def load_transcription(fn: str) -> List[str]:
    """Space-split LAST SCANNED line of the file (synthcvs.go:36-53) --
    faithfully including the quirk that a file ending in a blank line
    yields [''] (Go keeps the literal last token, blank or not)."""
    with open(fn, "r") as fp:
        s = ""
        for line in scan_lines(fp.read()):
            s = line
    return s.split(" ")


def load_times(fn: str, names: List[str]) -> List[Unit]:
    """Per-line '<start-s> <end-s>' times in seconds -> ms; lines starting
    with a backslash are skipped (synthcvs.go:56-96)."""
    units: List[Unit] = []
    with open(fn, "r") as fp:
        lines = scan_lines(fp.read())
    i = 0
    for t in lines:
        if t == "":
            break
        if t.startswith("\\"):
            continue
        u = Unit()
        units.append(u)
        fields = t.split()
        if len(fields) < 2:
            # the reference panics on cvs[0]/cvs[1] for a short line
            # (synthcvs.go:81-88); swallowing it would silently consume a
            # name and misalign every subsequent unit
            raise ValueError(
                f"{fn}: malformed times line {t!r} (need '<start> <end>')"
            )
        try:
            u.start = float(fields[0]) * 1000.0
        except ValueError:
            pass  # Go: ParseFloat err leaves the zero value (synthcvs.go:82)
        try:
            u.end = float(fields[1]) * 1000.0
        except ValueError:
            pass
        u.name = names[i]
        i += 1
        if i == len(names):
            return units
    return units


def idx_from_snd(s: str, set_id: str) -> Tuple[int, bool]:
    cvs = _SETS.get(set_id)
    if cvs is None:
        return -1, False
    try:
        return cvs.index(s), True
    except ValueError:
        return -1, False


def snd_from_idx(idx: int, set_id: str) -> Tuple[str, bool]:
    cvs = _SETS.get(set_id)
    if cvs is None or not (0 <= idx < len(cvs)):
        return "", False
    return cvs[idx], True
