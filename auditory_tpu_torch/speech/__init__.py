"""Speech corpus metadata layer: units, sequences, and per-corpus loaders.

Analog of the reference ``speech`` package (speech/speech.go) with the
per-corpus modules :mod:`.timit`, :mod:`.synthcvs`, :mod:`.grafestes`.
"""

from dataclasses import dataclass, field
from typing import List

__all__ = ["Unit", "Sequence", "adjust_sequence_times", "scan_lines"]


def scan_lines(text: str) -> List[str]:
    """Split into lines with Go ``bufio.ScanLines`` semantics: '\\n'
    terminators, dropping exactly ONE trailing '\\r' per line -- so CRLF
    files parse identically to LF files (every reference loader reads via
    ScanLines; a bare ``split('\\n')`` would leave '\\r' on each line and,
    worse, treat a CRLF blank line as non-blank, breaking the loaders'
    blank-line stop conditions). Like Go's Scan(), a file ENDING with a
    newline yields no final empty token ('a\\n' -> ['a'], 'a\\n\\n' ->
    ['a', '']), and EMPTY input yields zero tokens ('' -> [])."""
    if not text:
        return []
    parts = text.split("\n")
    if parts and parts[-1] == "" and text.endswith("\n"):
        parts.pop()
    return [
        line[:-1] if line.endswith("\r") else line
        for line in parts
    ]


@dataclass
class Unit:
    """One unit of sound -- a phone, CV syllable, or word
    (reference speech/speech.go:23-45)."""

    name: str = ""
    start: float = 0.0    # ms
    end: float = 0.0      # ms
    a_start: float = 0.0  # ms, adjusted for silence/offset
    a_end: float = 0.0
    silence: bool = False
    type: str = ""


@dataclass
class Sequence:
    """A sequence of speech units, e.g. one utterance
    (reference speech/speech.go:48-86)."""

    file: str = ""
    id: str = ""
    sequence: str = ""
    text: str = ""
    units: List[Unit] = field(default_factory=list)
    silence: float = 0.0
    start: float = 0.0
    stop: float = 0.0
    offset: int = 0
    cur_time: float = 0.0
    next_time: float = 0.0

    def init(self) -> None:
        self.units = []


def adjust_sequence_times(seq: Sequence) -> None:
    """Adjust unit times for leading silence/offset (reference
    examples/gaborview gbv.go:738-748 AdjSeqTimes)."""
    if not seq.units:
        return
    silence = seq.silence
    offset = seq.units[0].start if seq.units[0].start > 0 else 0.0
    for u in seq.units:
        u.a_start = u.start + silence - offset
        u.a_end = u.end + silence - offset
