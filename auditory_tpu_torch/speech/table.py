"""Sounds-table workflow: load WAV + transcription/timing pairs into a
filterable table of units, as the gaborview app does
(examples/gaborview/gbv.go:627-718 LoadTranscription + ConfigSoundsTable).

For TIMIT the timing file for ``X.WAV``/``X.wav`` is ``X.PHN.MS`` (with the
reference's ``ExpWavs`` path substitution, gbv.go:652-655) and the text is
``X.TXT``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

from . import Sequence, Unit, adjust_sequence_times
from . import grafestes, synthcvs, timit, vowels

__all__ = ["SoundRow", "SoundsTable", "load_timit_sequence", "load_cv_sequence", "idx_from_snd"]


@dataclass
class SoundRow:
    """One row of the sounds table (gbv.go:704-712)."""

    sound: str
    start: float
    end: float
    duration: float
    file: str
    dir: str
    wav_path: str


@dataclass
class SoundsTable:
    rows: List[SoundRow] = field(default_factory=list)
    sequences: List[Sequence] = field(default_factory=list)

    def add_sequence(self, seq: Sequence) -> None:
        self.sequences.append(seq)
        # gbv.go:650,690-693: TrimSuffix('.wav') THEN strip from the last
        # remaining dot -- a multi-dot stem 'a.b.wav' yields File 'a', not
        # 'a.b' (os.path.splitext alone would keep 'a.b')
        fn = seq.file
        if fn.endswith(".wav"):
            fn = fn[: -len(".wav")]
        fpth, nm = os.path.split(fn)
        i = nm.rfind(".")
        if i > 0:
            nm = nm[:i]
        splits = [s for s in fpth.split(os.sep) if s]
        short_dir = os.sep.join(splits[-2:]) if splits else fpth
        for u in seq.units:
            self.rows.append(
                SoundRow(
                    sound=u.name,
                    start=u.a_start,
                    end=u.a_end,
                    duration=u.a_end - u.a_start,
                    file=nm,
                    dir=short_dir,
                    wav_path=seq.file,
                )
            )

    def filter_sound(self, sound: str) -> List[SoundRow]:
        """Filter rows by unit name (gbv.go FilterSounds)."""
        return [r for r in self.rows if r.sound == sound]

    def __len__(self) -> int:
        return len(self.rows)


def load_timit_sequence(
    wav_path: str, fuse: bool = False, silence: float = 0.0
) -> Sequence:
    """Build a Sequence for one TIMIT wav (gbv.go:627-677 LoadTranscription):
    locate the .PHN.MS timing file, parse units, load the .TXT text, and
    adjust times for silence/offset. Missing timing data yields a single
    'unknown' unit like the reference (gbv.go:658-663)."""
    seq = Sequence(file=wav_path, id="Phones41", silence=silence)
    # reference munging, exactly (gbv.go:650-653): '.wav' trimmed as a
    # suffix only; 'ExpWavs' and '.WAV' replaced at their FIRST occurrence
    # anywhere (strings.Replace count=1)
    base = wav_path
    if base.endswith(".wav"):
        base = base[: -len(".wav")]
    base = base.replace("ExpWavs", "", 1)  # gbv.go:652
    base = base.replace(".WAV", "", 1)     # gbv.go:653
    phn = base + ".PHN.MS"
    txt = base + ".TXT"
    try:
        seq.units = timit.load_times(phn, fuse=fuse)
    except OSError:
        # missing timing -> single 'unknown' unit; the reference still runs
        # AdjSeqTimes on it (gbv.go:658-676), so a_start/a_end pick up the
        # silence offset
        seq.units = [Unit(name="unknown")]
        adjust_sequence_times(seq)
        return seq
    if os.path.exists(txt):
        seq.text = timit.load_text(txt)
    adjust_sequence_times(seq)
    return seq


def load_cv_sequence(
    wav_path: str,
    corpus: str = "SYNTHCVS",
    set_id: str = "I",
    silence: float = 0.0,
    times_suffix: str = ".times",
    trans_suffix: str = ".txt",
) -> Sequence:
    """Build a Sequence for a synthcvs/grafestes CV recording: the
    transcription file lists CV names, the times file start/end seconds."""
    mod = {"SYNTHCVS": synthcvs, "GRAFESTES": grafestes, "VOWELS": vowels}[corpus]
    seq = Sequence(file=wav_path, id=set_id, silence=silence)
    base = os.path.splitext(wav_path)[0]
    try:
        names = mod.load_transcription(base + trans_suffix)
        seq.sequence = " ".join(names)
        seq.units = mod.load_times(base + times_suffix, names)
    except OSError:
        seq.units = [Unit(name="unknown")]
        adjust_sequence_times(seq)  # silence offset applies (gbv.go:676)
        return seq
    adjust_sequence_times(seq)
    return seq


def idx_from_snd(corpus: str, snd: str, set_id: str = "") -> tuple:
    """Corpus-dispatching phone/CV lookup (gbv.go:751-764)."""
    if corpus == "TIMIT":
        return timit.idx_from_snd(snd, set_id or "Phones41")
    if corpus == "SYNTHCVS":
        return synthcvs.idx_from_snd(snd, set_id)
    if corpus == "GRAFESTES":
        return grafestes.idx_from_snd(snd, set_id)
    if corpus == "VOWELS":
        return vowels.idx_from_snd(snd, set_id)
    return -1, False
