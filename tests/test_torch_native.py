"""The port's native threaded WAV decoder (CPU): its library is built here
from ``auditory_tpu_torch/csrc/auditory_io.cpp`` by the host compiler, and
its decodes are held against the pure-Python ``io/wav`` decoder and against
the JAX package's ``io/native`` bindings driving the same library (exactly):
8/16/24/32-bit PCM and IEEE-float WAVs, the int16 tier with its divisors and
``STATUS_NOT_I16``, the status codes, and CorpusRunner's native and Python
decode paths, which must write identical features and records."""

import os
import shutil
import struct

import numpy as np
import pytest
import torch

import auditory_tpu.io.native as jnative
import auditory_tpu_torch as at
from auditory_tpu_torch.io import native
from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav
from auditory_tpu_torch.ops import _build

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _tone(freq, dur, sr, amp=0.8):
    t = np.arange(int(dur * sr)) / sr
    r = np.random.default_rng(int(freq))
    return amp * np.sin(2 * np.pi * freq * t) + 1e-4 * r.standard_normal(len(t))


def _wav(path, bits=16, sr=16000, dur=0.05, channels=1, freq=600.0):
    sig = _tone(freq, dur, sr)
    if channels > 1:
        sig = np.repeat(sig, channels) * np.tile([1.0, -0.5], len(sig))[: len(sig) * channels]
    write_wav(str(path), float_to_wave(sig, sr, bit_depth=bits, channels=channels))
    return str(path)


def _float_wav(path, samples, sr=16000):
    """A mono IEEE-float (format 3) 32-bit WAV, written by hand."""
    data = np.asarray(samples, dtype="<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, 4 * sr, 4, 32)
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    return str(path)


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's io/native bound to the port's built library (its
    bindings load ``libauditory_io.so`` beside their module file)."""
    assert native.available()
    lib = _build.build("auditory_io")
    shutil.copy(lib, tmp_path / "libauditory_io.so")
    monkeypatch.setattr(jnative, "__file__", str(tmp_path / "native.py"))
    monkeypatch.setattr(jnative, "_tried", False)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_has_i16", False)
    assert jnative.available() and jnative.has_i16()
    return jnative


def test_library_builds_from_the_ports_source():
    assert native.available() and native.has_i16() and native.build_error() is None
    lib = _build.build("auditory_io")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("auditory_io-")
    assert (_build.CSRC / "auditory_io.cpp").is_file()


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_decode_matches_wav_and_jax_native(bits, tmp_path, jax_native):
    p = _wav(tmp_path / f"t{bits}.wav", bits=bits)
    py = load_wav(p).sound_to_tensor(dtype=np.float32)
    before = native.DECODED
    out, lengths, srs, errors = native.decode_batch([p], len(py) + 10)
    assert native.DECODED == before + 1
    assert errors == [None] and srs[0] == 16000 and lengths[0] == len(py)
    np.testing.assert_allclose(out[0, : len(py)], py, rtol=1e-6, atol=1e-7)
    assert np.all(out[0, len(py):] == 0)
    j = jax_native.decode_batch([p], len(py) + 10)
    for a, b in zip((out, lengths, srs), j[:3]):
        np.testing.assert_array_equal(a, b)
    assert errors == j[3]


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_int16_tier(bits, tmp_path, jax_native):
    p = _wav(tmp_path / f"i{bits}.wav", bits=bits)
    w = load_wav(p)
    out, lengths, srs, divs, sts = native.decode_batch_i16([p], w.num_frames)
    j = jax_native.decode_batch_i16([p], w.num_frames)
    for a, b in zip((out, lengths, srs, divs, sts), j):
        np.testing.assert_array_equal(a, b)
    if bits <= 16:
        assert sts[0] == 0 and divs[0] == np.float32(w._norm_divisor())
        np.testing.assert_array_equal(out[0], w.data[: w.num_frames])
    else:
        assert sts[0] == native.STATUS_NOT_I16


def test_float_wav(tmp_path, jax_native):
    samples = np.linspace(-0.9, 0.9, 700).astype(np.float32)
    p = _float_wav(tmp_path / "f.wav", samples)
    assert native.wav_info(p) == (16000, 1, 32, 700)
    out, lengths, _, errors = native.decode_batch([p], 800)
    assert errors == [None] and lengths[0] == 700
    np.testing.assert_array_equal(out[0, :700], samples)
    assert native.decode_batch_i16([p], 800)[4][0] == native.STATUS_NOT_I16
    np.testing.assert_array_equal(out, jax_native.decode_batch([p], 800)[0])


def test_stereo_flatten_and_channel(tmp_path):
    p = _wav(tmp_path / "st.wav", channels=2, dur=0.03)
    w = load_wav(p)
    flat = w.sound_to_tensor(dtype=np.float32)
    out, lengths, _, errors = native.decode_batch([p], len(w.data))
    np.testing.assert_allclose(out[0, : lengths[0]], flat, rtol=1e-6)
    out1, lengths1, _, _ = native.decode_batch([p], len(w.data), channel=1)
    np.testing.assert_allclose(out1[0, : lengths1[0]],
                               w.channel_signal(1, dtype=np.float32), rtol=1e-6)


def test_status_codes(tmp_path, jax_native):
    good = _wav(tmp_path / "g.wav", sr=8000, dur=0.02)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFFgarbage!")
    missing = str(tmp_path / "missing.wav")
    long_ = _wav(tmp_path / "l.wav", dur=0.1)
    paths = [good, bad, missing, long_]
    out, lengths, srs, errors = native.decode_batch(paths, 400, n_threads=3)
    assert errors[0] is None and lengths[0] == 160
    assert errors[1] == "not a RIFF/WAVE file"
    assert errors[2] == "open failed"
    assert errors[3] == "file longer than buffer"
    assert errors == jax_native.decode_batch(paths, 400)[3]
    sts = native.decode_batch_i16(paths, 400)[4]
    np.testing.assert_array_equal(sts, jax_native.decode_batch_i16(paths, 400)[4])
    assert [native.STATUS_NAMES[int(s)] for s in sts] == [
        "ok", "not a RIFF/WAVE file", "open failed", "file longer than buffer"]
    with pytest.raises(IOError, match="open failed"):
        native.wav_info(missing)


def _corpus(root):
    os.makedirs(root)
    paths = [_wav(os.path.join(root, f"u{i}.wav"), bits=16, dur=0.3 + 0.05 * i,
                  freq=400.0 + 90 * i) for i in range(3)]
    paths.append(_wav(os.path.join(root, "deep.wav"), bits=24, dur=0.35))
    paths.append(_wav(os.path.join(root, "stereo.wav"), channels=2, dur=0.2))
    paths.append(_wav(os.path.join(root, "rate.wav"), sr=8000, dur=0.2))
    return sorted(paths)


@pytest.mark.parametrize("transfer", ["auto", "float32"])
def test_corpus_native_and_python_decoders_agree(transfer, tmp_path, monkeypatch):
    """The int16 tier (16-bit files), the STATUS_NOT_I16 float path (the
    24-bit file) and the failure records (stereo, another rate) write the
    same features and manifest records through either decoder."""
    import json

    paths = _corpus(str(tmp_path / "wavs"))
    cfg = at.SndEnvConfig(gabor=at.GaborSet(specs=at.default_gabor_specs()))
    runs = {}
    for decoder in ("native", "python"):
        runner = at.CorpusRunner(cfg, 16000, batch_size=2, device=CPU,
                                 transfer=transfer)
        with monkeypatch.context() as m:
            if decoder == "python":
                # io/wav: the runner's fallback without the native library
                m.setattr(native, "available", lambda: False)
            stats = runner.run(paths, str(tmp_path / decoder))
        assert stats.files_done == 4 and stats.files_failed == 2
        runs[decoder] = runner.decode_counts
        with open(tmp_path / decoder / "manifest.jsonl") as f:
            recs = sorted((r["path"], r["status"], r.get("error"))
                          for r in map(json.loads, f))
        runs[decoder + "_recs"] = recs
    # the native decoder reads every mono file (the 8 kHz one is refused
    # after its decode); the stereo file is refused from its header
    assert runs["native"] == {"native": 5, "python": 0}
    assert runs["python"] == {"native": 0, "python": 6}
    assert runs["native_recs"] == runs["python_recs"]
    for name in ("u0", "u1", "u2", "deep"):
        a = np.load(tmp_path / "native" / f"{name}.npz")
        b = np.load(tmp_path / "python" / f"{name}.npz")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


def test_corpus_falls_back_when_the_library_is_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)

    def no_compiler(name):
        raise RuntimeError("no host C++ compiler found")

    monkeypatch.setattr(_build, "load", no_compiler)
    assert not native.available() and "no host C++" in native.build_error()
    cfg = at.SndEnvConfig(gabor=at.GaborSet(specs=at.default_gabor_specs()))
    runner = at.CorpusRunner(cfg, 16000, device=CPU)
    paths = [_wav(tmp_path / "a.wav", dur=0.3)]
    assert runner.run(paths, str(tmp_path / "out")).files_done == 1
    assert runner.decode_counts == {"native": 0, "python": 1}
