"""The port's copies of the JAX package's NumPy-only host modules equal the
originals exactly, and importing the port loads neither JAX nor the JAX
package."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import auditory_tpu.config as jcfg
import auditory_tpu_torch.config as tcfg
from auditory_tpu.dsp import design as jdesign
from auditory_tpu.dsp import frame as jframe
from auditory_tpu.dsp.mel import delta_operator as jdelta
from auditory_tpu.io import wav as jwav
from auditory_tpu.nn.kwta import _noisy_xx1_cheb as jcheb
from auditory_tpu.nn.neigh_inhib import orthogonal_offsets as joffsets
from auditory_tpu_torch.dsp import design as tdesign
from auditory_tpu_torch.dsp import frame as tframe
from auditory_tpu_torch.dsp.mel import delta_operator as tdelta
from auditory_tpu_torch.io import wav as twav
from auditory_tpu_torch.nn.kwta import _noisy_xx1_cheb as tcheb
from auditory_tpu_torch.nn.neigh_inhib import orthogonal_offsets as toffsets

torch.set_num_threads(1)

RATES = (8000, 16000, 44100)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    """Exact equality, NaN positions included, for arrays or tuples."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _fbank(sr):
    return jcfg.FilterBank(hi_hz=min(8000.0, sr / 2))


@pytest.mark.parametrize("sr", RATES)
def test_config_copy(sr):
    assert dataclasses.asdict(tcfg.SndEnvConfig()) == dataclasses.asdict(
        jcfg.SndEnvConfig()
    )
    jt, tt = jcfg.WindowParams().derive(sr), tcfg.WindowParams().derive(sr)
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    assert jt.n_bins == tt.n_bins
    for n in (0, 1, 799, 1600, 4409, 4410, 123457):
        for ch in (1, 2):
            assert jt.seg_cnt(n, ch) == tt.seg_cnt(n, ch)
    for x in (0.49999999999999994, 2.5, -2.5, 10.5, 220.5):
        assert jcfg.go_round(x) == tcfg.go_round(x)
    assert jcfg.msec_to_samples(25.0, sr) == tcfg.msec_to_samples(25.0, sr)
    assert jcfg.samples_to_msec(441, sr) == tcfg.samples_to_msec(441, sr)
    assert dataclasses.asdict(
        tcfg.clamp_mel_to_nyquist(tcfg.SndEnvConfig(), sr)
    ) == dataclasses.asdict(jcfg.clamp_mel_to_nyquist(jcfg.SndEnvConfig(), sr))
    fb = tcfg.FilterBank(renorm_after_init=True)
    assert fb.renorm_effective and fb.renorm_scale == 0.1


@pytest.mark.parametrize("sr", RATES)
def test_design_copy(sr):
    win = jcfg.WindowParams().derive(sr).win_samples
    fb = _fbank(sr)
    a, b = jdesign.mel_design(fb, win, sr), tdesign.mel_design(fb, win, sr)
    _same((a.weights, a.bin_pts, a.hz_pts), (b.weights, b.bin_pts, b.hz_pts))
    _same(jdesign.dft_matrices(win), tdesign.dft_matrices(win))
    for kind in ("hamming", "hann"):
        _same(jdesign.analysis_window(kind, win),
              tdesign.analysis_window(kind, win))
    assert tdesign.analysis_window(None, win) is None
    _same(jdesign.dct1_matrix(fb.n_filters), tdesign.dct1_matrix(fb.n_filters))


def test_design_copy_nan_triangles():
    fb = jcfg.FilterBank(n_filters=80, lo_hz=0.0, hi_hz=4000.0)
    for win in (200, 256):
        a, b = jdesign.mel_design(fb, win, 8000), tdesign.mel_design(fb, win, 8000)
        assert np.isnan(a.weights).any()
        _same(a.weights, b.weights)
    with pytest.raises(ValueError):
        tdesign.mel_design(jcfg.FilterBank(hi_hz=9000.0), 400, 16000)


@pytest.mark.parametrize(
    "gset",
    [
        dict(size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
             specs=jcfg.default_gabor_specs(phases=(0.0, 1.5708))),
        dict(distribute=True, specs=jcfg.default_gabor_specs()),
        dict(specs=(jcfg.GaborSpec(circular=True, sigma_width=0.7),
                    jcfg.GaborSpec(orientation=90.0, off=True),
                    jcfg.GaborSpec(orientation=45.0, wavelen=3.0))),
    ],
    ids=["processspeech", "distribute", "circular_off"],
)
def test_gabor_bank_copy(gset):
    tspecs = tuple(
        tcfg.GaborSpec(**dataclasses.asdict(s)) for s in gset.get("specs", ())
    )
    j = jdesign.gabor_filters(jcfg.GaborSet(**gset))
    t = tdesign.gabor_filters(tcfg.GaborSet(**{**gset, "specs": tspecs}))
    _same(j, t)


@pytest.mark.parametrize("mode", ["sndenv", "gaborview"])
def test_delta_operator_copy(mode):
    _same(jdelta(14, 13, 2, mode), tdelta(14, 13, 2, mode))
    _same(jdelta(5, 3, 3, mode), tdelta(5, 3, 3, mode))


@pytest.mark.parametrize("degrees", [(16, 10), (24, 16)])
def test_noisy_xx1_cheb_copy(degrees):
    _same(jcheb(80.0, 0.01, *degrees), tcheb(80.0, 0.01, *degrees))
    _same(jcheb(40.0, 0.02, *degrees), tcheb(40.0, 0.02, *degrees))


def test_orthogonal_offsets_copy():
    for orients in ((0.0, 45.0, 90.0, 135.0), (30.0, 200.0, -45.0, 359.0),
                    tuple(np.linspace(-180.0, 180.0, 37))):
        _same(joffsets(orients), toffsets(orients))


@pytest.mark.parametrize("sr", RATES)
def test_frame_host_helpers_copy(sr):
    jt, tt = jcfg.WindowParams().derive(sr), tcfg.WindowParams().derive(sr)
    for seg in (1, 3, 17):
        for add_ms in (0, 7):
            _same(jframe.window_starts(jt, seg, add_ms),
                  tframe.window_starts(tt, seg, add_ms))
    for n in (0, 399, 4410, 48000, 123457):
        assert jframe.tail_len(n, jt) == tframe.tail_len(n, tt)
        assert jframe.pad_len(n, jt) == tframe.pad_len(n, tt)
    x = np.arange(2 * 5001, dtype=np.float32).reshape(2, 5001)
    _same(jframe.pad_signal(x, jt, 0.25), tframe.pad_signal(x, tt, 0.25))
    huge = (2**31) // tt.stride_samples + 2
    for mod, t in ((jframe, jt), (tframe, tt)):
        with pytest.raises(ValueError, match="int32"):
            mod.window_starts(t, huge)


def test_frame_zero_stride_refused():
    t = tcfg.WindowParams(stride_ms=0.01, step_ms=0.01).derive(8000)
    with pytest.raises(ValueError):
        tframe.tail_len(100, t)
    with pytest.raises(ValueError):
        tframe.pad_len(100, t)


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_wav_copy_round_trips(bits, tmp_path):
    rng = np.random.default_rng(bits)
    sig = np.clip(0.4 * rng.standard_normal(3000), -1, 1)
    jw, tw = jwav.float_to_wave(sig, 16000, bits), twav.float_to_wave(sig, 16000, bits)
    _same(jw.data, tw.data)
    twav.write_wav(str(tmp_path / "t.wav"), tw)
    jwav.write_wav(str(tmp_path / "j.wav"), jw)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    back = twav.load_wav(str(tmp_path / "j.wav"))
    ref = jwav.load_wav(str(tmp_path / "t.wav"))
    _same(back.data, ref.data)
    assert (back.sample_rate, back.channels, back.source_bit_depth) == (
        ref.sample_rate, ref.channels, ref.source_bit_depth)
    _same(back.sound_to_tensor(), ref.sound_to_tensor())


def test_wav_copy_stereo_quirk(tmp_path):
    sig = np.linspace(-0.5, 0.5, 2000)
    tw = twav.float_to_wave(sig, 8000, 16, channels=2)
    twav.write_wav(str(tmp_path / "s.wav"), tw)
    back, ref = twav.load_wav(str(tmp_path / "s.wav")), jwav.load_wav(
        str(tmp_path / "s.wav"))
    _same(back.sound_to_tensor(np.float32), ref.sound_to_tensor(np.float32))
    _same(back.channel_signal(1), ref.channel_signal(1))
    with pytest.raises(ValueError):
        back.channel_signal(2)


SPEECH = ("__init__", "grafestes", "synthcvs", "table", "timit", "vowels")


@pytest.mark.parametrize("name", SPEECH)
def test_speech_copy(name):
    """The host-only speech modules are verbatim copies (relative imports
    only), so the port's gabor_view needs no JAX package."""
    read = lambda pkg: open(os.path.join(REPO, pkg, "speech", name + ".py"),
                            encoding="utf-8").read()
    assert read("auditory_tpu_torch") == read("auditory_tpu")


def test_speech_copy_reads_like_original(tmp_path):
    from auditory_tpu.speech import table as jtable
    from auditory_tpu_torch.speech import table as ttable

    for i in range(2):
        (tmp_path / f"g{i}.wav").write_bytes(b"")
        (tmp_path / f"g{i}.PHN.MS").write_text("0 h#\n120 sh\n300 iy\n480 h#\n")
    rows = []
    for mod in (jtable, ttable):
        t = mod.SoundsTable()
        for i in range(2):
            t.add_sequence(mod.load_timit_sequence(str(tmp_path / f"g{i}.wav")))
        rows.append([dataclasses.astuple(r) for r in t.filter_sound("sh")])
    assert rows[0] == rows[1] and len(rows[0]) == 2


@pytest.mark.parametrize("path", [
    ("utils", "report.py"),
    ("utils", "viz.py"),
])
def test_utils_copy(path):
    """The NumPy-only report and viz modules are verbatim copies (relative
    imports only: viz reads the port's dsp.design)."""
    read = lambda pkg: open(os.path.join(REPO, pkg, *path), encoding="utf-8").read()
    assert read("auditory_tpu_torch") == read("auditory_tpu")


def test_native_source_copy():
    """The port ships the native WAV decoder's source: byte-equal to the JAX
    package's csrc/auditory_io.cpp."""
    read = lambda *p: open(os.path.join(REPO, *p), "rb").read()
    assert read("auditory_tpu_torch", "csrc", "auditory_io.cpp") == read(
        "csrc", "auditory_io.cpp")


def test_import_loads_no_jax():
    code = (
        "import sys, auditory_tpu_torch, auditory_tpu_torch.convert, "
        "auditory_tpu_torch.ops.framefft, auditory_tpu_torch.ops._build, "
        "auditory_tpu_torch.io.wav, auditory_tpu_torch.io.native, "
        "auditory_tpu_torch.nn.neigh_inhib, "
        "auditory_tpu_torch.speech.table, "
        "auditory_tpu_torch.parallel.mesh, "
        "auditory_tpu_torch.parallel.distributed, "
        "auditory_tpu_torch.utils.profiling, auditory_tpu_torch.utils.report, "
        "auditory_tpu_torch.utils.viz, auditory_tpu_torch.cli, "
        "auditory_tpu_torch.examples.train_phone_classifier, "
        "auditory_tpu_torch.examples.learnable_frontend, "
        "auditory_tpu_torch.examples.gabor_view, "
        "auditory_tpu_torch.examples.serve_streams, "
        "auditory_tpu_torch.examples.process_speech, chip_smoke; "
        "from auditory_tpu_torch.io import native; native.available(); "
        "from auditory_tpu_torch.utils import viz; "
        "from auditory_tpu_torch.dsp import design; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'auditory_tpu' or m.startswith('auditory_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_version_is_the_projects():
    import tomllib

    import auditory_tpu_torch

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        want = tomllib.load(f)["project"]["version"]
    assert auditory_tpu_torch.__version__ == want
