"""The port's serve_streams and process_speech examples against the JAX
package's (CPU).

- serve_streams as a module with examples/serve_streams.py's test flags
  (tests/test_train_example.py): SERVE_OK and the JAX example's segments
  per stream; in process, the float32 tier's segments of every stream
  within the float32 error model's bound of the stream's offline float64
  run (tests/test_torch_sndenv.py::hold_f32), and the float16 tier within
  float16 rounding of the float32 tier
  (tests/test_torch_online.py::assert_tier);
- process_speech on a WAV of a tone mix: the JAX example's segment count
  and hottest band per segment, and every segment's mel from both
  packages' float32 StreamingProcessors within the model's bound of the
  port's float64 run (f32_bounds.stream_bounds, the counterpart of
  hold_f32 for the processor; JAX's XLA DFT ``any_order``), the two within
  the sum of their bounds; a missing WAV exits non-zero naming the path;
- both examples ask for the card unless given ``--device cpu``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.config import DFTParams as JDFTParams
from auditory_tpu.config import GaborSet as JGaborSet
from auditory_tpu.config import MelParams as JMelParams
from auditory_tpu.config import WindowParams as JWindowParams
from auditory_tpu.config import default_gabor_specs as jdefault_gabor_specs
from auditory_tpu.pipeline.streaming import StreamingProcessor as JStreaming
from auditory_tpu_torch.examples import process_speech, serve_streams
from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav
from auditory_tpu_torch.utils import f32_bounds as fb
from tests.test_torch_online import assert_tier
from tests.test_torch_sndenv import hold_f32

CPU = torch.device("cpu")

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_ARGS = ("--streams", "4", "--seconds", "1.2", "--f16")


def _run(argv, module=True):
    cmd = ([sys.executable, "-m", f"auditory_tpu_torch.examples.{argv[0]}"]
           if module else [sys.executable, f"examples/{argv[0]}.py"])
    return subprocess.run(cmd + list(argv[1:]), capture_output=True, text=True,
                          timeout=300, cwd=REPO)


def _line(stdout, prefix):
    lines = [ln for ln in stdout.splitlines() if ln.startswith(prefix)]
    assert lines, stdout
    return lines[-1]


def test_serve_streams_prints_the_jax_examples_segments():
    port = _run(("serve_streams", "--device", "cpu", *SERVE_ARGS))
    assert port.returncode == 0, port.stderr[-2000:]
    assert "SERVE_OK" in port.stdout
    jax_run = _run(("serve_streams", "--cpu", *SERVE_ARGS), module=False)
    assert jax_run.returncode == 0, jax_run.stderr[-2000:]
    assert (_line(port.stdout, "streams:") == _line(jax_run.stdout, "streams:")
            == "streams: 4, segments emitted: 48 (12/stream)")


def _by_stream(served):
    """{(stream, segment): outputs} of one serving run."""
    return {(s, k): out for s, k, out in served.results}


def test_serve_streams_tiers_hold_the_offline_runs(capsys):
    argv = ["--device", "cpu", "--streams", "3", "--seconds", "0.8"]
    f32 = serve_streams.main(argv)
    f16 = serve_streams.main(argv + ["--f16"])
    assert "SERVE_OK" in capsys.readouterr().out
    cfg = serve_streams.example_cfg()
    env = at.SndEnv(cfg, serve_streams.SR, device=CPU)
    got = _by_stream(f32)
    for s, sig in enumerate(f32.signals):
        padded = env.pad(sig)
        n_seg = env.seg_cnt(len(padded))
        assert sorted(k for i, k in got if i == s) == list(range(n_seg))
        stacked = {key: np.stack([got[(s, k)][key] for k in range(n_seg)])[None]
                   for key in serve_streams.OUTPUTS}
        hold_f32({"served": stacked}, cfg, serve_streams.SR, padded[None],
                 np.array([len(padded)]))
    assert_tier(_by_stream(f16), got, "float16", None)


def _tone_mix_wav(path, sr=16000):
    """0.45 s of three tones, a 4-segment WAV."""
    t = np.arange(int(0.45 * sr)) / sr
    sig = sum(a * np.sin(2 * np.pi * f * t) for a, f in
              ((0.3, 600.0), (0.2, 2500.0), (0.1, 5200.0)))
    write_wav(str(path), float_to_wave(sig, sr))
    return str(path)


def test_process_speech_matches_the_jax_example(tmp_path, capsys):
    wav = _tone_mix_wav(tmp_path / "mix.wav")
    outs = process_speech.main([wav, "--device", "cpu"])
    port = capsys.readouterr().out
    jax_run = _run(("process_speech", wav), module=False)
    assert jax_run.returncode == 0, jax_run.stderr[-2000:]
    hottest = lambda stdout: [ln.split("hottest band ")[1].split(";")[0]
                              for ln in stdout.splitlines() if ln.startswith("segment ")]
    assert len(outs) == len(hottest(port)) >= 3
    assert hottest(port) == hottest(jax_run.stdout)

    w = load_wav(wav)
    sig, sr = w.sound_to_tensor(), w.sample_rate
    specs = dict(size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0)
    jsp = JStreaming(JWindowParams(), JDFTParams(), JMelParams(),
                     JGaborSet(specs=jdefault_gabor_specs(phases=(0.0, 1.5708)), **specs),
                     sr)
    sp64 = at.StreamingProcessor(
        at.WindowParams(), at.DFTParams(), at.MelParams(),
        at.GaborSet(specs=at.default_gabor_specs(phases=(0.0, 1.5708)), **specs),
        sr, dtype=torch.float64, device=CPU)
    jsp.load(sig)
    sp64.load(sig)
    for k, out in enumerate(outs):
        jout, ref = jsp.process_segment(), sp64.process_segment()
        got, want = out["mel_fbank_segment"], torch.as_tensor(
            np.array(jout["mel_fbank_segment"]))
        bounds = fb.stream_bounds(sp64, k)["mel_fbank_segment"]
        jbounds = fb.stream_bounds(sp64, k, any_order=True)["mel_fbank_segment"]
        assert fb.share(got, ref["mel_fbank_segment"], bounds) <= 1.0, k
        assert fb.share(want, ref["mel_fbank_segment"], jbounds) <= 1.0, k
        assert fb.share(got, want, bounds + jbounds) <= 1.0, k
    assert not jsp.more_segments and not sp64.more_segments


def test_process_speech_refuses_a_missing_wav(tmp_path):
    missing = str(tmp_path / "missing.wav")
    out = _run(("process_speech", missing, "--device", "cpu"))
    assert out.returncode != 0
    assert missing in out.stderr


@pytest.mark.parametrize("example", ["serve_streams", "process_speech"])
def test_examples_default_to_the_card(example, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--streams", "1", "--seconds", "0.2"] if example == "serve_streams"
            else [_tone_mix_wav(tmp_path / "mix.wav")])
    with pytest.raises(RuntimeError, match="device cuda requested"):
        {"serve_streams": serve_streams, "process_speech": process_speech}[
            example].main(argv)
