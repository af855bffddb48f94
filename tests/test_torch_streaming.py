"""The port's processspeech StreamingProcessor against the JAX package's
(CPU, float64; JAX with spectrum_method="fft", the port with its float64
DFT matmul): multi-stride offsets, the segment cursor, the per-channel
layouts.

Tolerances: spectra, mel and MFCC within atol=1e-9 and rtol=1e-9
(tests/test_streaming.py's 1e-9; the relative part covers DFT power up to
~1e4, where an FFT and a matmul differ by ~1e-12 relative); gabor within
atol=1e-5 (both convolve in float32); the float32 runs within the float32
error model's bound (auditory_tpu_torch/utils/f32_bounds.py).

``test_segment_axis_sharding_long_utterance`` has no counterpart here: it
waits for the segment-axis parallelism of ROADMAP item 11."""

import jax.numpy as jnp
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
from auditory_tpu_torch.convert import constants_from_numpy
from auditory_tpu_torch.dsp import design
from tests.conftest import default_cfg_2d, tone

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000
SPEC = dict(rtol=1e-9, atol=1e-9)
GABOR = dict(rtol=0.0, atol=1e-5)


def gset():
    return dict(size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0)


def make_pair(wparams=None, channels=1, window_fn=None):
    """The port's processor (float64) and JAX's (float64, fft) on the same
    parameters."""
    wp = wparams or {}
    port = at.StreamingProcessor(
        at.WindowParams(**wp), at.DFTParams(window_fn=window_fn),
        at.MelParams(),
        at.GaborSet(specs=at.default_gabor_specs(phases=(0.0, 1.5708)), **gset()),
        SR, channels=channels, dtype=torch.float64, device=CPU,
    )
    jax_sp = JStreaming(
        JWindowParams(**wp), JDFTParams(window_fn=window_fn), JMelParams(),
        JGaborSet(specs=jdefault_gabor_specs(phases=(0.0, 1.5708)), **gset()),
        SR, channels=channels, dtype=jnp.float64, spectrum_method="fft",
    )
    return port, jax_sp


def assert_outputs(got, ref, label=""):
    assert set(got) == set(ref), label
    for key, r in ref.items():
        g = got[key]
        assert (g is None) == (r is None), key
        if r is None:
            continue
        a, b = g.numpy(), np.asarray(r)
        assert a.shape == b.shape, (label, key, a.shape, b.shape)
        if key == "step_valid":
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {key}")
        else:
            np.testing.assert_allclose(
                a, b, err_msg=f"{label} {key}",
                **(GABOR if key == "gabor" else SPEC),
            )


def run_cursor(sp, limit=40):
    outs = []
    while sp.more_segments and len(outs) < limit:
        outs.append(sp.process_segment())
    return outs


def test_multistride_offsets():
    port, jax_sp = make_pair()
    # processspeech.go:276-282: strides=1, stepsPerStride=10 ->
    # stepsBack = 10*0 + 2 = 2, SndEnv's BorderSteps at the default geometry
    assert port.steps_back == jax_sp.steps_back == 2
    np.testing.assert_array_equal(port.step_offsets, jax_sp.step_offsets)
    # 300 ms segment, 100 ms stride: strides=3 -> stepsBack = 10*2+2 = 22
    port3, jax3 = make_pair(dict(segment_ms=300.0))
    assert port3.steps_back == jax3.steps_back == 22
    assert port3.step_offsets[0] == -22 * port3.timing.step_samples
    np.testing.assert_array_equal(port3.step_offsets, jax3.step_offsets)


@pytest.mark.parametrize("wparams", [None, dict(segment_ms=300.0)],
                         ids=["default", "steps_back22"])
def test_every_segment_matches_jax(wparams):
    """Every segment of the cursor, all outputs, against JAX; the cursor
    stops after the same segment in both."""
    port, jax_sp = make_pair(wparams)
    sig = tone(900.0, 0.95, SR) + tone(2345.0, 0.95, SR, amp=0.2)
    port.load(sig)
    jax_sp.load(sig)
    got, ref = run_cursor(port), run_cursor(jax_sp)
    assert len(got) == len(ref) >= 3
    assert port.segment == jax_sp.segment
    for k, (g, r) in enumerate(zip(got, ref)):
        assert_outputs(g, r, f"segment {k}")


def test_cursor_count_stop_and_restart():
    port, jax_sp = make_pair()
    sig = tone(900.0, 0.55, SR)
    port.load(sig)
    jax_sp.load(sig)
    # 0.55 s = 8800 samples, segments advance by segment_samples=1600; the
    # remaining-check stops after segment k where 8800 - 1600(k+1) < 1600
    # -> 5 segments (tests/test_streaming.py)
    got = run_cursor(port, limit=20)
    assert port.signal.shape[-1] == 8800
    assert len(got) == len(run_cursor(jax_sp, limit=20)) == 5
    assert not port.more_segments
    # the cursor restarts like the reference (processspeech.go:333-335)
    again = port.process_segment()
    j_again = jax_sp.process_segment()
    assert port.segment == jax_sp.segment == 0
    assert port.more_segments == jax_sp.more_segments
    assert_outputs(again, j_again, "restart")
    assert_outputs(again, got[0], "restart vs first pass")


def test_shapes_and_reference_layout():
    port, _ = make_pair()
    port.load(tone(1200.0, 0.3, SR))
    out = port.process_segment()
    nb, steps = port.timing.n_bins, port.timing.segment_steps
    assert tuple(out["power_segment"].shape) == (nb, steps, 1)
    assert tuple(out["log_power_segment"].shape) == (nb, steps, 1)
    assert tuple(out["mel_fbank_segment"].shape) == (32, steps, 1)
    assert tuple(out["mfcc_segment"].shape) == (32, steps, 1)  # n_filters
    # 5-D gabor layout [ch, y, x, 2, nf] (processspeech.go:265)
    g = out["gabor"]
    assert g.ndim == 5 and g.shape[0] == 1 and g.shape[3] == 2
    assert tuple(out["step_valid"].shape) == (steps,)


def test_first_segment_matches_sndenv():
    """At the default geometry (strides=1) the streaming offsets equal
    SndEnv's, and segment 0 starts at 0 in both: identical power and mel."""
    port, _ = make_pair()
    env = at.SndEnv(default_cfg_2d(), SR, dtype=torch.float64, device=CPU)
    sig = env.pad(tone(750.0, 0.35, SR))
    port.load(sig, pad=False)
    s_out = port.process_segment()
    e_out = env.process(sig)
    np.testing.assert_allclose(s_out["power_segment"][:, :, 0].numpy(),
                               e_out.power_segment[0].numpy(), **SPEC)
    np.testing.assert_allclose(s_out["mel_fbank_segment"][:, :, 0].numpy(),
                               e_out.mel_fbank_segment[0].numpy(), **SPEC)


def test_stereo_channels_match_jax():
    port, jax_sp = make_pair(channels=2)
    sig = np.stack([tone(500.0, 0.45, SR), tone(2000.0, 0.45, SR)])
    port.load(sig)
    jax_sp.load(sig)
    got, ref = run_cursor(port), run_cursor(jax_sp)
    assert len(got) == len(ref) >= 2
    for k, (g, r) in enumerate(zip(got, ref)):
        assert_outputs(g, r, f"segment {k}")
    mel = got[0]["mel_fbank_segment"].numpy()  # [32, steps, 2]
    # channel 0 (500 Hz) peaks in a lower band than channel 1 (2 kHz)
    assert np.argmax(mel[:, 4, 0]) < np.argmax(mel[:, 4, 1])
    with pytest.raises(ValueError, match="channels"):
        port.load(sig[:1])


def test_overrun_stops_the_cursor():
    """A signal long enough for segment 0 whose forward windows overrun:
    step_valid marks them, and more_segments goes False
    (processspeech.go:340-345)."""
    port, jax_sp = make_pair()
    t = port.timing
    last_end = (t.segment_steps - 1 - port.steps_back) * t.step_samples + t.win_samples
    n = t.segment_samples + (last_end - t.segment_samples) // 2
    sig = tone(700.0, n / SR, SR)[:n]
    port.load(sig, pad=False)
    jax_sp.load(sig, pad=False)
    out, ref = port.process_segment(), jax_sp.process_segment()
    sv = out["step_valid"].numpy()
    assert sv.shape == (t.segment_steps,) and not sv.all()
    assert not port.more_segments and not jax_sp.more_segments
    assert_outputs(out, ref)


def test_load_pad_default_is_reference_faithful():
    """The reference discards Pad's return value (processspeech.go:319), so
    load() does not pad by default; pad=True opts in, as in JAX."""
    port, jax_sp = make_pair()
    sig = tone(600.0, 0.31, SR)
    port.load(sig)
    assert port.signal.shape[-1] == len(sig)
    port.load(sig, pad=True)
    jax_sp.load(sig, pad=True)
    assert port.signal.shape[-1] == jax_sp.signal.shape[-1] > len(sig)
    assert_outputs(port.process_segment(), jax_sp.process_segment(), "padded")
    with pytest.raises(RuntimeError, match="load"):
        make_pair()[0].process_segment()


def test_hamming_window_and_constants_carried_across():
    """The analysis window folds into the port's basis as JAX applies it on
    its FFT path; a perturbed gabor bank loaded with load_constants (the
    SndEnv buffers) computes what JAX computes with the same bank."""
    port, jax_sp = make_pair(window_fn="hamming")
    rng = np.random.default_rng(5)
    bank = jax_sp.gabor_bank + 0.05 * rng.standard_normal(jax_sp.gabor_bank.shape)
    jax_sp.gabor_bank = bank
    port.load_constants(constants_from_numpy(
        port.mel_des.weights, port.dct_mat, bank,
        *design.dft_matrices(port.timing.win_samples), port.analysis_win,
    ))
    assert {n for n, _ in port.named_buffers()} >= {
        "dft_cos", "dft_sin", "mel_w", "dct", "gabor"}
    sig = tone(1500.0, 0.5, SR)
    port.load(sig)
    jax_sp.load(sig)
    got, ref = run_cursor(port), run_cursor(jax_sp)
    assert len(got) == len(ref) >= 2
    for k, (g, r) in enumerate(zip(got, ref)):
        assert_outputs(g, r, f"segment {k}")


def test_float32_matches_jax_float32():
    """float32 (the card's dtype) and JAX's float32 matmul path, each
    within the float32 error model's bound of the port's float64 run of the
    same segment (auditory_tpu_torch/utils/f32_bounds.py), and of each
    other within the sum of their bounds."""
    from auditory_tpu_torch.utils import f32_bounds as fb

    specs = at.default_gabor_specs(phases=(0.0, 1.5708))
    ports = [at.StreamingProcessor(at.WindowParams(), at.DFTParams(),
                                   at.MelParams(), at.GaborSet(specs=specs, **gset()),
                                   SR, dtype=dt, device=CPU)
             for dt in (torch.float32, torch.float64)]
    jax_sp = JStreaming(JWindowParams(), JDFTParams(), JMelParams(),
                        JGaborSet(specs=jdefault_gabor_specs(phases=(0.0, 1.5708)),
                                  **gset()), SR)
    sig = tone(900.0, 0.45, SR).astype(np.float32)
    for sp in (*ports, jax_sp):
        sp.load(sig)
    keys = ("power_segment", "log_power_segment", "mel_fbank_segment",
            "mfcc_segment", "gabor")
    runs = [run_cursor(sp) for sp in (*ports, jax_sp)]
    assert len(runs[0]) == len(runs[1]) == len(runs[2]) >= 2
    for k, (g, ref, r) in enumerate(zip(*runs)):
        np.testing.assert_array_equal(g["step_valid"].numpy(),
                                      np.asarray(r["step_valid"]))
        # JAX's StreamingProcessor sums the DFT in XLA, in an order the
        # model does not know
        bounds = fb.stream_bounds(ports[1], k)
        jbounds = fb.stream_bounds(ports[1], k, any_order=True)
        for key in keys:
            got, want = g[key], torch.as_tensor(np.array(r[key]))
            assert fb.share(got, ref[key], bounds[key]) <= 1.0, (k, key)
            assert fb.share(want, ref[key], jbounds[key]) <= 1.0, (k, key)
            assert fb.share(got, want, bounds[key] + jbounds[key]) <= 1.0, (k, key)
