"""Gradients through the port: the fused frontend's autograd Function
against ``torch.autograd.gradcheck`` (float64), the whole SndEnv against
``jax.grad`` of the JAX package from the same numpy inputs (the contracts of
tests/test_grad.py), the routing of a tensor that needs a gradient, and the
precision tier the backward runs under."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.config import KWTAParams
from auditory_tpu.dsp.design import gabor_filters
from auditory_tpu.dsp.gabor import convolve as jconvolve
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu_torch import config as tcfg
from auditory_tpu_torch.convert import constants_from_numpy
from auditory_tpu_torch.dsp import design
from auditory_tpu_torch.dsp.gabor import convolve
from auditory_tpu_torch.ops import framefft
from tests.conftest import default_cfg_2d, tone

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000
# float64 on both sides, matmul basis against JAX's FFT frontend: the two
# gradients differ by float64 rounding only
F64 = dict(rtol=1e-7, atol_share=1e-10)
# gabor_raw is float32 by contract on both sides, so the gabor loss's
# cotangent 2*gabor_raw is float32: one float32 ulp (6e-8 relative) of
# difference in an activation reaches the gradient
GABOR = dict(rtol=1e-5, atol_share=1e-6)
# the kWTA settle runs in float32 (16 iterations) on both sides
KWTA = dict(rtol=1e-3, atol_share=1e-4)


def _assert_grad_close(got, ref, rtol, atol_share):
    """|got - ref| <= atol_share * max|ref| + rtol * |ref|, everywhere."""
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got)) and np.max(np.abs(ref)) > 0
    np.testing.assert_allclose(
        got, ref, rtol=rtol, atol=atol_share * float(np.max(np.abs(ref)))
    )


def _signal(dur=0.35, seed=3):
    sig = tone(1200.0, dur, SR, amp=0.4).astype(np.float64)
    r = np.random.default_rng(seed)
    return sig + 0.02 * r.standard_normal(sig.shape)


# ------------------------------------------------------------------ gradcheck

def _small_frontend(n_filters=4, win=16, sr=400):
    """A 16-sample window with 4 mel bands, its constants unpadded (the
    wrapper takes any k_pad >= n_bins), so gradcheck perturbs few entries."""
    fb = tcfg.FilterBank(n_filters=n_filters, lo_hz=0.0, hi_hz=sr / 2)
    mel = design.mel_design(fb, win, sr)
    cos_m, sin_m = design.dft_matrices(win)
    consts = [torch.tensor(np.ascontiguousarray(a), requires_grad=True)
              for a in (cos_m, sin_m, mel.weights.T)]
    return fb, consts, win // 2 + 1


@pytest.mark.parametrize("emit", [(True, True), (True, False), (False, True),
                                  (False, False)],
                         ids=["both", "power", "logp", "mel_only"])
@pytest.mark.parametrize("grid", [(-7, 9), (3, 10)],
                         ids=["offset_negative", "past_the_end"])
def test_function_gradcheck_float64(emit, grid):
    """The hand-written backward against finite differences (gradcheck's
    default tolerances, float64), w.r.t. the signals and all three
    constants; a window grid that starts left of sample 0, and one that runs
    past the buffer's end (offset 3 + 9 steps of 6 + 16 > 50)."""
    fb, consts, n_bins = _small_frontend()
    offset0, n_windows = grid
    sig = torch.tensor(np.random.default_rng(5).standard_normal((2, 50)),
                       requires_grad=True)

    def fn(s, c, si, m):
        outs = framefft.fused_frame_power_mel(
            s, 6, offset0, n_windows, c, si, m, n_bins=n_bins, n_mel=4,
            dft=tcfg.DFTParams(), fbank=fb, emit=emit,
        )
        assert [o is None for o in outs[:2]] == [not e for e in emit]
        return tuple(o for o in outs if o is not None)

    assert torch.autograd.gradcheck(fn, (sig, *consts))


def test_function_gradcheck_zero_windows_and_no_log_power():
    """The ``== 0`` floors take no gradient (all-zero windows at the signal
    head) and ``comp_log_pow=False`` contributes nothing."""
    fb, consts, n_bins = _small_frontend()
    sig = np.random.default_rng(6).standard_normal((1, 60))
    sig[:, :30] = 0.0
    sig = torch.tensor(sig, requires_grad=True)
    dft = tcfg.DFTParams(comp_log_pow=False)

    def fn(s):
        return framefft.fused_frame_power_mel(
            s, 6, -20, 8, *consts, n_bins=n_bins, n_mel=4, dft=dft, fbank=fb,
        )

    assert torch.autograd.gradcheck(fn, (sig,))
    power, logp, mel = fn(sig)
    assert torch.equal(logp, torch.zeros_like(logp))
    assert (mel[0, 0] == fb.log_min).all()  # a zero window floors
    g, = torch.autograd.grad(logp.sum() + mel[0, 0].sum(), sig)
    assert torch.equal(g, torch.zeros_like(g))


def test_overlap_add_is_the_gather_adjoint():
    """<gather(x), y> == <x, overlap_add(y)> for a grid with both edges
    outside the signal, and two calls give the same bits."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((3, 70)))
    y = torch.tensor(rng.standard_normal((3, 12, 16)))
    starts = -9 + 7 * torch.arange(12)
    from auditory_tpu_torch.dsp.frame import extract_windows

    lhs = (extract_windows(x, starts, 16) * y).sum()
    back = framefft.overlap_add(y, 7, -9, 70)
    torch.testing.assert_close((x * back).sum(), lhs, rtol=1e-12, atol=0)
    assert torch.equal(back, framefft.overlap_add(y, 7, -9, 70))


def test_nan_mel_weights_give_nan_gradient():
    """A mel bank with NaN triangles: NaN in the forward is NaN in the
    gradient, as autodiff of the plain version gives."""
    fb = tcfg.FilterBank(n_filters=80, lo_hz=0.0, hi_hz=4000.0)
    t = tcfg.WindowParams().derive(8000)
    mel = design.mel_design(fb, t.win_samples, 8000)
    assert np.isnan(mel.weights).any()
    c = constants_from_numpy(mel.weights, np.eye(1), np.zeros((1, 1, 1)),
                             *design.dft_matrices(t.win_samples))
    k = [torch.as_tensor(c[n]) for n in ("dft_cos", "dft_sin", "mel_w")]
    sig = np.random.default_rng(4).standard_normal((1, 2000))
    args = (t.step_samples, -160, 10, *k)
    kw = dict(n_bins=t.n_bins, n_mel=80, dft=tcfg.DFTParams(), fbank=fb)
    grads = []
    for fn in (framefft.fused_frame_power_mel,
               framefft.fused_frame_power_mel_reference):
        s = torch.tensor(sig, requires_grad=True)
        mel_out = fn(s, *args, **kw)[2]
        g, = torch.autograd.grad(mel_out.sum(), s)
        grads.append(g.numpy())
    np.testing.assert_array_equal(np.isnan(grads[0]), np.isnan(grads[1]))
    assert np.isnan(grads[0]).any()


# ------------------------------------------------------------ SndEnv vs jax

def _both_envs(cfg, sig):
    jenv = JaxSndEnv(cfg, SR, dtype=jnp.float64)
    tenv = at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    n = sig.shape[-1]
    return jenv.process_fn(n, 0), jnp.asarray([n]), tenv, torch.tensor([n])


def _jax_grad(fn, lens, sig, loss):
    return np.asarray(jax.grad(
        lambda s: loss(fn(s[None], lens)[0])
    )(jnp.asarray(sig)))


def _torch_grad(env, lens, sig, loss):
    s = torch.tensor(sig[None], requires_grad=True)
    with at.precision_tier(env.matmul_precision):
        out, _ = env(s, lens)
        loss(out).backward()
    return s.grad[0].numpy()


def _mel_loss(out):
    return (out.mel_fbank_segment ** 2).sum()


def _mel_gabor_loss(out):
    return _mel_loss(out) + (out.gabor_raw ** 2).sum()


@pytest.mark.parametrize("loss,bounds", [(_mel_loss, F64),
                                         (_mel_gabor_loss, GABOR)],
                         ids=["mel", "mel_gabor"])
def test_signal_grad_matches_jax(loss, bounds):
    cfg = default_cfg_2d()
    sig = at.SndEnv(cfg, SR, device=CPU).pad(_signal())
    fn, jl, tenv, tl = _both_envs(cfg, sig)
    _assert_grad_close(_torch_grad(tenv, tl, sig, loss),
                       _jax_grad(fn, jl, sig, loss), **bounds)


def test_signal_grad_kwta_on_matches_jax():
    """Through the 16-iteration FFFB/XX1 settle (amax ties, clamps and the
    Chebyshev band), finite and equal to jax.grad."""
    cfg = default_cfg_2d(kwta=KWTAParams(on=True))
    sig = at.SndEnv(cfg, SR, device=CPU).pad(_signal())
    fn, jl, tenv, tl = _both_envs(cfg, sig)
    loss = lambda out: (out.gabor_kwta ** 2).sum()
    _assert_grad_close(_torch_grad(tenv, tl, sig, loss),
                       _jax_grad(fn, jl, sig, loss), **KWTA)


def test_signal_grad_masked_steps_stay_finite():
    """A true length short of the buffer: the steps past it are masked with
    where, so their NaN-free zeros give a finite gradient that vanishes past
    the last valid window."""
    cfg = default_cfg_2d(kwta=KWTAParams(on=True))
    sig = at.SndEnv(cfg, SR, device=CPU).pad(_signal())
    env = at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    n_true = sig.shape[-1] - 2500
    s = torch.tensor(sig[None], requires_grad=True)
    out, _ = env(s, torch.tensor([n_true]))
    (_mel_gabor_loss(out) + (out.gabor_kwta ** 2).sum()).backward()
    g = s.grad[0].numpy()
    assert np.all(np.isfinite(g)) and np.abs(g[:n_true]).max() > 0
    assert np.all(g[n_true:] == 0)


def test_gabor_parameter_grad_matches_jax():
    """The gabor bank swapped for an nn.Parameter takes the gradient of the
    gabor loss, equal to jax.grad of the JAX convolve over the JAX
    pipeline's mel (the learnable-frontend path)."""
    cfg = default_cfg_2d()
    sig = at.SndEnv(cfg, SR, device=CPU).pad(_signal())
    fn, jl, tenv, tl = _both_envs(cfg, sig)
    tenv.gabor = torch.nn.Parameter(tenv.gabor.clone())
    out, _ = tenv(torch.tensor(sig[None]), tl)
    (out.gabor_raw ** 2).sum().backward()
    mel = fn(jnp.asarray(sig)[None], jl)[0].mel_fbank_segment
    filters = jnp.asarray(gabor_filters(cfg.gabor), dtype=jnp.float64)
    ref = jax.grad(lambda f: jnp.sum(jconvolve(mel, f, cfg.gabor) ** 2))(filters)
    _assert_grad_close(tenv.gabor.grad.numpy(), np.asarray(ref), **GABOR)


def test_convolve_filter_grad_matches_jax():
    """tests/test_grad.py::test_grad_wrt_gabor_filters on the port's
    convolve, against jax.grad on the same numpy inputs."""
    gset = default_cfg_2d().gabor
    filters = gabor_filters(gset)
    mel_seg = np.random.default_rng(11).standard_normal((2, 32, 24))
    ref = jax.grad(lambda f: jnp.sum(jconvolve(jnp.asarray(mel_seg), f, gset) ** 2))(
        jnp.asarray(filters))
    f = torch.tensor(filters, requires_grad=True)
    (convolve(torch.tensor(mel_seg), f, gset) ** 2).sum().backward()
    _assert_grad_close(f.grad.numpy(), np.asarray(ref), **GABOR)


def test_batched_rows_give_their_own_gradients():
    """tests/test_grad.py::test_grad_jit_vmap_compose: a batch of two rows
    gives each row the gradient of its own single-row run."""
    cfg = default_cfg_2d()
    env = at.SndEnv(cfg, SR, dtype=torch.float64, device=CPU)
    sig = env.pad(_signal(dur=0.25))
    n = sig.shape[-1]
    rows = np.stack([sig, 0.5 * sig])
    s = torch.tensor(rows, requires_grad=True)
    _mel_loss(env(s, torch.tensor([n, n]))[0]).backward()
    for i in range(2):
        one = _torch_grad(env, torch.tensor([n]), rows[i], _mel_loss)
        np.testing.assert_allclose(s.grad[i].numpy(), one, rtol=1e-12,
                                   atol=1e-12 * np.abs(one).max())
    assert (s.grad[0] - s.grad[1]).abs().max() > 0


# --------------------------------------------------------- routing and tier

def test_non_cpu_tensor_needing_grad_launches_the_kernel(monkeypatch):
    """A tensor off the CPU that needs a gradient goes to the kernel's
    launch, never to the plain version (meta tensors stand in for CUDA
    tensors here)."""
    calls = []

    def fake_launch(signals, *args, **kw):
        calls.append("kernel")
        b, n = signals.shape[0], args[2]
        new = lambda k: torch.empty((b, n, k), device=signals.device)
        return new(kw["n_bins"]), new(kw["n_bins"]), new(kw["n_mel"])

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(framefft, "_launch", fake_launch)
    monkeypatch.setattr(framefft, "fused_frame_power_mel_reference", no_plain)
    fb, consts, n_bins = _small_frontend()
    meta = [torch.empty(c.shape, device="meta", dtype=torch.float32)
            for c in consts]
    sig = torch.empty((2, 50), device="meta", requires_grad=True)
    out = framefft.fused_frame_power_mel(
        sig, 6, 0, 5, *meta, n_bins=n_bins, n_mel=4, dft=tcfg.DFTParams(),
        fbank=fb,
    )
    assert calls == ["kernel"] and out[2].requires_grad


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_function_backward_reenters_the_forward_tier(tf32_on, monkeypatch):
    """A forward inside 'highest' has its backward run with TF32 off even
    when backward() is called outside any tier, and the flags are restored
    after it."""
    seen = []
    real = framefft.fused_frame_power_mel_backward

    def spy(*args, **kw):
        seen.append(_flags())
        return real(*args, **kw)

    monkeypatch.setattr(framefft, "fused_frame_power_mel_backward", spy)
    fb, consts, n_bins = _small_frontend()
    sig = torch.randn(2, 50, dtype=torch.float64, requires_grad=True)
    with at.precision_tier("highest"):
        mel = framefft.fused_frame_power_mel(
            sig, 6, 0, 5, *consts, n_bins=n_bins, n_mel=4,
            dft=tcfg.DFTParams(), fbank=fb,
        )[2]
    mel.sum().backward()
    assert seen == [(False, False)] and _flags() == (True, True)


def test_sndenv_backward_sees_the_highest_tier(tf32_on):
    """``backward()`` inside ``precision_tier(env.matmul_precision)``: every
    backward node, the gabor convolution's included, sees TF32 off."""
    cfg = default_cfg_2d()
    env = at.SndEnv(cfg, SR, device=CPU)
    assert env.matmul_precision == "highest"
    sig = env.pad(_signal(dur=0.2)).astype(np.float32)
    s = torch.tensor(sig[None], requires_grad=True)
    out, _ = env(s, torch.tensor([sig.shape[-1]]))
    assert _flags() == (True, True)  # forward restored the flags
    seen = []
    for t in (out.gabor_raw, out.mel_fbank_segment, s):
        t.register_hook(lambda g: seen.append(_flags()))
    with at.precision_tier(env.matmul_precision):
        ((out.gabor_raw ** 2).sum() + out.mel_fbank_segment.sum()).backward()
    assert seen == [(False, False)] * 3
    assert _flags() == (True, True)
    assert torch.isfinite(s.grad).all() and s.grad.abs().max() > 0


def test_renorm_and_float32_grads_are_finite():
    """The renorm clamp (a caller-side op after the kernel) and a float32
    env differentiate too."""
    cfg = default_cfg_2d()
    cfg = dataclasses.replace(cfg, mel=dataclasses.replace(
        cfg.mel, fbank=dataclasses.replace(cfg.mel.fbank,
                                           renorm_after_init=True)))
    env = at.SndEnv(cfg, SR, device=CPU)
    sig = env.pad(_signal(dur=0.2)).astype(np.float32)
    s = torch.tensor(sig[None], requires_grad=True)
    out, _ = env(s, torch.tensor([sig.shape[-1]]))
    _mel_gabor_loss(out).backward()
    assert torch.isfinite(s.grad).all() and s.grad.abs().max() > 0
