"""The frontend's precision grades (``passes`` 1, 3 and 6, JAX's
``pallas_passes``) in the plain version against the JAX kernel and the JAX
pipeline; the kernel's basis packing; exact zeros and NaN at every grade;
and the entry points' default device (the card, or a raise)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.config import DFTParams
from auditory_tpu.dsp.dft import power_spectrum_conv
from auditory_tpu.dsp.mel import apply_mel as japply_mel
from auditory_tpu.ops import framefft as jfft
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu_torch import config as tcfg
from auditory_tpu_torch.ops import framefft
from tests.conftest import default_cfg_2d, tone
from tests.test_torch_framefft import BOUNDS, GEOMETRIES, _assert_close, _case, _port

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000
# per DFT term, the relative error a grade may add to |x_n c_n| (|c| <= 1):
# bf16-rounded operands at 1 pass (2^-9 for each of the two), the dropped
# limb products at 3 (x1 c1 and the third limbs, below 2^-15)
BF16_U = 2.0**-8
HILO_U = 2.0**-15


def _port_passes(c, passes, fn=framefft.fused_frame_power_mel):
    return _port(c, lambda *a, **kw: fn(*a, **kw, passes=passes))


def _grade_bounds(c, power, u):
    """The bounds a grade of unit ``u`` per term allows around the float32
    ``power`` [B, n, n_bins] of case ``c``: per window d = u * sum |x|,
    power within 2 sqrt(2 p) d + 2 d^2, log power within that over
    p + LogOffSet, log mel within W |dp| over the mel sum (and NaN where a
    weight is NaN)."""
    t = c["t"]
    sig = c["sig"].astype(np.float64)
    starts = c["offset0"] + t.step_samples * np.arange(c["n_windows"])
    idx = starts[:, None] + np.arange(t.win_samples)
    inside = (idx >= 0) & (idx < sig.shape[-1])
    x = np.where(inside, sig[:, np.clip(idx, 0, sig.shape[-1] - 1)], 0.0)
    d = u * np.abs(x).sum(-1)[..., None]
    p = np.asarray(power, np.float64)
    bp = 2 * np.sqrt(2 * p) * d + 2 * d * d
    w = np.asarray(c["mel"].weights, np.float64).T  # [n_bins, n_mel]
    msum = p @ w
    dm = bp @ np.abs(w)
    lp = bp / np.maximum(p + DFTParams().log_offset - bp, 1e-30)
    lm = dm / np.maximum(msum + c["fb"].log_off - dm, 1e-30)
    return bp, lp, np.where(np.isnan(lm), np.inf, lm)


def _assert_within(got, ref, bounds):
    """``got`` against ``ref`` within ``bounds`` plus the float32 BOUNDS,
    NaN positions equal; returns whether any element left BOUNDS alone."""
    moved = False
    for g, r, gb, b in zip(got, ref, bounds, BOUNDS):
        assert (g is None) == (r is None)
        if g is None:
            continue
        g, r = g.numpy().astype(np.float64), np.asarray(r, np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        err = np.nan_to_num(np.abs(g - r))
        tight = b["atol"] + b["rtol"] * np.abs(np.nan_to_num(r))
        assert np.all(err <= gb + tight)
        moved |= bool(np.any(err > tight))
    return moved


def test_limb_split_exact():
    """Port of tests/test_pallas.py::test_limb_split_exact: three bf16 limbs
    reconstruct float32 exactly, two to ~2^-16."""
    from auditory_tpu.ops.framefft import _split_limbs

    r = np.random.default_rng(0)
    x_np = (r.standard_normal(4096) * np.exp(r.uniform(-20, 20, 4096))).astype(np.float32)
    x = torch.as_tensor(x_np)
    l3 = framefft.split_limbs(x, 3)
    assert all(t.dtype == torch.bfloat16 for t in l3)
    recon = l3[0].float() + l3[1].float() + l3[2].float()
    assert torch.equal(recon, x)
    l2 = framefft.split_limbs(x, 2)
    rel = ((l2[0].float() + l2[1].float() - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0**-16
    # the same limbs as JAX's split
    for a, b in zip(l3, _split_limbs(jnp.asarray(x_np), 3)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("passes,n", [(1, 1), (3, 2), (6, 3)])
def test_limb_terms_follow_jax(passes, n):
    """The products and their order are JAX's _limb_dot's: i + j < n,
    sorted by (i + j, i, j) descending."""
    assert framefft.n_limbs(passes) == n
    terms = framefft.limb_terms(n)
    assert len(terms) == passes
    keys = [(i + j, i, j) for i, j in terms]
    assert keys == sorted(keys, reverse=True)
    assert all(i + j < n for i, j in terms)


@pytest.mark.parametrize("passes", [3, 6])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_version_matches_pallas_masked_at_passes(name, passes):
    """The plain version's limb emulation against JAX's kernel in interpret
    mode at the same grade (interpret mode casts the limbs to bf16 literally
    at 3 and 6 passes)."""
    c = _case(name)
    t, fb = c["t"], c["fb"]
    cos_p, sin_p, w_p = jfft.pad_basis(*c["basis"], c["mel"].weights)
    ref = jfft.fused_frame_power_mel(
        jnp.asarray(c["sig"]), t.step_samples, c["offset0"], c["n_windows"],
        jnp.asarray(cos_p), jnp.asarray(sin_p), jnp.asarray(w_p),
        win=t.win_samples, n_bins=t.n_bins, n_mel=fb.n_filters,
        dft=DFTParams(), fbank=fb, interpret=True, passes=passes,
        mode="masked", window=c["awin"], emit=c["emit"],
    )
    got = _port_passes(c, passes)
    if passes == 6:
        _assert_close(got, ref)
        return
    # 3 passes: each side is within the grade of the exact product, but
    # masked mode multiplies a phase-rotated basis (rows m mod win from the
    # window's start residue), whose limbs round elsewhere, and JAX's mel
    # sum also runs on limbs (the port's is float32): the two are held
    # within twice the grade's bound, the mel with one more 2^-15 of its sum
    power = _port(dict(c, emit=(True, True)))[0].numpy()  # exact grade
    bp, lp, lm = _grade_bounds(c, power, HILO_U)
    _assert_within(got, ref, (2 * bp, 2 * lp, 2 * lm + HILO_U))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_version_one_pass_within_bf16_grade_of_xla(name):
    """At 1 pass the plain version rounds both operands to bf16, as the
    card's single product does, so it is held against JAX's float32 XLA
    frontend within that grade's bound (a per-window u = 2^-8 relative to
    sum |x| per term). JAX's interpret mode does not round operands at 1 pass
    (tests/test_pallas.py:111-114), so it is no reference here."""
    c = _case(name)
    t, fb = c["t"], c["fb"]
    cos_m, sin_m = c["basis"]
    if c["awin"] is not None:
        cos_m, sin_m = cos_m * c["awin"][:, None], sin_m * c["awin"][:, None]
    power = np.asarray(power_spectrum_conv(
        jnp.asarray(c["sig"]),
        (jnp.asarray(cos_m, jnp.float32), jnp.asarray(sin_m, jnp.float32)),
        t.step_samples, c["offset0"], c["n_windows"],
    ))
    mel = np.asarray(japply_mel(jnp.asarray(power),
                                jnp.asarray(c["mel"].weights, jnp.float32), fb))
    logp = np.log(power + DFTParams().log_offset)
    got = _port_passes(c, 1)
    emit = c["emit"]
    ref = (power if emit[0] else None, logp if emit[1] else None, mel)
    # the grade is real: 1 pass leaves float32's bounds somewhere
    assert _assert_within(got, ref, _grade_bounds(c, power, BF16_U))


@pytest.mark.parametrize("passes,atol", [(3, 5e-3), (6, 2e-4)])
def test_sndenv_kernel_passes_matches_jax_pallas_passes(passes, atol):
    """SndEnv(kernel_passes=p) on the CPU against JAX's SndEnv(use_pallas=
    True, pallas_passes=p) in interpret mode, at the tolerances of
    tests/test_pallas.py::test_pallas_passes_variants."""
    cfg = default_cfg_2d()
    jenv = JaxSndEnv(cfg, SR, dtype=jnp.float32, spectrum_method="matmul",
                     use_pallas=True, pallas_passes=passes)
    tenv = at.SndEnv(cfg, SR, kernel_passes=passes, device=CPU)
    sig = tenv.pad(tone(987.0, 0.25, SR)).astype(np.float32)
    j, t = jenv.process(sig), tenv.process(sig)
    np.testing.assert_allclose(t.mel_fbank_segment.numpy(),
                               np.asarray(j.mel_fbank_segment), rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(t.step_valid.numpy(), np.asarray(j.step_valid))


def test_sndenv_one_pass_within_bf16_grade_of_jax():
    """SndEnv(kernel_passes=1) against JAX's pallas_passes=1, which does not
    round operands in interpret mode: power within the bf16 grade's bound
    with d = 2^-8 * win * max |x| for every window, and the mel within the
    bound that implies through the filter bank."""
    cfg = default_cfg_2d()
    jenv = JaxSndEnv(cfg, SR, dtype=jnp.float32, spectrum_method="matmul",
                     use_pallas=True, pallas_passes=1)
    tenv = at.SndEnv(cfg, SR, kernel_passes=1, device=CPU)
    sig = tenv.pad(tone(987.0, 0.25, SR)).astype(np.float32)
    j, t = jenv.process(sig), tenv.process(sig)
    p = np.asarray(j.power_segment, np.float64)  # [seg, bins, steps]
    d = BF16_U * tenv.timing.win_samples * float(np.abs(sig).max())
    bp = 2 * np.sqrt(2 * p) * d + 2 * d * d
    assert np.all(np.abs(t.power_segment.numpy() - p) <= bp + 1e-4 + 1e-5 * p)
    w = tenv.mel_des.weights.astype(np.float64)  # [n_mel, bins]
    msum = np.einsum("fk,skt->sft", w, p)
    dm = np.einsum("fk,skt->sft", np.abs(w), bp)
    lim = dm / np.maximum(msum + cfg.mel.fbank.log_off - dm, 1e-30) + 1e-4
    r = np.asarray(j.mel_fbank_segment, np.float64)
    valid = np.asarray(j.step_valid)[:, None, :] & np.ones_like(r, bool)
    err = np.abs(t.mel_fbank_segment.numpy() - r)
    assert np.all(err[valid] <= lim[valid])
    assert float(err.max()) > 1e-4  # the grade is visible


@pytest.mark.parametrize("passes", [1, 3, 6])
def test_pack_basis_limbs_layout(passes):
    """The kernel's B operand: [limbs, pass, 7 x (8 cos, 8 sin), k_pad]
    rows, K padded to 64 with exact zeros, bins past n_bins exact zeros,
    and limbs that sum back to the live basis."""
    win, n_bins = 400, 201
    cos_m, sin_m = (torch.as_tensor(m, dtype=torch.float32)
                    for m in framefft.pad_basis(*np.random.default_rng(1).standard_normal((2, win, n_bins)),
                                                np.zeros((32, n_bins)))[:2])
    b = framefft.pack_basis_limbs(cos_m, sin_m, n_bins, passes)
    nl = framefft.n_limbs(passes)
    n_pass = -(-n_bins // framefft.BINS_PER_PASS)
    k_pad = -(-win // framefft.K_CHUNK) * framefft.K_CHUNK
    assert b.dtype == torch.bfloat16 and tuple(b.shape) == (nl * n_pass * 112, k_pad)
    b = b.float().reshape(nl, n_pass, 7, 2, 8, k_pad)
    assert not b[..., win:].any()
    recon = b.sum(0).reshape(n_pass, 7, 2, 8, k_pad)
    bins = (np.arange(n_pass)[:, None, None] * 56 + np.arange(7)[None, :, None] * 8
            + np.arange(8)[None, None, :])
    for part, m in ((0, cos_m), (1, sin_m)):
        got = recon[:, :, part][..., :win]  # [n_pass, 7, 8, win]
        real = bins < n_bins
        want = m[:, :n_bins].T[torch.as_tensor(bins[real])]
        if passes == 6:
            assert torch.equal(got[torch.as_tensor(real)], want)
        else:
            rel = (got[torch.as_tensor(real)] - want).abs().max() / want.abs().max()
            assert float(rel) <= (2.0**-8 if passes == 1 else 2.0**-16)
        assert not got[torch.as_tensor(~real)].any()


def test_pack_basis_limbs_reads_the_live_tensors():
    """A changed basis (a gradient step on a parameter) changes the packed
    limbs: nothing is cached between calls."""
    cos_m = torch.randn(400, 256)
    sin_m = torch.randn(400, 256)
    a = framefft.pack_basis_limbs(cos_m, sin_m, 201, 6)
    cos_m[7, 3] += 1.0
    b = framefft.pack_basis_limbs(cos_m, sin_m, 201, 6)
    diff = (a.float() - b.float()).reshape(3, 4, 112, 448).abs().sum(0)
    assert diff[0, 3, 7] > 0  # pass 0, cos row of bin 3, k = 7
    assert int((diff > 0).sum()) == 1


@pytest.mark.parametrize("passes", [1, 3, 6])
def test_exact_zero_floors_at_every_grade(passes):
    """An all-zero window gives power exactly 0 and the LogMin floors (log
    offsets 0), padded bins add nothing, at every grade."""
    c = _case("flagship_16k")
    c["sig"] = np.zeros_like(c["sig"])
    k = {n: torch.as_tensor(c["consts"][n], dtype=torch.float32)
         for n in ("dft_cos", "dft_sin", "mel_w")}
    t = c["t"]
    dft = tcfg.DFTParams(log_offset=0.0)
    fb = tcfg.FilterBank(log_off=0.0)
    power, logp, mel = framefft.fused_frame_power_mel(
        torch.as_tensor(c["sig"]), t.step_samples, c["offset0"], c["n_windows"],
        k["dft_cos"], k["dft_sin"], k["mel_w"], n_bins=t.n_bins, n_mel=32,
        dft=dft, fbank=fb, passes=passes)
    assert not power.any()
    assert bool((logp == dft.log_min).all())
    assert bool((mel == fb.log_min).all())


@pytest.mark.parametrize("passes", [1, 3, 6])
def test_nan_mel_weights_propagate_at_every_grade(passes):
    """The NaN triangles of an 80-filter bank at 8 kHz give NaN log mel at
    the same positions at every grade as in float64."""
    c = _case("nan_mel_8k")
    got = _port_passes(c, passes)[2]
    k = {n: torch.as_tensor(c["consts"][n]) for n in ("dft_cos", "dft_sin", "mel_w")}
    t, fb = c["t"], c["fb"]
    ref = framefft.fused_frame_power_mel(
        torch.as_tensor(c["sig"], dtype=torch.float64), t.step_samples,
        c["offset0"], c["n_windows"], k["dft_cos"], k["dft_sin"], k["mel_w"],
        n_bins=t.n_bins, n_mel=fb.n_filters, dft=tcfg.DFTParams(),
        fbank=tcfg.FilterBank(**dataclasses.asdict(fb)), passes=passes)[2]
    assert bool(torch.isnan(ref).any())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))


def test_exact_grade_is_the_float32_matmul():
    """At 6 passes the plain version is the float32 product itself (three
    limbs hold each operand exactly); the lower grades differ from it."""
    c = _case("flagship_16k")
    exact = _port_passes(c, 6)
    k = {n: torch.as_tensor(c["consts"][n], dtype=torch.float32)
         for n in ("dft_cos", "dft_sin")}
    t = c["t"]
    starts = c["offset0"] + t.step_samples * torch.arange(c["n_windows"])
    from auditory_tpu_torch.dsp.dft import power_spectrum
    from auditory_tpu_torch.dsp.frame import extract_windows

    w = extract_windows(torch.as_tensor(c["sig"]), starts, t.win_samples)
    assert torch.equal(exact[0], power_spectrum(
        w, (k["dft_cos"][:, :t.n_bins], k["dft_sin"][:, :t.n_bins])))
    for passes in (1, 3):
        assert not torch.equal(_port_passes(c, passes)[0], exact[0])


def test_float64_ignores_passes():
    """float64 is the exact matmul whatever the grade (the goldens and the
    CPU float64 references rest on it)."""
    c = _case("flagship_16k")
    k = {n: torch.as_tensor(c["consts"][n]) for n in ("dft_cos", "dft_sin", "mel_w")}
    t = c["t"]
    outs = [framefft.fused_frame_power_mel(
        torch.as_tensor(c["sig"], dtype=torch.float64), t.step_samples,
        c["offset0"], c["n_windows"], k["dft_cos"], k["dft_sin"], k["mel_w"],
        n_bins=t.n_bins, n_mel=32, dft=tcfg.DFTParams(),
        fbank=tcfg.FilterBank(), passes=p) for p in (1, 3, 6)]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)


def test_limb_product_backward_is_the_exact_float32_gradient():
    """The plain version's grade changes its forward only: the gradient is
    that of the exact float32 product, as the kernel's Function gives."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 5, 40, generator=g, requires_grad=True)
    b = torch.randn(40, 7, generator=g, requires_grad=True)
    cot = torch.randn(3, 5, 7, generator=g)
    out = framefft._LimbProduct.apply(x, b, 1)
    assert not torch.equal(out, x @ b)  # the forward is the bf16 grade
    gx, gb = torch.autograd.grad((out * cot).sum(), (x, b))
    ex, eb = torch.autograd.grad(((x @ b) * cot).sum(), (x, b))
    torch.testing.assert_close(gx, ex, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gb, eb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [0, 2, 4, 5])
def test_passes_validated(bad):
    c = _case("flagship_16k")
    with pytest.raises(ValueError, match="passes must be 1, 3 or 6"):
        _port_passes(c, bad)
    with pytest.raises(ValueError, match="passes must be 1, 3 or 6"):
        _port_passes(c, bad, framefft.fused_frame_power_mel_reference)
    with pytest.raises(ValueError, match="passes must be 1, 3 or 6"):
        at.SndEnv(default_cfg_2d(), SR, kernel_passes=bad, device=CPU)


@pytest.mark.parametrize("passes", [1, 3])
def test_online_forwards_kernel_passes(passes):
    """OnlineSndEnv and MultiStreamOnline pass kernel_passes to their
    SndEnv through **env_kw."""
    cfg = default_cfg_2d()
    online = at.OnlineSndEnv(cfg, SR, kernel_passes=passes, device=CPU)
    ms = at.MultiStreamOnline(cfg, SR, n_streams=2, kernel_passes=passes, device=CPU)
    assert online.env.kernel_passes == passes == ms.env.kernel_passes
    assert at.SndEnv(cfg, SR, device=CPU).kernel_passes == 6


# ---------------------------------------------------------------------------
# the default device
# ---------------------------------------------------------------------------


def test_resolve_device_picks_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcfg.resolve_device(None) == torch.device("cuda")
    assert tcfg.resolve_device("cuda:0") == torch.device("cuda:0")
    assert tcfg.resolve_device("cpu") == CPU


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcfg.resolve_device(None)
    with pytest.raises(RuntimeError, match="is_available"):
        tcfg.resolve_device("cuda")
    assert tcfg.resolve_device(torch.device("cpu")) == CPU


def _entry_points(tmp_path):
    cfg = default_cfg_2d()
    np.savez(tmp_path / "u.npz", mel_fbank_segment=np.zeros((1, 32, 14), np.float32))
    return {
        "SndEnv": lambda **kw: at.SndEnv(cfg, SR, **kw),
        "CorpusRunner": lambda **kw: at.CorpusRunner(cfg, SR, **kw),
        "OnlineSndEnv": lambda **kw: at.OnlineSndEnv(cfg, SR, **kw),
        "MultiStreamOnline": lambda **kw: at.MultiStreamOnline(cfg, SR, n_streams=2, **kw),
        "SegmentPipeline": lambda **kw: at.SegmentPipeline(SR, **kw),
        "StreamingProcessor": lambda **kw: at.StreamingProcessor(
            cfg.params, cfg.dft, cfg.mel, cfg.gabor, SR, **kw),
        "FeatureDataset.batches": lambda **kw: next(
            at.FeatureDataset(str(tmp_path)).batches(1, **kw)),
    }


@pytest.mark.parametrize("entry", [
    "SndEnv", "CorpusRunner", "OnlineSndEnv", "MultiStreamOnline",
    "SegmentPipeline", "StreamingProcessor", "FeatureDataset.batches",
])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """With ``device`` omitted, every entry point asks for the card and
    raises when there is none, naming the way to the host; it never falls
    back to the CPU. ``device="cpu"`` runs on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = _entry_points(tmp_path)[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    made = make(device="cpu")
    if entry == "FeatureDataset.batches":
        assert made["mel_fbank_segment"].device == CPU
    else:
        env = getattr(made, "env", made)
        dev = getattr(env, "device", None)
        assert torch.device(dev) == CPU
