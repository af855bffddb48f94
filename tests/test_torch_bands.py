"""The frontend kernel's banded mel epilogue, on the CPU.

The CUDA kernel (``auditory_tpu_torch/csrc/framefft.cu``) sums each mel
filter only over its band, from the band table its prologue builds on the
card. Here: ``mel_bands`` and ``band_table`` (the table's plain version,
which chip_smoke.py holds the card's table to word for word) against a
brute-force count; a numpy float32 emulation of the kernel's pass-by-pass
order (sub-bands in ascending bin order, carry slots by the table's
numbers, the slots' overflow into the mel output, the dense path of a
window that meets a non-finite power) bit for bit against the dense
ascending-bin sum (what the kernel computed before the bands; fmaf
emulated exactly: the float64 sum rounded to odd, then to float32); the
NaN/inf masks of rows with a NaN sample, an inf sample and an overflowing
tone; and the plain version against the JAX package in float64 on these
banks."""

import dataclasses
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auditory_tpu.config import FilterBank as JFilterBank
from auditory_tpu.dsp.dft import power_spectrum_conv
from auditory_tpu.dsp.mel import apply_mel as japply_mel
import auditory_tpu_torch as at
from auditory_tpu_torch.convert import constants_from_numpy
from auditory_tpu_torch.dsp import design
from auditory_tpu_torch.ops import framefft

torch.set_num_threads(1)

NB = framefft.BINS_PER_PASS
CARRY = framefft.CARRY_SLOTS
OPENS, CLOSES = 1 << 16, 1 << 17
RATES = (8000, 16000, 32000, 44100, 48000, 88200, 96000)
FILTERS = (32, 40, 64, 80, 128, 256)
# the repo's banks (hi_hz 8 kHz, or the Nyquist rate below 16 kHz) at every
# rate and bank size users run, and 96 kHz with 320 filters (143 NaN
# weights, the reference's 0/0 triangles)
BANKS = [(sr, n) for sr in RATES for n in FILTERS] + [(96000, 320)]
# banks the repo's design does not make: a filter with every weight 0, and
# dense random banks (every filter open across every pass boundary, past
# the carry slots; at 320 filters also past the staged entries and weights)
SPECIAL = ("empty_filter_16k", "dense_16k_32", "dense_16k_320")


def _timing(sr):
    return at.WindowParams().derive(sr)


def _bank(name):
    """(sample rate, weights [n_bins, n_mel] float32) of a bank."""
    if isinstance(name, tuple):
        sr, n_mel = name
        t = _timing(sr)
        fb = at.FilterBank(n_filters=n_mel, hi_hz=min(8000.0, sr / 2))
        return sr, design.mel_design(fb, t.win_samples, sr).weights.T.astype(np.float32)
    t = _timing(16000)
    rng = np.random.default_rng(len(name))
    if name == "empty_filter_16k":
        w = design.mel_design(at.FilterBank(), t.win_samples, 16000).weights.copy()
        w[5] = 0.0
        w[31, 150] = -0.0
        return 16000, w.T.astype(np.float32)
    n_mel = int(name.rsplit("_", 1)[1])
    return 16000, rng.random((t.n_bins, n_mel)).astype(np.float32)


def _ids(banks):
    return [b if isinstance(b, str) else f"{b[0]}-{b[1]}" for b in banks]


def _split_table(table, n_bins, n_mel):
    """(entries [n_pass, e_stride, 4], weights [n_pass, w_stride]) views."""
    e_stride = max(n_mel + 1, framefft.STAGED_ENTRIES)
    w_stride = max(NB * n_mel, framefft.STAGED_WEIGHTS)
    n_pass = -(-n_bins // NB)
    t = np.asarray(table)
    assert t.shape == (framefft.table_words(n_bins, n_mel),)
    ent = t[:n_pass * e_stride * 4].reshape(n_pass, e_stride, 4)
    return ent, t[n_pass * e_stride * 4:].view(np.float32).reshape(n_pass, w_stride)


def _brute_table(w):
    """The band table by filters and passes in plain Python, from the
    definition: (per pass: header, [(f, kb, n, opens, closes, woff, slot in,
    slot out)], weights)."""
    n_bins, n_mel = w.shape
    nz = (w != 0) | np.isnan(w)
    bands = []
    for f in range(n_mel):
        ks = np.flatnonzero(nz[:, f])
        bands.append((int(ks[0]), int(ks[-1])) if ks.size else None)
    passes = []
    n_pass = -(-n_bins // NB)
    for q in range(n_pass):
        qs, qe = q * NB, min(q * NB + NB, n_bins) - 1
        ents, weights, n_in, n_out = [], [], 0, 0
        for f, band in enumerate(bands):
            if band is None:
                if q < n_pass - 1:
                    continue
                kb, n, opens, closes = 0, 0, True, True
            else:
                lo, hi = band
                if hi < qs or lo > qe:
                    continue
                kb, n = max(lo, qs) - qs, min(hi, qe) - max(lo, qs) + 1
                opens, closes = lo >= qs, hi <= qe
            ents.append((f, kb, n, opens, closes, len(weights), n_in, n_out))
            weights.extend(w[qs + kb:qs + kb + n, f])
            n_in += not opens
            n_out += not closes
        costs = [e[2] + 4 for e in ents]
        total, before, split = sum(costs), 0, 0
        for c in costs:
            split += 2 * before + c <= total
            before += c
        passes.append(((len(ents), split, len(weights), 0), ents,
                       np.array(weights, np.float32)))
    return bands, passes


@pytest.mark.parametrize("bank", BANKS + list(SPECIAL), ids=_ids(BANKS + list(SPECIAL)))
def test_band_table_matches_a_brute_force_count(bank):
    sr, w = _bank(bank)
    n_bins, n_mel = w.shape
    # as the kernel takes them: [k_pad, m_pad], zero padding
    wp = torch.zeros((n_bins + 7, n_mel + 12))
    wp[:n_bins, :n_mel] = torch.as_tensor(w)
    bands, passes = _brute_table(w)
    lo, hi = framefft.mel_bands(wp, n_bins, n_mel)
    assert [None if h < 0 else (l, h) for l, h in zip(lo.tolist(), hi.tolist())] == bands
    assert all(l == 0 for l, h in zip(lo.tolist(), hi.tolist()) if h < 0)
    ent, wts = _split_table(framefft.band_table(wp, n_bins, n_mel), n_bins, n_mel)
    for q, (head, ents, weights) in enumerate(passes):
        assert tuple(ent[q, 0]) == head
        got = [(e[0], e[1] & 0xFF, (e[1] >> 8) & 0xFF, bool(e[1] & OPENS),
                bool(e[1] & CLOSES), e[2], e[3] & 0xFFFF, e[3] >> 16)
               for e in ent[q, 1:1 + head[0]].tolist()]
        assert got == ents
        np.testing.assert_array_equal(wts[q, :head[2]].view(np.int32),
                                      weights.view(np.int32))
    # the repo's banks stay inside what the kernel stages: every filter
    # open across a boundary has a shared slot, every entry and weight of a
    # pass is staged, and no band is empty
    if not isinstance(bank, str):
        assert all(b is not None for b in bands)
        for head, ents, _ in passes:
            assert head[0] < framefft.STAGED_ENTRIES
            assert head[2] <= framefft.STAGED_WEIGHTS
            assert max((e[7] for e in ents if not e[4]), default=-1) < CARRY
    elif bank.startswith("dense"):
        # a dense bank carries past the slots (and at 320 filters reads
        # entries and weights past what is staged)
        assert max(e[7] for e in passes[0][1]) >= CARRY
        if n_mel == 320:
            assert passes[0][0][0] >= framefft.STAGED_ENTRIES
            assert passes[0][0][2] > framefft.STAGED_WEIGHTS


def fma32(a, b, c):
    """float32 fmaf(a, b, c), elementwise, correctly rounded: a * b is exact
    in float64, the sum is rounded to odd in float64 (TwoSum's error moves
    an even result one ulp toward the exact sum), and rounding that to
    float32 is the single rounding of the exact a * b + c."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    with np.errstate(all="ignore"):  # inf and NaN power
        p = a * b
        s = p + c
        bv = s - p
        err = (p - (s - bv)) + (c - bv)
        fix = (err != 0) & np.isfinite(s) & (s.view(np.int64) % 2 == 0)
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
        return s.astype(np.float32)


def _round32(x):
    """A Fraction rounded to the nearest float32, ties to even."""
    c = np.float32(float(x))
    cands = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.int32)) % 2))


def test_fma32_is_one_rounding():
    a = np.float32(1 + 2.0**-12)
    # (1 + 2^-12)^2 - 1 = 2^-11 + 2^-24: two roundings lose the 2^-24
    assert fma32(a, a, np.float32(-1.0)) == np.float32(2.0**-11 + 2.0**-24)
    assert np.float32(a * a) - np.float32(1.0) == np.float32(2.0**-11)
    rng = np.random.default_rng(3)
    x, y, z = (rng.standard_normal(300).astype(np.float32) for _ in range(3))
    z[::3] = -(x[::3] * y[::3])  # near cancellation
    got = fma32(x, y, z)
    want = [_round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
            for a, b, c in zip(x, y, z)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


def dense_sums(power, w):
    """The mel sums as the dense ascending-bin loop: s = fmaf(W[k, f], p[k],
    s) for every bin k in order, every filter, from +0."""
    s = np.zeros((power.shape[0], w.shape[1]), np.float32)
    for k in range(w.shape[0]):
        s = fma32(w[k][None, :], power[:, k][:, None], s)
    return s


def kernel_sums(power, w, table):
    """The kernel's mel sums in its pass-by-pass order, vectorised over
    windows and filters, looping over bins: each pass's entries from the
    table, a filter's carried sum read from its slot (``slot < CARRY``, by
    the pass's parity) or from the mel output, summed over its sub-band,
    then closed into the output or carried out by the table's slot number;
    a window whose pass holds a non-finite power takes the dense sum of
    every filter for that pass (carried sums, else +0) and keeps every sum
    in the output, dense, from then on. Returns the raw sums (the kernel
    logs each as it closes)."""
    n_win = power.shape[0]
    n_bins, n_mel = w.shape
    ent, wts = _split_table(table, n_bins, n_mel)
    slots = np.zeros((2, CARRY, n_win), np.float32)
    out = np.zeros((n_win, n_mel), np.float32)
    dense = np.zeros(n_win, bool)
    for q in range(ent.shape[0]):
        qs, qe = q * NB, min(q * NB + NB, n_bins) - 1
        e = ent[q, 1:1 + ent[q, 0, 0]]
        f, kb, n = e[:, 0], e[:, 1] & 0xFF, (e[:, 1] >> 8) & 0xFF
        opens, closes = (e[:, 1] & OPENS) > 0, (e[:, 1] & CLOSES) > 0
        s_in, s_out, woff = e[:, 3] & 0xFFFF, e[:, 3] >> 16, e[:, 2]
        bad = ~np.isfinite(power[:, qs:qe + 1]).all(1)
        good = ~(dense | bad)
        # the banded path, over the table's packed weights
        start = np.zeros((n_win, len(f)), np.float32)
        slot = ~opens & (s_in < CARRY)
        past = ~opens & (s_in >= CARRY)
        start[:, slot] = slots[q & 1][s_in[slot]].T
        start[:, past] = out[:, f[past]]
        s = start.copy()
        for k in range(qs, qe + 1):
            j = k - qs
            m = (kb <= j) & (j < kb + n)
            if m.any():
                wk = wts[q, woff[m] + j - kb[m]]
                s[:, m] = fma32(wk[None, :], power[:, k][:, None], s[:, m])
        # the dense path, over the weights themselves
        d = np.zeros((n_win, n_mel), np.float32)
        d[:, f[~opens]] = start[:, ~opens]
        d[dense] = out[dense]
        for k in range(qs, qe + 1):
            d = fma32(w[k][None, :], power[:, k][:, None], d)
        new = out.copy()
        g = np.flatnonzero(good)
        new[np.ix_(g, f[closes])] = s[np.ix_(g, np.flatnonzero(closes))]
        to_slot = ~closes & (s_out < CARRY)
        slots[(q + 1) & 1][s_out[to_slot][:, None], g[None, :]] = \
            s[np.ix_(g, np.flatnonzero(to_slot))].T
        over = ~closes & (s_out >= CARRY)
        new[np.ix_(g, f[over])] = s[np.ix_(g, np.flatnonzero(over))]
        new[~good] = d[~good]
        out = new
        dense |= bad
    return out


def _power(sr, sig):
    """float32 power [windows, n_bins] of the plain version at ``sr``."""
    t = _timing(sr)
    cos_m, sin_m = design.dft_matrices(t.win_samples)
    c = constants_from_numpy(np.zeros((1, t.n_bins)), np.eye(1),
                             np.zeros((1, 1, 1)), cos_m, sin_m, None)
    sig = torch.as_tensor(sig, dtype=torch.float32)
    nw = (sig.shape[-1] - 1) // t.step_samples + 1
    k = [torch.as_tensor(c[n], dtype=torch.float32) for n in ("dft_cos", "dft_sin", "mel_w")]
    power, _, _ = framefft.fused_frame_power_mel_reference(
        sig, t.step_samples, 0, nw, *k, n_bins=t.n_bins, n_mel=1,
        dft=at.DFTParams(), fbank=at.FilterBank(), emit=(True, False))
    return power.reshape(-1, t.n_bins).numpy()


def _assert_same_bits(a, b):
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(np.where(nan, 0, a).view(np.int32),
                                  np.where(nan, 0, b).view(np.int32))


@pytest.mark.parametrize("bank", BANKS + list(SPECIAL), ids=_ids(BANKS + list(SPECIAL)))
def test_banded_order_is_the_dense_sum_bit_for_bit(bank):
    sr, w = _bank(bank)
    rng = np.random.default_rng(sr)
    # noise rows with quiet stretches: sums from a few weak bins and exact
    # zero power in the zero-filled windows
    sig = (0.3 * rng.standard_normal((2, sr // 20))).astype(np.float32)
    sig[1, :sr // 60] = 0.0
    power = _power(sr, sig)
    table = framefft.band_table(torch.as_tensor(w), *w.shape)
    _assert_same_bits(kernel_sums(power, w, table.numpy()), dense_sums(power, w))


def _nonfinite_rows(sr):
    """Rows with a NaN sample, an inf sample, an overflowing tone (finite
    samples, power past float32), and one clean row."""
    n = sr // 25
    rng = np.random.default_rng(1)
    sig = (0.3 * rng.standard_normal((4, n))).astype(np.float32)
    sig[0, n // 2] = np.nan
    sig[1, n // 3] = np.inf
    sig[2] = (1e19 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / sr)).astype(np.float32)
    return sig


@pytest.mark.parametrize("bank", [(16000, 32), (8000, 80), (96000, 320), "dense_16k_32"],
                         ids=["16000-32", "8000-80", "96000-320", "dense_16k_32"])
def test_nonfinite_rows_keep_the_dense_pattern(bank):
    sr, w = _bank(bank)
    power = _power(sr, _nonfinite_rows(sr))
    assert not np.isfinite(power).all() and np.isinf(power).any()
    table = framefft.band_table(torch.as_tensor(w), *w.shape)
    got = kernel_sums(power, w, table.numpy())
    _assert_same_bits(got, dense_sums(power, w))
    # the plain version's masks: its mel is power @ W, in another order
    plain = torch.matmul(torch.as_tensor(power), torch.as_tensor(w)).numpy()
    for mask in (np.isnan, np.isinf):
        np.testing.assert_array_equal(mask(got), mask(plain))
    fb = at.FilterBank()
    from auditory_tpu_torch.dsp.dft import floored_log
    logged = [floored_log(torch.as_tensor(x), fb.log_off, fb.log_min).numpy()
              for x in (got, plain)]
    for mask in (np.isnan, np.isinf):
        np.testing.assert_array_equal(mask(logged[0]), mask(logged[1]))
    # a window with no non-finite power has finite sums, but where a NaN
    # weight reads it
    clean = np.isfinite(power).all(1)
    nan_w = np.isnan(w).any(0)
    assert np.isfinite(got[np.ix_(clean, ~nan_w)]).all()


@pytest.mark.parametrize("bank", [(96000, 320), (8000, 256)] + list(SPECIAL),
                         ids=["96000-320", "8000-256"] + list(SPECIAL))
def test_plain_version_matches_jax_f64_on_the_banks(bank):
    sr, w = _bank(bank)
    t = _timing(sr)
    n_bins, n_mel = w.shape
    rng = np.random.default_rng(n_mel)
    sig = 0.3 * rng.standard_normal((2, sr // 10))
    cos_m, sin_m = design.dft_matrices(t.win_samples)
    nw = (sig.shape[-1] - t.win_samples) // t.step_samples + 1
    k = {n: torch.as_tensor(np.asarray(v, np.float64))
         for n, v in zip(("cos", "sin"), (cos_m, sin_m))}
    wt = torch.as_tensor(w.astype(np.float64))
    fb = at.FilterBank(n_filters=n_mel)
    _, _, mel = framefft.fused_frame_power_mel(
        torch.as_tensor(sig), t.step_samples, 0, nw, k["cos"], k["sin"], wt,
        n_bins=n_bins, n_mel=n_mel, dft=at.DFTParams(), fbank=fb, emit=(False, False))
    power = power_spectrum_conv(jnp.asarray(sig), (jnp.asarray(cos_m), jnp.asarray(sin_m)),
                                t.step_samples, 0, nw)
    jfb = JFilterBank(**dataclasses.asdict(fb))
    ref = np.asarray(japply_mel(power, jnp.asarray(w.T.astype(np.float64)), jfb))
    assert ref.dtype == np.float64 and mel.dtype == torch.float64
    np.testing.assert_array_equal(np.isnan(mel.numpy()), np.isnan(ref))
    np.testing.assert_allclose(mel.numpy(), ref, rtol=1e-11, atol=1e-11)
