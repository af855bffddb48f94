"""The PyTorch port's SndEnv against the JAX SndEnv on the same inputs (CPU):
each float32 run within the float32 error model's bound of the port's
float64 run (auditory_tpu_torch/utils/f32_bounds.py; :func:`hold_f32`, which
the other port tests use too), the two within the sum of their bounds; and
the float64 path against the frozen goldens."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.pipeline.sndenv import SndEnv as JaxSndEnv
from auditory_tpu_torch.convert import constants_from_numpy
from auditory_tpu_torch.utils import f32_bounds as fb
from tests.conftest import default_cfg_2d, tone

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDENS = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))


def _batch():
    """B=3 ragged batch: a 4-segment tone, and rows of 2500 and 900 true
    samples with one segment each (the 900-sample row only by SegCnt's Go
    truncating division)."""
    rng = np.random.default_rng(1)
    sig = at.SndEnv(default_cfg_2d(), SR, device=CPU).pad(tone(1234.0, 0.4, SR))
    n = sig.shape[0]
    rows = np.stack([
        sig,
        tone(440.0, n / SR, SR)[:n],
        0.1 * rng.standard_normal(n),
    ]).astype(np.float32)
    return rows, np.array([n, 2500, 900], dtype=np.int32)


def _fields(out, fields=None):
    if dataclasses.is_dataclass(out):
        out = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}
    return {k: v for k, v in out.items()
            if v is not None and (fields is None or k in fields)}


def jax_order(jenv, label="jax"):
    """The ``any_order`` labels of a JAX SndEnv ``jenv``'s run: its XLA
    formulations (use_pallas off, the JAX package's default) sum each DFT
    component in an order the model does not know; its Pallas kernel sums
    circular ranges of each window, which the model bounds directly."""
    return () if jenv._pallas_active else (label,)


def hold_f32(runs, cfg, sr, signals, lengths, channels=1, passes=6,
             add_ms=0, segments=None, fields=None, consts=None, any_order=()):
    """Each float32 run in ``runs`` (label -> the port's or JAX's outputs,
    or a dict of them) within the float32 error model's bound of the port's
    float64 run on the same inputs (auditory_tpu_torch/utils/f32_bounds.py:
    step_valid exactly, gabor_kwta against the float64 settle of the run's
    own gabor_raw), and every two runs within the sum of their bounds.
    ``any_order`` names the runs whose DFT sums in an order the model does
    not know (JAX's XLA formulations, :func:`jax_order`). ``consts``
    (constants_from_numpy's dict) replaces the float64 run's constants.
    Returns (env, ref, {label: bounds}, {label: {field: share}}); the
    bounds hold "port" (a direct sum) whatever the runs."""
    env = at.SndEnv(cfg, sr, dtype=torch.float64, channels=channels,
                    outputs=at.SndEnv.ALL_OUTPUTS, device=CPU)
    if consts is not None:
        env.load_constants(consts)
    ref, _ = env(torch.as_tensor(np.asarray(signals), dtype=torch.float64),
                 torch.as_tensor(np.asarray(lengths)), add_ms, segments)
    unordered = lambda label: label in any_order
    by_kind = {kind: fb.slice_bounds(env, signals, lengths, add_ms,
                                     segments, passes, any_order=kind)
               for kind in {False} | {unordered(label) for label in runs}}
    bounds = {label: by_kind[unordered(label)] for label in ("port", *runs)}
    got = {label: _fields(out, fields) for label, out in runs.items()}
    shares = {label: fb.hold(g, ref, bounds[label], env, label=f"{label}: ")
              for label, g in got.items()}
    labels = list(got)
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            assert set(got[a]) == set(got[b]), (a, b)
            for k in got[a]:
                if k in ("step_valid", "gabor_kwta"):
                    continue
                s = fb.share(_host(got[a][k]), _host(got[b][k]),
                             bounds[a][k] + bounds[b][k])
                assert s <= 1.0, f"{a} vs {b}: {k} at {s:.3g} of the sum of bounds"
    return env, ref, bounds, shares


def hold_corpus(cfg, sr, paths, runs, stats=None, any_order=()):
    """Each corpus run (label -> output directory) within the float32 error
    model's bound of the port's float64 run on each file's float32 signal,
    file by file (:func:`hold_f32`, ``any_order`` the runs of JAX's XLA
    formulations), and each run's mel_mean and mel_std
    (``stats``: label -> feature_stats.json's dict) within
    f32_bounds.mean_std_bounds over every file's valid steps, two runs
    within the sum of their bounds. Returns the worst share per label."""
    from auditory_tpu_torch.io.wav import load_wav

    env32 = at.SndEnv(cfg, sr, device=CPU)
    worst = {label: 0.0 for label in runs}
    bmel = {label: [] for label in runs}
    mel = []
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        sig = env32.pad(load_wav(p).sound_to_tensor(dtype=np.float32))
        got = {}
        for label, d in runs.items():
            with np.load(os.path.join(d, stem + ".npz")) as z:
                got[label] = {k: z[k][None] for k in z.files}
        _, ref, bounds, shares = hold_f32(got, cfg, sr, sig[None],
                                          np.array([sig.shape[0]]),
                                          any_order=any_order)
        for label, sh in shares.items():
            worst[label] = max(worst[label], *sh.values())
        valid = ref.step_valid[0].reshape(-1)
        flat = lambda x: x[0].transpose(-1, -2).reshape(-1, x.shape[2])[valid]
        for label in runs:
            bmel[label].append(flat(bounds[label]["mel_fbank_segment"]))
        mel.append(flat(ref.mel_fbank_segment))
    if stats:
        mel = torch.cat(mel)
        valid = torch.ones(mel.shape[0], dtype=torch.bool)
        b = {label: fb.mean_std_bounds(torch.cat(bmel[label]), mel, valid)
             for label in stats}
        mean = mel.mean(0)
        std = torch.sqrt(torch.clamp((mel * mel).mean(0) - mean * mean, min=0.0))
        for i, (key, want) in enumerate((("mel_mean", mean), ("mel_std", std))):
            got = {label: torch.as_tensor(st[key], dtype=torch.float64)
                   for label, st in stats.items()}
            for label, g in got.items():
                s = fb.share(g, want, b[label][i])
                assert s <= 1.0, f"{label}: {key} at {s:.3g} of its bound"
                worst[label] = max(worst[label], s)
            labels = list(got)
            for j, a in enumerate(labels):
                for c in labels[j + 1:]:
                    s = fb.share(got[a], got[c], b[a][i] + b[c][i])
                    assert s <= 1.0, (a, c, key)
    return worst


def _host(x):
    return x.cpu() if torch.is_tensor(x) else torch.as_tensor(np.array(x))


def _compare(jax_out, torch_out, signals, lengths, cfg=None, channels=1,
             consts=None):
    """:func:`hold_f32` of a JAX SndEnv's run and the port's; the JAX runs
    of this file take its default XLA frontend (``_run_both`` checks it)."""
    return hold_f32({"jax": jax_out, "port": torch_out},
                    cfg or default_cfg_2d(), SR, signals, lengths, channels,
                    consts=consts, any_order=("jax",))


def _run_both(cfg, outputs=None, channels=1, feature_stats=False,
              signals=None, lengths=None):
    if signals is None:
        signals, lengths = _batch()
    kw = dict(outputs=outputs, channels=channels, feature_stats=feature_stats)
    jenv = JaxSndEnv(cfg, SR, dtype=jnp.float32, **kw)
    tenv = at.SndEnv(cfg, SR, dtype=torch.float32, **kw, device=CPU)
    jres = jenv.process_fn(signals.shape[-1])(
        jnp.asarray(signals), jnp.asarray(lengths)
    )
    assert jax_order(jenv) == ("jax",)
    tres = at.BatchedSndEnv(tenv).process(signals, lengths)
    return jres, tres


def test_slice_matches_jax_f32_flagship():
    (jo, jv, js), (to, tv, ts) = _run_both(default_cfg_2d(), feature_stats=True)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # row 2 (900 samples) has 1 segment only by truncating division
    assert tv.numpy().sum(axis=1).tolist() == [4, 1, 1]
    signals, lengths = _batch()
    _, ref, bounds, _ = _compare(jo, to, signals, lengths)
    assert float(js["count"]) == float(ts["count"]) == float(ref.step_valid.sum())
    # the feature stats: the sums of their elements' bounds
    mel = ref.mel_fbank_segment.transpose(-1, -2)
    sums = {label: fb.sum_bounds(bounds[label]["mel_fbank_segment"].transpose(-1, -2),
                                 mel, ref.step_valid)
            for label in ("port", "jax")}
    for i, k in enumerate(("sum", "sumsq")):
        v = torch.where(ref.step_valid[..., None], mel, 0.0)
        want = (v if k == "sum" else v * v).sum(dim=(0, 1, 2))
        got = {"port": ts[k], "jax": torch.as_tensor(np.array(js[k]))}
        for label, g in got.items():
            assert fb.share(g, want, sums[label][i]) <= 1.0, (label, k)
        assert fb.share(got["port"], got["jax"],
                        sums["port"][i] + sums["jax"][i]) <= 1.0, k


def test_signal_shorter_than_one_segment():
    cfg = default_cfg_2d()
    sig = tone(900.0, 0.05, SR).astype(np.float32)  # 800 samples
    jo = JaxSndEnv(cfg, SR, dtype=jnp.float32).process(sig)
    to = at.SndEnv(cfg, SR, device=CPU).process(sig)
    assert to.mel_fbank_segment.shape[0] == 1
    batched = lambda o: {f.name: getattr(o, f.name)[None]
                         for f in dataclasses.fields(o)
                         if getattr(o, f.name) is not None}
    _compare(batched(jo), batched(to), sig[None], np.array([sig.shape[0]]))


def test_channels_2():
    signals, _ = _batch()
    lengths = np.array([signals.shape[-1], 4000, 3000], dtype=np.int32)
    (jo, jv), (to, tv) = _run_both(
        default_cfg_2d(), channels=2, signals=signals, lengths=lengths
    )
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    _compare(jo, to, signals, lengths, channels=2)


@pytest.mark.parametrize(
    "outputs",
    [
        ("mel_fbank_segment", "gabor_raw", "step_valid"),
        ("mfcc_segment", "mel_fbank_global"),
        ("log_power_segment", "gabor_kwta"),
    ],
    ids=["melgabor", "mfcc_global", "logp_kwta"],
)
def test_outputs_selection(outputs):
    (jo, jv), (to, tv) = _run_both(default_cfg_2d(), outputs=outputs)
    for f in at.SndEnv.ALL_OUTPUTS:
        assert (getattr(to, f) is not None) == (f in outputs), f
    jo, to = _fields(jo), _fields(to)
    if "gabor_kwta" in outputs and "gabor_raw" not in outputs:
        # the kWTA is held through the run's own gabor_raw: the selection
        # computes the same bits as the run with every output, whose
        # gabor_raw it takes
        (ja, _), (ta, _) = _run_both(default_cfg_2d())
        np.testing.assert_array_equal(np.asarray(jo["gabor_kwta"]),
                                      np.asarray(ja.gabor_kwta))
        assert torch.equal(to["gabor_kwta"], ta.gabor_kwta)
        jo["gabor_raw"], to["gabor_raw"] = ja.gabor_raw, ta.gabor_raw
    if "mel_fbank_global" in outputs:
        # the global grid's rows hold every window of the grid, unmasked
        n = _batch()[0].shape[-1]
        assert to["mel_fbank_global"].shape[1] == at.SndEnv(
            default_cfg_2d(), SR, device=CPU).global_grid(n)[0].max() + 1
    signals, lengths = _batch()
    _compare(jo, to, signals, lengths)


def test_constants_carried_across_perturbed_gabor():
    cfg = default_cfg_2d()
    jenv = JaxSndEnv(cfg, SR, dtype=jnp.float32)
    tenv = at.SndEnv(cfg, SR, device=CPU)
    rng = np.random.default_rng(7)
    bank = np.asarray(jenv.gabor_bank) + 0.05 * rng.standard_normal(
        jenv.gabor_bank.shape
    )
    jenv.gabor_bank = bank
    cos_m, sin_m = jenv.dft_basis  # rectangular window: the plain basis
    tenv.load_constants(constants_from_numpy(
        np.asarray(jenv.mel_des.weights), np.asarray(jenv.dct_mat), bank,
        np.asarray(cos_m), np.asarray(sin_m), jenv.analysis_win,
    ))
    signals, lengths = _batch()
    jo, jv = jenv.process_fn(signals.shape[-1])(
        jnp.asarray(signals), jnp.asarray(lengths)
    )
    to, tv = tenv(torch.as_tensor(signals), torch.as_tensor(lengths))
    _compare(jo, to, signals, lengths, consts=constants_from_numpy(
        np.asarray(jenv.mel_des.weights), np.asarray(jenv.dct_mat), bank,
        np.asarray(cos_m), np.asarray(sin_m), jenv.analysis_win,
    ))
    default = at.SndEnv(cfg, SR, device=CPU)(
        torch.as_tensor(signals), torch.as_tensor(lengths)
    )[0]
    assert not torch.allclose(default.gabor_raw, to.gabor_raw)


def test_load_constants_rejects_wrong_shape():
    env = at.SndEnv(default_cfg_2d(), SR, device=CPU)
    with pytest.raises(ValueError, match="dct"):
        env.load_constants({"dct": np.eye(5)})


@pytest.mark.parametrize(
    "path", GOLDENS, ids=[os.path.basename(p) for p in GOLDENS]
)
def test_f64_port_matches_golden(path):
    g = np.load(path)
    sr = int(g["sample_rate"])
    channels = int(g["channels"]) if "channels" in g.files else 1
    wfn = str(g["window_fn"]) if "window_fn" in g.files else ""
    cfg = default_cfg_2d()
    if wfn:
        cfg = dataclasses.replace(
            cfg, dft=dataclasses.replace(cfg.dft, window_fn=wfn)
        )
    env = at.SndEnv(cfg, sr, dtype=torch.float64, channels=channels, device=CPU)
    out = env.process(g["signal"])
    assert out.power_segment.shape[0] == int(g["n_segments"])
    for key in (
        "power_segment", "log_power_segment", "mel_fbank_segment", "energy",
        "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas",
    ):
        np.testing.assert_allclose(
            getattr(out, key).numpy(), g[key], atol=1e-5, rtol=1e-7,
            err_msg=f"{os.path.basename(path)}:{key}",
        )
    np.testing.assert_allclose(
        out.gabor_raw.numpy(), g["gabor_raw"], atol=1e-4, rtol=1e-5
    )


def test_goldens_all_present():
    assert len(GOLDENS) == 13


@pytest.mark.parametrize(
    "change",
    [
        dict(gbor_out_pools_x=4, gbor_out_pools_y=4),
        dict(dft=at.DFTParams(prev_smooth=0.5)),
        dict(params=at.WindowParams(stride_ms=105.0)),
    ],
    ids=["layout_4d", "prev_smooth", "off_grid"],
)
def test_unported_paths_raise(change):
    """Configurations that raised NotImplementedError before the 4-D layout
    and the gather frontend were ported: they now build and run, with
    finite outputs of the reference's shapes."""
    cfg = dataclasses.replace(default_cfg_2d(), **change)
    env = at.SndEnv(cfg, SR, device=CPU)
    signals, lengths = _batch()
    out, seg_valid = env(torch.as_tensor(signals), torch.as_tensor(lengths))
    n_seg = env.seg_cnt(signals.shape[-1])
    assert seg_valid.shape == (3, n_seg) and seg_valid[0].all()
    assert tuple(out.gabor_kwta.shape) == (3, n_seg) + env.gabor_output_shape()
    assert out.mel_fbank_segment.shape == (3, n_seg, 32, env.timing.segment_steps)
    for f in ("power_segment", "mel_fbank_segment", "mfcc_delta_deltas",
              "gabor_kwta"):
        assert torch.isfinite(getattr(out, f)).all(), f


def test_cuda_device_refused_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        at.SndEnv(default_cfg_2d(), SR, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        at.CorpusRunner(default_cfg_2d(), SR, device="cuda")


def test_precision_tier_sets_and_restores_tf32_flags():
    from auditory_tpu_torch.pipeline.sndenv import precision_tier

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    before = flags()
    with precision_tier("highest"):
        assert flags() == (False, False)
    assert flags() == before
    with precision_tier("default"):
        assert flags() == (True, True)
    assert flags() == before
    with pytest.raises(ValueError):
        at.SndEnv(default_cfg_2d(), SR, matmul_precision="bf16", device=CPU)


def test_design_constants_match_jax_env():
    jenv = JaxSndEnv(default_cfg_2d(), 44100, dtype=jnp.float32)
    tenv = at.SndEnv(default_cfg_2d(), 44100, device=CPU)
    np.testing.assert_array_equal(tenv.mel_des.weights, jenv.mel_des.weights)
    np.testing.assert_array_equal(tenv.gabor_bank, jenv.gabor_bank)
    np.testing.assert_array_equal(tenv.dct_mat, jenv.dct_mat)
    assert tenv.gabor_output_shape() == jenv.gabor_output_shape()
    assert tenv.seg_cnt(12345) == jenv.seg_cnt(12345)
    np.testing.assert_array_equal(tenv.pad(np.ones(5000)), jenv.pad(np.ones(5000)))
    w = tenv.timing.win_samples
    np.testing.assert_array_equal(
        tenv.dft_cos[:, : w // 2 + 1].numpy(),
        np.asarray(jenv.dft_basis[0], dtype=np.float32),
    )
