"""The port's CorpusRunner (CPU) against the JAX package's CorpusRunner on
the same WAV corpus, and its resume, shard, dedup, transfer-tier and
failure behavior (modelled on tests/test_batch_sharding.py,
tests/test_corpus_shards.py and tests/test_int8_transfer.py)."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.pipeline.batch import CorpusRunner as JaxCorpusRunner
from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav
from tests.conftest import default_cfg_2d, tone
from tests.test_torch_sndenv import hold_corpus, hold_f32

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000
N_WAVS = 8


def _wavs(d, n=N_WAVS, dur=0.2):
    """n mono 16-bit WAVs of tone, harmonic and noise mixes, 0.2-0.55 s."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        m = int((dur + 0.05 * i) * SR)
        t = np.arange(m) / SR
        f0 = 120.0 + 40.0 * i
        sig = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
        sig = sig + 0.02 * rng.standard_normal(m) + tone(900.0 + 100 * i, m / SR, SR, 0.1)
        p = os.path.join(str(d), f"u{i}.wav")
        write_wav(p, float_to_wave(sig, SR))
        paths.append(p)
    return paths


def _manifest(out_dir, name="manifest.jsonl"):
    with open(os.path.join(out_dir, name)) as f:
        return [json.loads(line) for line in f]


def _stats(out_dir, name="feature_stats.json"):
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


def _npz(out_dir, stem):
    with np.load(os.path.join(out_dir, stem + ".npz")) as z:
        return dict(z)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    paths = _wavs(d / "wavs")
    bad = str(d / "wavs" / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFFgarbage")
    wrong = str(d / "wavs" / "wrong_rate.wav")
    write_wav(wrong, float_to_wave(tone(500.0, 0.1, 8000), 8000))
    return d, paths, [bad, wrong]


@pytest.fixture(scope="module")
def full_run(corpus):
    d, paths, bad = corpus
    out = str(d / "torch_full")
    stats = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(
        paths + bad, out
    )
    return out, stats


def test_corpus_matches_jax_runner(corpus, full_run):
    d, paths, bad = corpus
    out, stats = full_run
    assert (stats.files_done, stats.files_failed) == (N_WAVS, 2)
    jout = str(d / "jax_full")
    JaxCorpusRunner(default_cfg_2d(), SR, batch_size=4).run(paths + bad, jout)
    status = lambda recs: sorted((r["path"], r["status"]) for r in recs)
    assert status(_manifest(out)) == status(_manifest(jout))
    for i in range(N_WAVS):
        got, want = _npz(out, f"u{i}"), _npz(jout, f"u{i}")
        assert set(got) == set(want) == {"mel_fbank_segment", "gabor_kwta"}
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    ts, js = _stats(out), _stats(jout)
    assert ts["count_steps"] == js["count_steps"] > 0
    assert ts["files_covered"] == js["files_covered"] == N_WAVS
    # features and statistics within the float32 error model's bound of the
    # port's float64 run, and of each other within the sum of the bounds
    # (JAX's CorpusRunner runs the XLA frontend)
    hold_corpus(default_cfg_2d(), SR, paths, {"port": out, "jax": jout},
                stats={"port": ts, "jax": js}, any_order=("jax",))
    # audio seconds count the true, unpadded lengths
    true_s = sum(load_wav(p).num_frames for p in paths) / SR
    assert stats.audio_seconds == pytest.approx(true_s)


def test_npz_equals_batched_process_and_stats_count(corpus, full_run):
    """Each file's saved features equal BatchedSndEnv's unpacked outputs for
    that file's float signal, cut to its segments; the stats count the valid
    steps."""
    d, paths, _ = corpus
    out, _ = full_run
    env = at.SndEnv(default_cfg_2d(), SR, device=CPU)
    benv = at.BatchedSndEnv(env)
    steps = 0
    for i, p in enumerate(paths):
        sig = env.pad(load_wav(p).sound_to_tensor(dtype=np.float32))
        res, seg_valid = benv.process(sig[None], np.array([len(sig)]))
        n_seg = int(seg_valid.sum())
        got = _npz(out, f"u{i}")
        keys = ("mel_fbank_segment", "gabor_kwta")
        assert all(got[k].shape[0] == n_seg for k in keys)
        hold_f32({"npz": {k: got[k][None] for k in keys},
                  "batched": {k: getattr(res, k)[:, :n_seg] for k in keys}},
                 default_cfg_2d(), SR, sig[None], np.array([len(sig)]))
        steps += int(res.step_valid.sum())
    stats = _stats(out)
    assert stats["count_steps"] == steps


def test_resume_does_nothing(corpus, full_run):
    _, paths, bad = corpus
    out, _ = full_run
    before = _manifest(out)
    stats = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(
        paths + bad, out
    )
    assert stats.files_done == 0 and stats.files_failed == 2  # errors retry
    assert len(_manifest(out)) == len(before) + 2


def test_two_shards_merge_equals_full(corpus, full_run, tmp_path):
    _, paths, _ = corpus
    full, _ = full_run
    out = str(tmp_path / "sharded")
    done = 0
    for i in range(2):
        s = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(
            paths, out, shard_index=i, num_shards=2
        )
        done += s.files_done
        assert os.path.exists(os.path.join(out, f"manifest.shard{i}of2.jsonl"))
    assert done == N_WAVS
    summary = at.CorpusRunner.merge_shards(out)
    assert summary == {"manifest_shards": 2, "stats_shards": 2,
                       "files_ok": N_WAVS, "files_failed": 0}
    assert sorted(r["path"] for r in _manifest(out)) == sorted(paths)
    for i in range(N_WAVS):
        assert set(_npz(full, f"u{i}")) == set(_npz(out, f"u{i}"))
    fs = _stats(full)
    ms = _stats(out)
    assert ms["count_steps"] == fs["count_steps"]
    assert ms["files_covered"] == N_WAVS
    hold_corpus(default_cfg_2d(), SR, paths, {"full": full, "sharded": out},
                stats={"full": fs, "sharded": ms})
    with pytest.raises(ValueError, match="shard_index"):
        at.CorpusRunner(default_cfg_2d(), SR, device=CPU).run(paths, out, shard_index=2,
                                                  num_shards=2)


def test_mel_dedup_expansion_exact(corpus, tmp_path):
    _, paths, _ = corpus
    on = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4,
                         save_keys=("mel_fbank_segment", "mel_fbank_global"), device=CPU)
    off = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, dedup_mel=False,
                          save_keys=("mel_fbank_segment",), device=CPU)
    assert on._dedup_mel and not off._dedup_mel
    assert on.batched.pack_keys == ("mel_fbank_global",)
    on.run(paths[:5], str(tmp_path / "on"))
    off.run(paths[:5], str(tmp_path / "off"))
    env = at.SndEnv(default_cfg_2d(), SR, device=CPU)
    for i in range(5):
        a, b = _npz(tmp_path / "on", f"u{i}"), _npz(tmp_path / "off", f"u{i}")
        np.testing.assert_array_equal(a["mel_fbank_segment"], b["mel_fbank_segment"])
        n_seg = a["mel_fbank_segment"].shape[0]
        assert a["mel_fbank_global"].shape[0] == (n_seg - 1) * 10 + 14
    with pytest.raises(ValueError, match="dedup_mel"):
        at.CorpusRunner(default_cfg_2d(), 22050, dedup_mel=True, device=CPU)
    assert not at.CorpusRunner(default_cfg_2d(), 22050, device=CPU)._dedup_mel
    assert env.global_grid(16000)[0].shape == (env.seg_cnt(16000), 14)


def test_stem_collisions(tmp_path):
    (tmp_path / "DR1" / "A").mkdir(parents=True)
    p1 = str(tmp_path / "DR1" / "A" / "S1.wav")
    p2 = str(tmp_path / "DR1" / "A_S1.wav")
    p3 = str(tmp_path / "DR1" / "A_S1-1.wav")
    stems = at.CorpusRunner._out_names([p1, p2, p3])
    assert len(set(stems.values())) == 3 and stems[p3] == "A_S1-1"
    paths = []
    for spk, freq in (("FCJF0", 500.0), ("FVMH0", 1500.0)):
        (tmp_path / spk).mkdir()
        paths.append(str(tmp_path / spk / "SA1.wav"))
        write_wav(paths[-1], float_to_wave(tone(freq, 0.25, SR), SR))
    out = str(tmp_path / "out")
    assert at.CorpusRunner(default_cfg_2d(), SR, device=CPU).run(paths, out).files_done == 2
    npz = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    assert npz == ["FCJF0_SA1.npz", "FVMH0_SA1.npz"]
    a, b = (_npz(out, f[:-4])["mel_fbank_segment"] for f in npz)
    assert not np.allclose(a, b)


@pytest.mark.parametrize("td", ["int8", torch.float16], ids=["int8", "float16"])
def test_transfer_dtype_runs(corpus, full_run, tmp_path, td):
    _, paths, _ = corpus
    full, _ = full_run
    out = str(tmp_path / "o")
    stats = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4,
                            transfer_dtype=td, device=CPU).run(paths, out)
    assert stats.files_done == N_WAVS
    for i in range(N_WAVS):
        got, ref = _npz(out, f"u{i}"), _npz(full, f"u{i}")
        for k, r in ref.items():
            g = got[k]
            assert g.shape == r.shape
            if td == "int8":
                assert g.dtype == np.float32
                fin = np.isfinite(r)
                assert np.array_equal(np.isfinite(g), fin)
                tol = max((np.nanmax(r) - np.nanmin(r)) / 254.0, 1e-6)
                assert np.max(np.abs(g[fin] - r[fin]), initial=0.0) <= tol, k
                if k == "gabor_kwta":
                    assert np.all(g[r == 0] == 0)
            else:
                assert g.dtype == np.float16
                np.testing.assert_allclose(g.astype(np.float32), r,
                                           rtol=1e-3, atol=1e-2, err_msg=k)


def test_4d_layout_through_the_runner(corpus, tmp_path):
    _, paths, _ = corpus
    cfg = dataclasses.replace(default_cfg_2d(), gbor_out_pools_y=8,
                              gbor_out_pools_x=2)
    out = str(tmp_path / "o")
    at.CorpusRunner(cfg, SR, batch_size=4, transfer="float32",
                    save_keys=("gabor_kwta",), device=CPU).run(paths[:3], out)
    env = at.SndEnv(cfg, SR, outputs=("gabor_raw", "gabor_kwta", "step_valid"),
                    device=CPU)
    for i, p in enumerate(paths[:3]):
        sig = env.pad(load_wav(p).sound_to_tensor(dtype=np.float32))
        res = env.process(sig)
        got = _npz(out, f"u{i}")["gabor_kwta"]
        assert got.shape[1:] == (8, 2, 2, 8)
        # the saved kWTA keeps no gabor_raw: it is held, as the run of the
        # same file that keeps it, to the float64 settle of that run's
        # gabor_raw (the two runs' gabor_raw differ by the convolution's
        # rounding, held within the model's bound)
        run = {k: getattr(res, k)[None] for k in ("gabor_raw", "gabor_kwta")}
        hold_f32({"env": run, "runner": dict(run, gabor_kwta=got[None])},
                 cfg, SR, sig[None], np.array([len(sig)]))


def test_iter_device_features(corpus, full_run):
    _, paths, _ = corpus
    full, _ = full_run
    r = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU)
    seen = 0
    for batch_paths, out, seg_valid, n_segs in r.iter_device_features(paths):
        assert out.mel_fbank_global is None and out.power_segment is None
        assert seg_valid.sum(dim=1).tolist() == n_segs
        for j, p in enumerate(batch_paths):
            stem = os.path.splitext(os.path.basename(p))[0]
            ref = _npz(full, stem)
            keys = ("mel_fbank_segment", "gabor_kwta")
            sig = r.env.pad(load_wav(p).sound_to_tensor(dtype=np.float32))
            hold_f32({"device": {k: getattr(out, k)[j:j + 1, : n_segs[j]]
                                 for k in keys},
                      "npz": {k: ref[k][None] for k in keys}},
                     default_cfg_2d(), SR, sig[None], np.array([len(sig)]))
            seen += 1
    assert seen == N_WAVS


def test_writer_failure_stops_dispatch_and_resumes(corpus, tmp_path, monkeypatch):
    _, paths, _ = corpus
    out = str(tmp_path / "o")
    real_savez = np.savez
    calls = {"n": 0}

    def failing_savez(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise OSError("disk full (injected)")
        return real_savez(*a, **kw)

    monkeypatch.setattr(np, "savez", failing_savez)
    with pytest.raises(OSError, match="injected"):
        at.CorpusRunner(default_cfg_2d(), SR, batch_size=2,
                        feature_stats=False, device=CPU).run(paths, out)
    monkeypatch.setattr(np, "savez", real_savez)
    ok = [r["path"] for r in _manifest(out) if r["status"] == "ok"]
    assert len(ok) < N_WAVS
    s2 = at.CorpusRunner(default_cfg_2d(), SR, batch_size=2,
                         feature_stats=False, device=CPU).run(paths, out)
    assert s2.files_done == N_WAVS - len(ok)
    assert len([f for f in os.listdir(out) if f.endswith(".npz")]) == N_WAVS


def test_dispatch_failure_raises_not_hangs(tmp_path, monkeypatch):
    """More files than the decode queue holds, and dispatch fails: run()
    raises promptly instead of leaving the decode thread blocked."""
    paths = []
    for i in range(70):
        paths.append(str(tmp_path / f"x{i}.wav"))
        write_wav(paths[-1], float_to_wave(tone(500.0, 0.05, SR), SR))
    runner = at.CorpusRunner(default_cfg_2d(), SR, batch_size=1, device=CPU)
    monkeypatch.setattr(
        at.CorpusRunner, "_dispatch",
        lambda self, items, blen, add_ms: (_ for _ in ()).throw(
            RuntimeError("boom")),
    )
    result = {}

    def go():
        try:
            runner.run(paths, str(tmp_path / "out"))
            result["outcome"] = "returned"
        except RuntimeError as e:
            result["outcome"] = f"raised:{e}"

    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "run() hung after a dispatch failure"
    assert result["outcome"] == "raised:boom"


def test_concurrent_writes_lose_no_update(corpus, full_run, tmp_path):
    """One-file batches written by 8 pool threads while the download thread
    adds the moments, with a short thread switch interval: the counters,
    the manifest and the moments see every batch."""
    import sys

    _, paths, _ = corpus
    full, _ = full_run
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = at.CorpusRunner(default_cfg_2d(), SR, batch_size=1,
                                decode_threads=8, device=CPU).run(paths, str(tmp_path))
    finally:
        sys.setswitchinterval(old)
    assert stats.files_done == N_WAVS
    true_s = sum(load_wav(p).num_frames for p in paths) / SR
    assert stats.audio_seconds == pytest.approx(true_s)
    assert sorted(r["path"] for r in _manifest(tmp_path)) == sorted(paths)
    got = _stats(tmp_path)
    want = _stats(full)
    assert got["count_steps"] == want["count_steps"]


def test_empty_shard_writes_zero_stats(corpus, tmp_path):
    _, paths, _ = corpus
    out = str(tmp_path / "o")
    for i in range(N_WAVS + 2):  # the last two shards get no files
        s = at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(
            paths, out, shard_index=i, num_shards=N_WAVS + 2
        )
        if i >= N_WAVS:
            assert s.files_done == 0
            z = _stats(out, f"feature_stats.shard{i}of{N_WAVS + 2}.json")
            assert z["count_steps"] == 0.0 and not any(z["mel_sum"])
            assert z["files_covered"] == 0
    summary = at.CorpusRunner.merge_shards(out)
    assert summary["files_ok"] == N_WAVS
    assert summary["manifest_shards"] == N_WAVS + 2


def test_resume_seeds_feature_stats(corpus, full_run, tmp_path):
    _, paths, _ = corpus
    full, _ = full_run
    fs = _stats(full)
    part = str(tmp_path / "part")
    at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(paths[:3], part)
    at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(paths, part)
    rs = _stats(part)
    assert "partial" not in rs and rs["files_covered"] == N_WAVS
    assert rs["count_steps"] == fs["count_steps"]
    hold_corpus(default_cfg_2d(), SR, paths, {"full": full, "resumed": part},
                stats={"full": fs, "resumed": rs})
    # crash-style resume: the manifest says files are done, no stats exist
    crash = str(tmp_path / "crash")
    at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(paths[:3], crash)
    os.remove(os.path.join(crash, "feature_stats.json"))
    at.CorpusRunner(default_cfg_2d(), SR, batch_size=4, device=CPU).run(paths, crash)
    cs = _stats(crash)
    assert cs.get("partial") is True and cs["count_steps"] < fs["count_steps"]
