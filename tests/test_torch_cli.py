"""The port's command-line interface (CPU): every command in-process through
``main(argv)`` with ``--device cpu``, its outputs held against the port's
API and the JAX package's CLI; ``corpus --coordinator`` as two processes over
gloo; and every flag check made before a process group is joined (the JAX
CLI checked ``--f16-features``/``--int8-features`` and its frontend refusal
after the handshake)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu_torch import cli
from auditory_tpu_torch.io.wav import float_to_wave, load_wav, write_wav
from auditory_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SR = 16000
torch.set_num_threads(1)


def _tone(freq, dur, sr=SR, amp=0.5):
    t = np.arange(int(dur * sr)) / sr
    r = np.random.default_rng(int(freq))
    return amp * np.sin(2 * np.pi * freq * t) + 1e-4 * r.standard_normal(len(t))


def _wav(path, freq=700.0, dur=0.35, sr=SR, channels=1):
    sig = _tone(freq, dur, sr)
    if channels == 2:
        sig = np.stack([sig, -0.5 * sig], axis=1).ravel()
    write_wav(str(path), float_to_wave(sig, sr, channels=channels))
    return str(path)


def _corpus(root, n=4):
    os.makedirs(root, exist_ok=True)
    return [_wav(os.path.join(root, f"u{i}.wav"), 400.0 + 90 * i, 0.25 + 0.05 * i)
            for i in range(n)]


def test_process_matches_the_api_and_jax_cli(tmp_path):
    from auditory_tpu.cli import main as jmain

    p = _wav(tmp_path / "t.wav")
    out = str(tmp_path / "o.npz")
    assert cli.main(["process", p, "--out", out, "--device", "cpu"]) == 0
    got = np.load(out)
    env = at.SndEnv(cli._build_cfg(cli_args(["process", p])), SR, device=CPU)
    want = env.process(env.pad(load_wav(p).sound_to_tensor()))
    for k in ("power_segment", "mel_fbank_segment", "gabor_kwta", "step_valid"):
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(), err_msg=k)
    jout = str(tmp_path / "j.npz")
    assert jmain(["process", p, "--out", jout, "--f64"]) == 0
    f64 = str(tmp_path / "f64.npz")
    assert cli.main(["process", p, "--out", f64, "--f64"]) == 0
    a, b = np.load(f64), np.load(jout)
    assert sorted(a) == sorted(b)
    for k in ("power_segment", "log_power_segment", "mel_fbank_segment",
              "mfcc_segment"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-8, err_msg=k)


def cli_args(argv):
    """The parsed namespace of ``argv`` (main's parser, without running)."""
    seen = {}

    def grab(args):
        seen["args"] = args
        return 0

    old = cli.cmd_process
    cli.cmd_process = grab
    try:
        cli.main(argv)
    finally:
        cli.cmd_process = old
    return seen["args"]


def test_process_flags(tmp_path, capsys):
    p = _wav(tmp_path / "t.wav", dur=0.2)
    st = _wav(tmp_path / "st.wav", channels=2, dur=0.2)
    o1, o2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert cli.main(["process", p, "--out", o1, "--no-kwta", "--device", "cpu"]) == 0
    assert cli.main(["process", p, "--out", o2, "--no-kwta", "--device", "cpu",
                     "--silence-add", "100"]) == 0
    a, b = np.load(o1)["power_segment"], np.load(o2)["power_segment"]
    assert b.shape[0] == a.shape[0] + 1
    o3 = str(tmp_path / "c.npz")
    assert cli.main(["process", st, "--out", o3, "--channel", "1",
                     "--precision", "high", "--window-fn", "hann",
                     "--mel-filters", "40", "--device", "cpu"]) == 0
    assert np.load(o3)["mel_fbank_segment"].shape[1] == 40
    capsys.readouterr()
    assert cli.main(["process", p, "--frontend", "sliced", "--device", "cpu"]) == 2
    assert "TPU formulations" in capsys.readouterr().err
    if not torch.cuda.is_available():
        # the default device is the card: no silent fall back to the host
        assert cli.main(["process", p, "--out", o1]) == 1
        assert "cuda" in capsys.readouterr().err


def test_corpus_matches_the_api(tmp_path, capsys):
    paths = _corpus(str(tmp_path / "wavs"))
    out = str(tmp_path / "feats")
    assert cli.main(["corpus", "--glob", str(tmp_path / "wavs" / "*.wav"),
                     "--out", out, "--batch-size", "2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["files_done"] == 4 and rec["decoded"]["native"] == 4
    ref = str(tmp_path / "ref")
    args = cli_args(["process", paths[0]])
    at.CorpusRunner(cli._build_cfg(args), SR, batch_size=2, device=CPU).run(paths, ref)
    for p in paths:
        stem = os.path.basename(p)[:-4] + ".npz"
        a, b = np.load(os.path.join(out, stem)), np.load(os.path.join(ref, stem))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the mesh (on the host with --device cpu), the float16 tier
    assert cli.main(["corpus", "--glob", str(tmp_path / "wavs" / "*.wav"),
                     "--out", str(tmp_path / "mesh"), "--mesh",
                     "--f16-features", "--device", "cpu"]) == 0
    a = np.load(os.path.join(tmp_path / "mesh", "u0.npz"))
    assert a["mel_fbank_segment"].dtype == np.float16
    assert cli.main(["corpus", "--glob", str(tmp_path / "none*.wav"),
                     "--out", out, "--device", "cpu"]) == 1


def test_corpus_shard_and_merge(tmp_path, capsys):
    _corpus(str(tmp_path / "wavs"))
    out = str(tmp_path / "feats")
    for i in range(2):
        assert cli.main(["corpus", "--glob", str(tmp_path / "wavs" / "*.wav"),
                         "--out", out, "--shard", f"{i}/2", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(["corpus-merge", out]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["files_ok"] == 4 and summary["manifest_shards"] == 2
    assert os.path.exists(os.path.join(out, "feature_stats.json"))
    assert cli.main(["corpus-merge", str(tmp_path / "empty")]) == 1


REFUSED = [
    (["--shard", "0/2"], "exclusive"),
    (["--mesh"], "exclusive"),
    (["--process-id", "5"], "--process-id"),
    (["--f16-features", "--int8-features"], "exclusive"),
    (["--frontend", "conv"], "TPU formulations"),
    (["--mel-filters", "32", "--hi-hz", "9000"], "error"),
]


@pytest.mark.parametrize("extra,msg", REFUSED,
                         ids=["shard", "mesh", "rank", "f16_int8", "frontend", "config"])
def test_corpus_refusals_come_before_the_handshake(extra, msg, tmp_path, monkeypatch,
                                                   capsys):
    joined = []
    monkeypatch.setattr(distributed, "initialize",
                        lambda *a, **k: joined.append(a))
    argv = ["corpus", "--glob", str(tmp_path / "*.wav"), "--out", str(tmp_path),
            "--coordinator", "127.0.0.1:1", "--num-processes", "2",
            "--process-id", "0", "--device", "cpu"]
    rc = cli.main(argv + extra)
    assert rc == 2 and not joined
    assert msg in capsys.readouterr().err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_corpus_coordinator_two_processes(tmp_path):
    """``corpus --coordinator``: two CLI processes split the files by rank
    over gloo and rank 0 merges (no corpus-merge step); the merged features
    equal a one-process run's."""
    paths = _corpus(str(tmp_path / "wavs"))
    out = tmp_path / "feats"
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "auditory_tpu_torch.cli", "corpus",
         "--glob", str(tmp_path / "wavs" / "*.wav"), "--out", str(out),
         "--batch-size", "2", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{o[-3000:]}"
    assert '"merged"' in outs[0] and '"merged"' not in outs[1]
    assert sorted(f for f in os.listdir(out) if f.endswith(".npz")) == [
        f"u{i}.npz" for i in range(4)]
    ref = str(tmp_path / "ref")
    assert cli.main(["corpus", "--glob", str(tmp_path / "wavs" / "*.wav"),
                     "--out", ref, "--batch-size", "2", "--device", "cpu"]) == 0
    for p in paths:
        stem = os.path.basename(p)[:-4] + ".npz"
        assert set(np.load(out / stem)) == set(np.load(os.path.join(ref, stem)))
    with open(out / "feature_stats.json") as f:
        merged = json.load(f)
    with open(os.path.join(ref, "feature_stats.json")) as f:
        single = json.load(f)
    assert merged["count_steps"] == single["count_steps"]
    # both runs within the float32 error model's bound of the float64 run
    from tests.test_torch_sndenv import hold_corpus

    cfg = cli._build_cfg(cli_args(["process", paths[0]]))  # the same defaults
    hold_corpus(cfg, SR, paths, {"ranks": str(out), "single": ref},
                stats={"ranks": merged, "single": single})


def test_segment_and_compare(tmp_path, capsys):
    from auditory_tpu.cli import main as jmain

    p = _wav(tmp_path / "t.wav", freq=1200.0, dur=0.4)
    one = str(tmp_path / "one.npz")
    assert cli.main(["segment", p, "--start-ms", "40", "--end-ms", "200",
                     "--out", one, "--device", "cpu"]) == 0
    assert np.load(one)["gabor_kwta"].ndim == 2
    out = str(tmp_path / "cmp.npz")
    assert cli.main(["segment", p, "--start-ms", "40", "--end-ms", "200",
                     "--compare", "--b-gabor-gain", "3.0", "--out", out,
                     "--f64", "--html", str(tmp_path / "r.html")]) == 0
    d = np.load(out)
    np.testing.assert_array_equal(d["a_power_segment"], d["b_power_segment"])
    np.testing.assert_allclose(2.0 * d["a_gabor_raw"], d["b_gabor_raw"], rtol=1e-9)
    assert (tmp_path / "r.html").read_text().startswith("<!doctype html")
    jout = str(tmp_path / "jcmp.npz")
    assert jmain(["segment", p, "--start-ms", "40", "--end-ms", "200",
                  "--compare", "--b-gabor-gain", "3.0", "--out", jout,
                  "--f64"]) == 0
    j = np.load(jout)
    assert sorted(j) == sorted(d)
    for k in ("a_power_segment", "a_mel_fbank_segment", "b_mfcc_segment"):
        np.testing.assert_allclose(d[k], j[k], rtol=1e-9, atol=1e-8, err_msg=k)
    capsys.readouterr()
    assert cli.main(["segment", p, "--device", "cpu"]) == 1
    assert "need --phn" in capsys.readouterr().err


def test_info_table_viz_play(tmp_path, capsys):
    p = _wav(tmp_path / "a.wav")
    (tmp_path / "a.PHN.MS").write_text("0 h#\n80 sh\n200 iy\n310 h#\n")
    (tmp_path / "a.TXT").write_text("0 5600 utterance a\n")
    assert cli.main(["info", p]) == 0
    assert "16000 Hz, 1 ch, 16-bit" in capsys.readouterr().out
    assert cli.main(["table", "--glob", str(tmp_path / "*.wav"),
                     "--filter", "sh", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["sound"] for r in rows] == ["sh"]
    npz = str(tmp_path / "o.npz")
    assert cli.main(["process", p, "--out", npz, "--device", "cpu"]) == 0
    capsys.readouterr()
    try:
        import matplotlib  # noqa: F401
        want = 0
    except ImportError:
        want = 2
    rc = cli.main(["viz", npz, "--out", str(tmp_path / "viz"), "--keys",
                   "mel_fbank_segment", "--gabor-bank"])
    assert rc == want
    if want == 0:
        assert any(f.endswith(".png") for f in os.listdir(tmp_path / "viz"))
    capsys.readouterr()
    assert cli.main(["play", str(tmp_path / "nope.wav")]) == 1
    assert "not found" in capsys.readouterr().err
    if "sounddevice" not in sys.modules:
        try:
            import sounddevice  # noqa: F401
        except ImportError:
            assert cli.main(["play", p]) == 2
            assert "no audio backend" in capsys.readouterr().err
            re_wav = str(tmp_path / "re.wav")
            assert cli.main(["play", p, "--rate", "8000", "--depth", "1",
                             "--out-wav", re_wav]) == 0
            w = load_wav(re_wav)
            assert (w.sample_rate, w.source_bit_depth) == (8000, 8)


def test_module_entry_points():
    out = subprocess.run([sys.executable, "-m", "auditory_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=60)
    assert out.returncode == 0 and "corpus-merge" in out.stdout
