"""The port's mesh and multi-process paths (CPU): a local ``[cpu] * n`` mesh
against the port without a mesh (to float64 rounding) and against the JAX package's
``BatchedSndEnv(mesh=make_mesh())`` over its 8 virtual CPU devices (float64:
spectra and MFCC within 1e-9; the gabor stages, float32 by contract on both
sides, within tests/test_torch_online.py's 1e-5 and the kWTA bound), segment
sharding, ``process_local``, and gloo groups of 2 and 3 ranks spawned as
processes (each group within 60 s) whose gathered results equal JAX's
single-process run. ``run_distributed`` is held against JAX's
``CorpusRunner.run`` at tests/test_multiprocess.py's tolerances.

The spawned ranks run :func:`_rank_main` (``python -c``), which imports only
the port."""

import dataclasses
import glob
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu_torch.parallel import distributed
from auditory_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    segment_sharding,
    split_range,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SR = 16000
GROUP_TIMEOUT_S = 60
torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-9)
# both packages convolve the gabor bank in float32 and settle kWTA in float32
GABOR = {"gabor_raw": dict(rtol=0.0, atol=1e-5),
         "gabor_kwta": dict(rtol=0.0, atol=1e-4)}
KEYS = ("power_segment", "mel_fbank_segment", "mfcc_segment", "mfcc_deltas",
        "gabor_raw", "gabor_kwta", "step_valid")

# per group size: each rank's local rows (uneven) and local shard count
ROWS = {2: (3, 2), 3: (3, 2, 2)}
SHARDS = {2: (2, 1), 3: (3, 1, 2)}


def _port_cfg():
    return at.SndEnvConfig(gabor=at.GaborSet(
        size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0, distribute=False,
        specs=at.default_gabor_specs(phases=(0.0, 1.5708))))


def _jax_cfg():
    from tests.conftest import default_cfg_2d

    return default_cfg_2d()


def _rows(b, seed=42, segs=4):
    """A float64 [b, S] batch of noise with ragged true lengths (full,
    shorter, and one of a single masked-out segment)."""
    t = at.WindowParams().derive(SR)
    n = t.segment_samples + (segs - 1) * t.stride_samples
    rng = np.random.default_rng(seed)
    sig = rng.normal(scale=0.1, size=(b, n))
    lens = np.full(b, n, dtype=np.int64)
    lens[1::3] = n - 2100
    lens[2::3] = 900
    sig[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    return sig, lens


def _long(segs=5):
    """Two long rows for segment sharding: the second row's true length
    ends two segments early (its last segments are invalid)."""
    sig, _ = _rows(2, seed=11, segs=segs)
    t = at.WindowParams().derive(SR)
    lens = np.array([sig.shape[1], sig.shape[1] - 2 * t.stride_samples - 300])
    return sig, lens


def _env(**kw):
    return at.SndEnv(_port_cfg(), SR, dtype=torch.float64, device=CPU,
                     feature_stats=True, **kw)


def _same(a, b, msg=""):
    """Equal up to float64 rounding: a batched matmul may block a smaller
    batch differently (the delta operator over fewer segments)."""
    torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12, equal_nan=True,
                               msg=msg or None)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_jax_close(got, ref, keys=KEYS):
    """got: {key: host array} (port), ref: JAX SndEnvOutputs."""
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(getattr(ref, k))
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k == "step_valid":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **GABOR.get(k, F64))


def _jax_run(sig, lens, mesh=False, shard_axis="batch"):
    import jax.numpy as jnp

    from auditory_tpu.parallel.mesh import make_mesh as jmake_mesh
    from auditory_tpu.pipeline.batch import BatchedSndEnv as JBatched
    from auditory_tpu.pipeline.sndenv import SndEnv as JSndEnv

    jenv = JSndEnv(_jax_cfg(), SR, dtype=jnp.float64, feature_stats=True)
    b = JBatched(jenv, mesh=jmake_mesh() if mesh else None,
                 shard_axis=shard_axis)
    return b.process(sig, lens.astype(np.int32))


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------


def test_split_range_and_sharding():
    assert split_range(7, 3) == ((0, 3), (3, 5), (5, 7))
    assert split_range(2, 4) == ((0, 1), (1, 2), (2, 2), (2, 2))
    mesh = make_mesh([CPU] * 4)
    assert batch_sharding(mesh, 8) == tuple(slice(2 * i, 2 * i + 2) for i in range(4))
    assert segment_sharding is batch_sharding
    assert pad_to_multiple(5, 4) == 8 and pad_to_multiple(8, 4) == 8


def test_make_mesh_local_layout():
    mesh = make_mesh([CPU, "cpu", CPU], axis_name="streams")
    assert mesh.local_size == mesh.size == 3 and mesh.process_count == 1
    assert mesh.axis_name == "streams" and mesh.group is None
    assert [p.rank for p in mesh.layout] == [0, 0, 0]
    assert mesh.local_devices == (CPU,) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError, match="at least one"):
        make_mesh([])


def test_make_mesh_layout_is_what_the_ranks_report(monkeypatch):
    """A permuted placement (rank 0 on cuda:1 of one host, rank 1 on cuda:0
    of another) comes back as reported, rank-major: nothing about the
    device order is assumed."""
    import torch.distributed as dist

    from auditory_tpu_torch.parallel.mesh import Placement

    reported = [(Placement(0, "host-b", "cuda:1"),),
                (Placement(1, "host-a", "cuda:0"),)]
    seen = []

    def gather(obj):
        seen.append(obj)
        return list(reported)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(distributed, "all_gather_object", gather)
    monkeypatch.setattr(distributed, "data_group", lambda: "the data group")
    mesh = make_mesh([torch.device("cuda", 0)])
    assert [p.device for p in seen[0]] == ["cuda:0"] and seen[0][0].rank == 1
    assert mesh.layout == tuple(p for ps in reported for p in ps)
    assert mesh.size == 2 and mesh.process_count == 2 and mesh.local_size == 1
    assert mesh.group == "the data group"


@pytest.mark.parametrize("local_rank,placed,backend", [
    ("1", [("h", "cuda:1"), ("h", "cuda:0")], "nccl"),
    ("0", [("h", "cuda:0"), ("h", "cuda:0")], "gloo"),
], ids=["permuted_distinct_gpus", "one_card_shared"])
def test_initialize_pins_the_local_rank(local_rank, placed, backend, monkeypatch):
    """Each rank pins cuda:{LOCAL_RANK} (not the bare 'cuda' of
    resolve_device, which would put every rank on GPU 0); NCCL carries the
    device tensors only when every rank owns a distinct GPU."""
    import torch.distributed as dist

    calls = {}
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(distributed, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.setdefault("pinned", i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.setdefault("init", (a, k)))
    monkeypatch.setattr(distributed, "all_gather_object", lambda obj: placed)
    monkeypatch.setattr(dist, "new_group",
                        lambda **k: calls.setdefault("new_group", k) and "nccl group")
    try:
        dev = distributed.initialize("localhost:29500", 2, 0, timeout_s=5)
        assert dev == torch.device("cuda", int(local_rank))
        assert calls["pinned"] == int(local_rank)
        (backend0,), kw = calls["init"]
        assert backend0 == "gloo" and kw["init_method"] == "tcp://localhost:29500"
        assert kw["world_size"] == 2 and kw["rank"] == 0
        assert kw["timeout"].total_seconds() == 5
        assert distributed.data_backend() == backend
        assert ("new_group" in calls) == (backend == "nccl")
        assert distributed.local_device() == dev
    finally:
        distributed.shutdown()
    assert distributed.data_backend() == "gloo" and distributed.data_group() is None


def test_validation():
    env = _env()
    mesh = make_mesh([CPU] * 2)
    with pytest.raises(ValueError, match="'batch' or 'segment'"):
        at.BatchedSndEnv(env, mesh=mesh, shard_axis="rows")
    smooth = at.SndEnv(dataclasses.replace(
        _port_cfg(), dft=at.DFTParams(prev_smooth=0.4)), SR, device=CPU)
    with pytest.raises(ValueError, match="prev_smooth"):
        at.BatchedSndEnv(smooth, mesh=mesh, shard_axis="segment")
    with pytest.raises(ValueError, match="pack_keys"):
        at.BatchedSndEnv(env, mesh=mesh, shard_axis="segment",
                         pack_keys=("mel_fbank_segment",))
    glob_env = at.SndEnv(_port_cfg(), SR, device=CPU,
                         outputs=("mel_fbank_global",))
    with pytest.raises(ValueError, match="mel_fbank_global"):
        at.BatchedSndEnv(glob_env, mesh=mesh, shard_axis="segment")
    with pytest.raises(TypeError, match="Mesh"):
        at.BatchedSndEnv(env, mesh=[CPU, CPU])
    sig, lens = _rows(2)
    with pytest.raises(ValueError, match="requires a mesh"):
        at.BatchedSndEnv(env).process_local(sig, lens)
    with pytest.raises(ValueError, match="out of range"):
        distributed.initialize("127.0.0.1:1", 2, 2, device="cpu")


# ---------------------------------------------------------------------------
# the local mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_local_mesh_equals_no_mesh(n_dev):
    env = _env()
    sig, lens = _rows(5)
    ref, ref_valid, ref_stats = at.BatchedSndEnv(env).process(sig, lens)
    out, valid, stats = at.BatchedSndEnv(
        env, mesh=make_mesh([CPU] * n_dev)).process(sig, lens)
    assert torch.equal(valid, ref_valid) and valid.shape[0] == 5
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            _same(a, b, f.name)
    for k in ref_stats:
        torch.testing.assert_close(stats[k], ref_stats[k], rtol=1e-12, atol=1e-12)


def test_local_mesh_matches_jax_mesh():
    """B=5 over a 4-shard mesh (the port pads to 8 rows) against JAX's
    BatchedSndEnv on its 8-device mesh (JAX pads to 8 too)."""
    sig, lens = _rows(5)
    out, valid, stats = at.BatchedSndEnv(
        _env(), mesh=make_mesh([CPU] * 4)).process(sig, lens)
    jout, jvalid, jstats = _jax_run(sig, lens, mesh=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    _assert_jax_close({k: _np(getattr(out, k)) for k in KEYS}, jout)
    for k in ("sum", "sumsq", "count"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   rtol=1e-9, err_msg=k)


def test_local_mesh_stats_ignore_pad_rows():
    """7 rows over 4 shards: one inert pad row; the moments count only the
    valid steps of the real rows, as the unsharded run's do."""
    sig, lens = _rows(7)
    b = at.BatchedSndEnv(_env(), mesh=make_mesh([CPU] * 4))
    assert b.batch_multiple == 4
    out, valid, stats = b.process(sig, lens)
    assert valid.shape[0] == 7
    _, ref_valid, ref_stats = at.BatchedSndEnv(_env()).process(sig, lens)
    assert float(stats["count"]) == float(ref_stats["count"]) > 0
    res, pad = b.process_local(sig, lens)
    assert pad == 1 and res[1].shape[0] == 8 and not res[1][7].any()
    torch.testing.assert_close(res[2]["sum"], ref_stats["sum"])


@pytest.mark.parametrize("td", [None, "float16", "int8"])
def test_local_mesh_packed_tiers(td):
    keys = ("mel_fbank_global", "gabor_kwta")
    env = at.SndEnv(_port_cfg(), SR, device=CPU, outputs=keys)
    sig, lens = _rows(5)
    sig = sig.astype(np.float32)
    (ref,) = at.BatchedSndEnv(env, transfer_dtype=td, pack_keys=keys).process(sig, lens)
    (got,) = at.BatchedSndEnv(env, mesh=make_mesh([CPU] * 3), transfer_dtype=td,
                              pack_keys=keys).process(sig, lens)
    assert got.entries == ref.entries and torch.equal(got.data, ref.data)


def test_segment_shard_ranges_reproduce_the_whole_run():
    """SndEnv.forward over a contiguous segment range equals that slice of
    the whole run: a range boundary inside the valid region, and a last
    range whose segments are invalid for the short row."""
    env = _env()
    sig, lens = _long(segs=6)
    whole = env(torch.as_tensor(sig), torch.as_tensor(lens))
    for s0, s1 in ((0, 2), (2, 5), (4, 6), (5, 6)):
        part = env(torch.as_tensor(sig), torch.as_tensor(lens), 0, (s0, s1))
        assert torch.equal(part[1], whole[1][:, s0:s1])
        for f in dataclasses.fields(whole[0]):
            a = getattr(whole[0], f.name)
            if a is not None and f.name != "mel_fbank_global":
                _same(a[:, s0:s1], getattr(part[0], f.name), f.name)
    assert not whole[1][1, 4:].any() and whole[1][1, :3].all()
    with pytest.raises(ValueError, match="segment range"):
        env(torch.as_tensor(sig), torch.as_tensor(lens), 0, (5, 7))


@pytest.mark.parametrize("n_dev", [4, 9], ids=["4_shards", "9_shards_some_empty"])
def test_local_segment_sharding(n_dev):
    env = _env()
    sig, lens = _long(segs=6)
    ref = at.BatchedSndEnv(env).process(sig, lens)
    got = at.BatchedSndEnv(env, mesh=make_mesh([CPU] * n_dev),
                           shard_axis="segment").process(sig, lens)
    assert torch.equal(got[1], ref[1])
    for k in KEYS:
        _same(getattr(ref[0], k), getattr(got[0], k), k)
    for k in ref[2]:
        torch.testing.assert_close(got[2][k], ref[2][k], rtol=1e-12, atol=1e-12)


def test_local_segment_sharding_matches_jax():
    sig, lens = _long(segs=6)
    got = at.BatchedSndEnv(_env(), mesh=make_mesh([CPU] * 4),
                           shard_axis="segment").process(sig, lens)
    jout, jvalid, _ = _jax_run(sig, lens, mesh=True, shard_axis="segment")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jvalid))
    _assert_jax_close({k: _np(getattr(got[0], k)) for k in KEYS}, jout)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_local_in_a_group_of_one():
    """One gloo rank: process_local + gather_local_rows equal process(), and
    the all-reduced stats equal the single-process stats."""
    env = _env()
    sig, lens = _rows(5)
    ref = at.BatchedSndEnv(env).process(sig, lens)
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu",
                           timeout_s=30)
    try:
        assert distributed.data_backend() == "gloo"
        mesh = make_mesh([CPU] * 2)
        assert mesh.group is None and mesh.process_count == 1
        (out, valid, stats), pad = at.BatchedSndEnv(env, mesh=mesh).process_local(
            sig, lens)
        assert pad == 1
        g_out, g_valid = distributed.gather_local_rows((out, valid), 5, pad)
        distributed.barrier("group_of_one")
    finally:
        distributed.shutdown()
    np.testing.assert_array_equal(g_valid, ref[1].numpy())
    for k in KEYS:
        np.testing.assert_array_equal(getattr(g_out, k), getattr(ref[0], k).numpy())
    for k in stats:
        torch.testing.assert_close(stats[k], ref[2][k], rtol=1e-12, atol=1e-12)


def test_gather_without_a_group_copies_to_the_host():
    x = torch.arange(12.0).reshape(4, 3)
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    np.testing.assert_array_equal(distributed.allgather({"x": x})["x"], x.numpy())
    np.testing.assert_array_equal(
        distributed.gather_local_rows((x, None), 3, 1)[0], x[:3].numpy())
    with pytest.raises(ValueError, match="process_local block"):
        distributed.gather_local_rows(x, 2, 1)
    np.testing.assert_array_equal(distributed.global_batch_from_local(x), x.numpy())
    assert distributed.all_gather_object("a") == ["a"]
    distributed.barrier()  # a no-op without a group


# ---------------------------------------------------------------------------
# corpus and serving on a local mesh
# ---------------------------------------------------------------------------


def _write_corpus(root, n=5):
    from auditory_tpu_torch.io.wav import float_to_wave, write_wav

    os.makedirs(root, exist_ok=True)
    for i in range(n):
        t = np.arange(int((0.25 + 0.05 * i) * SR)) / SR
        sig = 0.4 * np.sin(2 * np.pi * (300.0 + 140.0 * i) * t)
        sig = sig + 1e-4 * np.random.default_rng(i).standard_normal(len(t))
        write_wav(os.path.join(root, f"u{i}.wav"), float_to_wave(sig, SR))
    return sorted(glob.glob(os.path.join(root, "*.wav")))


def test_corpus_runner_on_a_mesh(tmp_path):
    paths = _write_corpus(str(tmp_path / "wavs"))
    cfg = _port_cfg()
    at.CorpusRunner(cfg, SR, batch_size=4, device=CPU).run(paths, str(tmp_path / "one"))
    runner = at.CorpusRunner(cfg, SR, batch_size=4, mesh=make_mesh([CPU] * 3))
    assert runner.env.device == CPU
    runner.run(paths, str(tmp_path / "mesh"))
    for p in paths:
        stem = os.path.basename(p)[:-4] + ".npz"
        a, b = np.load(tmp_path / "one" / stem), np.load(tmp_path / "mesh" / stem)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    batches = list(runner.iter_device_features(paths))
    assert runner._batched_dev.mesh is runner.batched.mesh
    assert sum(len(b[0]) for b in batches) == len(paths)


# ---------------------------------------------------------------------------
# gloo groups of 2 and 3 processes
# ---------------------------------------------------------------------------


def _scenario_rows(rank, world, workdir, rec):
    """Uneven local rows, a different shard count on every rank."""
    from auditory_tpu_torch.parallel.distributed import gather_local_rows

    counts = ROWS[world]
    sig, lens = _rows(sum(counts))
    lo = sum(counts[:rank])
    mesh = make_mesh([CPU] * SHARDS[world][rank])
    rec["layout"] = [p.rank for p in mesh.layout]
    rec["local_devices"] = len(mesh.local_devices)
    env = _env()
    (out, valid, stats), pad = at.BatchedSndEnv(env, mesh=mesh).process_local(
        sig[lo:lo + counts[rank]], lens[lo:lo + counts[rank]])
    rec["pad"] = pad
    g_out, g_valid = gather_local_rows((out, valid), counts[rank], pad)
    if rank == 0:
        np.savez(os.path.join(workdir, "rows.npz"), seg_valid=g_valid,
                 **{k: getattr(g_out, k) for k in KEYS},
                 **{f"stats_{k}": v.numpy() for k, v in stats.items()})


def _scenario_segments(rank, world, workdir, rec):
    """The same long batch on every rank, the segment axis over the global
    shards (3 ranks x their shards > the 6 segments: some ranges empty)."""
    from auditory_tpu_torch.parallel.distributed import allgather

    sig, lens = _long(segs=6)
    mesh = make_mesh([CPU] * SHARDS[world][rank])
    (out, valid, stats), pad = at.BatchedSndEnv(
        _env(), mesh=mesh, shard_axis="segment").process_local(sig, lens)
    rec["seg_pad"] = pad
    rec["local_segments"] = int(out.mel_fbank_segment.shape[1])
    g_out, g_valid = allgather((out, valid), axis=1)
    if rank == 0:
        np.savez(os.path.join(workdir, "segments.npz"), seg_valid=g_valid,
                 **{k: getattr(g_out, k) for k in KEYS},
                 **{f"stats_{k}": v.numpy() for k, v in stats.items()})


def _scenario_corpus(rank, world, workdir, rec):
    paths = sorted(glob.glob(os.path.join(workdir, "corpus", "*.wav")))
    runner = at.CorpusRunner(_port_cfg(), SR, batch_size=2, device=CPU)
    stats, summary = runner.run_distributed(paths, os.path.join(workdir, "features"))
    rec["files_done"] = stats.files_done
    rec["summary"] = summary
    drifted = paths if rank == 0 else list(reversed(paths))
    try:
        runner.run_distributed(drifted, os.path.join(workdir, "nope"))
    except ValueError as e:
        rec["digest"] = str(e)


def _scenario_fail(rank, world, workdir, rec):
    """Rank 1's run raises; every rank must raise, none may hang."""
    paths = sorted(glob.glob(os.path.join(workdir, "corpus", "*.wav")))
    runner = at.CorpusRunner(_port_cfg(), SR, batch_size=2, device=CPU)
    if rank == 1:
        def broken(*a, **k):
            raise OSError("disk full")
        runner.run = broken
    t0 = time.perf_counter()
    try:
        runner.run_distributed(paths, os.path.join(workdir, "fail_out"))
    except RuntimeError as e:
        rec["fail"] = str(e)
    rec["fail_seconds"] = time.perf_counter() - t0


SCENARIOS = {
    "two": (_scenario_rows, _scenario_segments, _scenario_corpus,
            _scenario_fail),
    "three": (_scenario_rows, _scenario_segments),
}


def _rank_main(scenario, rank, world, port, workdir):
    """One rank of a spawned gloo group: join, run the scenario's steps,
    write ``rank<k>.json`` with what each step observed."""
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=30)
    rec = {"rank": rank, "world": distributed.process_count(),
           "backend": distributed.data_backend()}
    try:
        for step in SCENARIOS[scenario]:
            step(rank, world, workdir, rec)
            distributed.barrier(step.__name__)
    finally:
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        distributed.shutdown()


def _spawn(scenario, world, workdir):
    port = _free_port()
    code = ("import sys; sys.path.insert(0, {!r}); "
            "from tests.test_torch_parallel import _rank_main; "
            "_rank_main({!r}, int(sys.argv[1]), {}, {}, {!r})").format(
                REPO, scenario, world, port, workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # launched highest rank first: the ranks' order comes from the group
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=REPO, env=env)
             for rank in reversed(range(world))]
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    recs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("gloo2"))
    _write_corpus(os.path.join(workdir, "corpus"))
    return workdir, _spawn("two", 2, workdir)


@pytest.fixture(scope="module")
def group3(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("gloo3"))
    return workdir, _spawn("three", 3, workdir)


def _held_rows(workdir, world):
    got = dict(np.load(os.path.join(workdir, "rows.npz")))
    sig, lens = _rows(sum(ROWS[world]))
    jout, jvalid, jstats = _jax_run(sig, lens)
    np.testing.assert_array_equal(got["seg_valid"], np.asarray(jvalid))
    _assert_jax_close(got, jout)
    for k in ("sum", "sumsq", "count"):
        np.testing.assert_allclose(got[f"stats_{k}"], np.asarray(jstats[k]),
                                   rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_group_rows_match_jax(world, group2, group3):
    workdir, recs = {2: group2, 3: group3}[world]
    assert [r["world"] for r in recs] == [world] * world
    assert all(r["backend"] == "gloo" for r in recs)
    _held_rows(workdir, world)


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_group_layout_is_gathered(world, group2, group3):
    """Every rank sees the same rank-major layout, built from what each
    rank reported (shard counts differ per rank), and its own pad."""
    _, recs = {2: group2, 3: group3}[world]
    want = [r for r in range(world) for _ in range(SHARDS[world][r])]
    for r in recs:
        assert r["layout"] == want
        assert r["local_devices"] == SHARDS[world][r["rank"]]
        assert r["pad"] == pad_to_multiple(ROWS[world][r["rank"]],
                                           SHARDS[world][r["rank"]]) - ROWS[world][r["rank"]]


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_group_segments_match_jax(world, group2, group3):
    workdir, recs = {2: group2, 3: group3}[world]
    got = dict(np.load(os.path.join(workdir, "segments.npz")))
    sig, lens = _long(segs=6)
    jout, jvalid, jstats = _jax_run(sig, lens)
    np.testing.assert_array_equal(got["seg_valid"], np.asarray(jvalid))
    _assert_jax_close(got, jout)
    np.testing.assert_allclose(got["stats_count"], np.asarray(jstats["count"]))
    np.testing.assert_allclose(got["stats_sum"], np.asarray(jstats["sum"]), rtol=1e-9)
    n_global = sum(SHARDS[world])
    ranges = split_range(6, n_global)
    per_rank, i = [], 0
    for r in range(world):
        per_rank.append(sum(b - a for a, b in ranges[i:i + SHARDS[world][r]]))
        i += SHARDS[world][r]
    assert [r["local_segments"] for r in recs] == per_rank
    assert all(r["seg_pad"] == 0 for r in recs)


def test_run_distributed_matches_jax_corpus(group2, tmp_path):
    import jax.numpy as jnp

    from auditory_tpu.pipeline.batch import CorpusRunner as JRunner

    workdir, recs = group2
    merged = os.path.join(workdir, "features")
    paths = sorted(glob.glob(os.path.join(workdir, "corpus", "*.wav")))
    assert sum(r["files_done"] for r in recs) == len(paths) == 5
    assert recs[0]["summary"]["files_ok"] == 5 and recs[1]["summary"] is None
    assert recs[0]["summary"]["manifest_shards"] == 2
    ref_dir = str(tmp_path / "ref")
    JRunner(_jax_cfg(), SR, batch_size=4, dtype=jnp.float32).run(paths, ref_dir)
    ref_npz = sorted(f for f in os.listdir(ref_dir) if f.endswith(".npz"))
    assert sorted(f for f in os.listdir(merged) if f.endswith(".npz")) == ref_npz
    for f in ref_npz:
        a, b = dict(np.load(os.path.join(merged, f))), dict(np.load(os.path.join(ref_dir, f)))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k].astype(np.float64), b[k].astype(np.float64),
                                       atol=1e-2, rtol=1e-2, err_msg=f"{f}:{k}")

    def ok_set(path):
        with open(path) as fh:
            return {os.path.basename(json.loads(line)["path"]) for line in fh
                    if json.loads(line).get("status") == "ok"}

    assert ok_set(os.path.join(merged, "manifest.jsonl")) == ok_set(
        os.path.join(ref_dir, "manifest.jsonl"))
    with open(os.path.join(merged, "feature_stats.json")) as f:
        a = json.load(f)
    with open(os.path.join(ref_dir, "feature_stats.json")) as f:
        b = json.load(f)
    assert a["count_steps"] == b["count_steps"]
    np.testing.assert_allclose(a["mel_mean"], b["mel_mean"], rtol=1e-4)
    np.testing.assert_allclose(a["mel_std"], b["mel_std"], rtol=1e-3)


def test_run_distributed_digest_guard(group2):
    _, recs = group2
    for r in recs:
        assert "digests disagree" in r["digest"]


def test_failing_rank_raises_on_every_rank(group2):
    """Rank 1's run() raised: both ranks raise after exchanging the flags,
    naming rank 1 and its error, well inside the collectives' timeout."""
    _, recs = group2
    for r in recs:
        assert "rank(s) [1]" in r["fail"] and "disk full" in r["fail"]
        assert r["fail_seconds"] < 30
