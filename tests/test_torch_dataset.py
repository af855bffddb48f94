"""The port's FeatureDataset against the JAX package's on the same corpus
directory: the same order for a seed, the npz contents bit for bit, the
remainder, normalization, labels and the error cases."""

import json
import shutil

import numpy as np
import pytest
import torch

import auditory_tpu_torch as at
from auditory_tpu.pipeline.batch import CorpusRunner as JaxCorpusRunner
from auditory_tpu.pipeline.dataset import FeatureDataset as JaxFeatureDataset
from tests.conftest import default_cfg_2d, tone

# the entry points default to the card; the CPU tests ask for the host
CPU = torch.device("cpu")

torch.set_num_threads(1)

SR = 16000


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    from auditory_tpu.io.wav import float_to_wave, write_wav

    d = tmp_path_factory.mktemp("tds")
    wavs = d / "wavs"
    wavs.mkdir()
    paths = []
    for i, dur in enumerate([0.3, 0.45, 0.6, 0.3, 0.5, 0.35, 0.4]):
        p = str(wavs / f"u{i}.wav")
        write_wav(p, float_to_wave(tone(350.0 + 150 * i, dur, SR), SR))
        paths.append(p)
    out = d / "out"
    JaxCorpusRunner(default_cfg_2d(), SR, batch_size=3).run(paths, str(out))
    return str(out)


def _label(stem):
    return int(stem[1:])


def _assert_batches_equal(jb, tb):
    assert [len(b["stem"]) for b in jb] == [len(b["stem"]) for b in tb]
    for j, t in zip(jb, tb):
        assert sorted(j) == sorted(t)
        assert t["stem"] == j["stem"] and isinstance(t["stem"], list)
        for k, v in j.items():
            if k == "stem":
                continue
            assert isinstance(t[k], torch.Tensor), k
            assert t[k].device.type == "cpu"
            got = t[k].numpy()
            assert got.dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, v, err_msg=k)


@pytest.mark.parametrize("seed", [None, 0, 7])
@pytest.mark.parametrize("batch_size,drop", [(2, False), (3, True), (10, False)])
def test_batches_equal_jax(corpus_dir, seed, batch_size, drop):
    """Every key, mask, count and label, in the same order for a seed and
    with the same remainder rule."""
    j = JaxFeatureDataset(corpus_dir, label_fn=_label)
    t = at.FeatureDataset(corpus_dir, label_fn=_label)
    assert t.stems == j.stems and t.keys == j.keys and len(t) == len(j) == 7
    _assert_batches_equal(
        list(j.batches(batch_size, seed=seed, drop_remainder=drop)),
        list(t.batches(batch_size, seed=seed, drop_remainder=drop, device=CPU)),
    )


def test_batches_are_the_npz_contents(corpus_dir):
    t = at.FeatureDataset(corpus_dir)
    for b in t.batches(3, seed=1, device=CPU):
        for i, stem in enumerate(b["stem"]):
            n = int(b["n_seg"][i])
            raw = t.load(stem)
            for k in t.keys:
                np.testing.assert_array_equal(b[k][i, :n].numpy(), raw[k])
                assert torch.all(b[k][i, n:] == 0)
            assert b["seg_valid"][i, :n].all() and not b["seg_valid"][i, n:].any()


def test_normalize_equals_jax(corpus_dir):
    keys = ("mel_fbank_segment",)
    j = JaxFeatureDataset(corpus_dir, keys=keys)
    t = at.FeatureDataset(corpus_dir, keys=keys)
    for a, b in zip(j.normalizer(), t.normalizer()):
        np.testing.assert_array_equal(a, b)
    _assert_batches_equal(list(j.batches(4, seed=3, normalize=True)),
                          list(t.batches(4, seed=3, normalize=True, device=CPU)))


def test_errors_match_jax(corpus_dir, tmp_path):
    with pytest.raises(FileNotFoundError):
        at.FeatureDataset(str(tmp_path))
    with pytest.raises(ValueError, match="not in the corpus"):
        at.FeatureDataset(corpus_dir, keys=("nope",))
    t = at.FeatureDataset(corpus_dir, keys=("gabor_kwta",))
    with pytest.raises(ValueError, match="normalize=True requires"):
        next(t.batches(2, normalize=True, device=CPU))
    with pytest.raises(ValueError, match="batch_size"):
        next(t.batches(0, device=CPU))
    # no stats file, and a partial one: the JAX refusals
    bare = tmp_path / "bare"
    shutil.copytree(corpus_dir, bare)
    (bare / "feature_stats.json").unlink()
    with pytest.raises(FileNotFoundError, match="feature_stats"):
        at.FeatureDataset(str(bare)).normalizer()
    stats = json.loads(open(f"{corpus_dir}/feature_stats.json").read())
    (bare / "feature_stats.json").write_text(json.dumps({**stats, "partial": True}))
    for cls in (JaxFeatureDataset, at.FeatureDataset):
        with pytest.raises(ValueError, match="partial"):
            cls(str(bare)).normalizer()


def test_port_corpus_reads_like_jax_corpus(corpus_dir, tmp_path):
    """A corpus the port's CorpusRunner wrote reads back through both
    readers alike (same stems, keys and batch layout)."""
    from auditory_tpu_torch.io.wav import float_to_wave, write_wav

    paths = []
    for i, dur in enumerate([0.3, 0.5, 0.4]):
        p = str(tmp_path / f"v{i}.wav")
        write_wav(p, float_to_wave(tone(500.0 + 100 * i, dur, SR), SR))
        paths.append(p)
    out = str(tmp_path / "out")
    at.CorpusRunner(default_cfg_2d(), SR, batch_size=2, device=CPU).run(paths, out)
    j, t = JaxFeatureDataset(out), at.FeatureDataset(out)
    _assert_batches_equal(list(j.batches(2, seed=5, normalize=True)),
                          list(t.batches(2, seed=5, normalize=True, device=CPU)))


def test_cuda_device_refused_without_gpu(corpus_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        next(at.FeatureDataset(corpus_dir).batches(2, device="cuda"))
