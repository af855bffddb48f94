"""The port's observability utilities (CPU): named spans in a captured
``torch.profiler`` trace, the Chrome trace file, the scoped NaN detection
(backward only), the device memory counters and the StepTimer, held to the
JAX package's StepTimer on the same steps; and the copied report module
rendering an A/B comparison."""

import json
import os

import numpy as np
import pytest
import torch

from auditory_tpu.utils.profiling import StepTimer as JStepTimer
from auditory_tpu_torch.utils import profiling
from auditory_tpu_torch.utils.profiling import StepTimer

torch.set_num_threads(1)


def test_trace_spans_land_in_the_captured_trace(tmp_path):
    with profiling.capture_trace(str(tmp_path / "prof")) as prof:
        with profiling.trace("auditory_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "auditory_span" in names
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "auditory_span" for e in events)


def test_debug_nans_covers_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with profiling.debug_nans():
        y = torch.sqrt(x).sum()  # forward NaN passes: backward only
        assert torch.isnan(y)
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    assert not torch.is_anomaly_enabled()
    with profiling.debug_nans(False):
        torch.sqrt(x).sum().backward()  # off: no raise


def test_memory_stats():
    stats = profiling.memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
    else:
        assert all(k.startswith("cuda:") for k in stats)


def test_step_timer_matches_jax():
    timers = (StepTimer(16000), JStepTimer(16000))
    for t in timers:
        with t.step(8000):
            pass
        with pytest.raises(ValueError):
            with t.step(16000):
                raise ValueError("retried")
    for t in timers:
        assert t.steps == 2 and t.audio_seconds == 0.5 and t.wall_seconds > 0
    assert set(timers[0].report()) == set(timers[1].report())
    assert StepTimer(16000).rtf == 0.0


def test_report_copy_renders(tmp_path):
    pytest.importorskip("matplotlib")
    from auditory_tpu_torch.utils.report import write_compare_html

    rng = np.random.default_rng(0)
    arrays = {f"{s}_mel_fbank_segment": rng.standard_normal((32, 20))
              for s in ("a", "b")}
    out = write_compare_html(arrays, str(tmp_path / "r.html"),
                             params_a={"win_ms": 25.0}, params_b={"win_ms": 30.0},
                             diff={}, title="t")
    assert os.path.getsize(out) > 1000
