"""A pytest plugin that reports how close each test comes to its float32
bounds:

    python -m pytest -p tests.f32_shares tests/test_torch_*.py

After the run it prints, for every test that computed one, its shares of
the float32 error model's bound (every call of
``auditory_tpu_torch.utils.f32_bounds.share``: max |error| / bound, above
1 wrong): the largest, the largest at most 1 (the worst check the test
holds) and how many are above 1 (controls, which must leave the bound).

With ``--fixed-bounds`` it records instead, for each call of
``numpy.testing.assert_allclose``, max |actual - desired| / (atol + rtol
|desired|) over the finite elements, and the call does not raise, so every
check of a test is measured. Copied into the tests/ of a checkout that
held float32 runs to fixed bounds, it measures them there.
"""

import numpy as np
import pytest

_SHARES = []    # the running test's shares
_BY_TEST = {}   # nodeid -> (largest, largest <= 1, count > 1)


def pytest_addoption(parser):
    parser.addoption("--fixed-bounds", action="store_true",
                     help="measure numpy.testing.assert_allclose's shares "
                          "instead of the float32 model's (calls do not raise)")


def _recording_share(share):
    def wrapped(*args, **kwargs):
        s = share(*args, **kwargs)
        _SHARES.append(s)
        return s
    return wrapped


def _fixed_share(actual, desired, rtol=1e-7, atol=0.0, *args, **kwargs):
    a, d = np.broadcast_arrays(np.asarray(actual, np.float64),
                               np.asarray(desired, np.float64))
    fin = np.isfinite(a) & np.isfinite(d)
    err = np.abs(a - d)[fin]
    tol = atol + rtol * np.abs(d[fin])
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(err == 0, 0.0, err / tol)
    _SHARES.append(float(ratio.max()) if ratio.size else 0.0)


def pytest_configure(config):
    if config.getoption("--fixed-bounds"):
        np.testing.assert_allclose = _fixed_share
    else:
        from auditory_tpu_torch.utils import f32_bounds
        f32_bounds.share = _recording_share(f32_bounds.share)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    _SHARES.clear()
    yield
    if _SHARES:
        held = [s for s in _SHARES if s <= 1.0]
        item.user_properties.append(("f32_shares", (
            max(_SHARES), max(held, default=float("nan")),
            sum(s > 1.0 for s in _SHARES))))


def pytest_runtest_logreport(report):
    # on the controller too when the tests run in xdist workers
    for name, value in report.user_properties:
        if name == "f32_shares" and report.when == "call":
            _BY_TEST[report.nodeid] = value


def pytest_terminal_summary(terminalreporter, config):
    if not _BY_TEST:
        return
    kind = "fixed bound" if config.getoption("--fixed-bounds") else "float32 model"
    terminalreporter.section(f"shares of the {kind}: largest, largest <= 1, "
                             "count > 1")
    for nodeid in sorted(_BY_TEST):
        worst, held, above = _BY_TEST[nodeid]
        terminalreporter.write_line(f"{worst:.4g}\t{held:.4g}\t{above}\t{nodeid}")
