"""The port's trainers against the JAX examples: one training step of each
from the same numpy weights (``convert.load_trainer_params``), with loss,
gradients and the Adam update equal to JAX + optax; then the example
modules run as subprocesses on the CPU (the classifier learns on the inline
and npz routes, the frontend learns, resume equals a straight run)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from auditory_tpu.dsp.gabor import convolve as jconvolve
from auditory_tpu_torch.convert import load_trainer_params
from auditory_tpu_torch.examples.learnable_frontend import LearnableFrontend
from auditory_tpu_torch.examples.train_phone_classifier import MLP, example_cfg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides: the losses (three Adam steps) and the first
# step's gradients differ by float32 summation order (a few ulps of sums
# over <= 768 terms). The first Adam step moves a weight by
# u = lr g / (|g| + eps), lr = 3e-3, eps = 1e-8, which is insensitive to g
# except where |g| ~ eps: a gradient error dg moves it by
# min(2 lr, lr eps dg / (|g| + eps)^2), on top of the float32 rounding of
# w + u (ADAM_W). Later steps start from those weights, so only the losses
# are held there.
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol_share=1e-5)
ADAM_W = dict(rtol=1e-5, atol=1e-6)
LR, EPS = 3e-3, 1e-8


def _grad_close(got, ref, rtol, atol_share):
    np.testing.assert_allclose(
        got, ref, rtol=rtol, atol=atol_share * float(np.max(np.abs(ref)))
    )


def _first_step_close(w, w_ref, g_ref):
    dg = GRAD["rtol"] * np.abs(g_ref) + GRAD["atol_share"] * np.abs(g_ref).max()
    lim = (ADAM_W["atol"] + ADAM_W["rtol"] * np.abs(w_ref)
           + np.minimum(2 * LR, LR * EPS * dg / (np.abs(g_ref) + EPS) ** 2))
    assert np.all(np.abs(w - w_ref) <= lim), float(np.max(np.abs(w - w_ref) / lim))


def _check_against_jax(jloss, params, model, loss_fn, names):
    """Three steps' losses, the first step's gradients, and the weights
    after one step (from a fresh copy of ``params``)."""
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jl, jg, _ = _adam_step_jax(jloss, jparams, 3)
    _, _, jp1 = _adam_step_jax(jloss, jparams, 1)
    fresh = {k: v.copy() for k, v in params.items()}
    tl, tg = _adam_step_torch(load_trainer_params(model, params), loss_fn, 3)
    np.testing.assert_allclose(tl, jl, **LOSS)
    orient = lambda t, tr: t.numpy().T if tr else t.numpy()
    for k, (attr, tr) in names.items():
        _grad_close(orient(tg[0][attr], tr), jg[0][k], **GRAD)
    _adam_step_torch(load_trainer_params(model, fresh), loss_fn, 1)
    state = model.state_dict()
    for k, (attr, tr) in names.items():
        _first_step_close(orient(state[attr], tr), jp1[k], jg[0][k])


def _adam_step_jax(loss_fn, params, n_steps):
    opt = optax.adam(3e-3)
    state = opt.init(params)
    losses, grads = [], []
    for _ in range(n_steps):
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
        grads.append({k: np.asarray(v) for k, v in g.items()})
    return losses, grads, {k: np.asarray(v) for k, v in params.items()}


def _adam_step_torch(model, loss_fn, n_steps):
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses, grads = [], []
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        opt.step()
        losses.append(float(loss.detach()))
    return losses, grads


def test_classifier_steps_match_jax_optax():
    """The MLP's losses, gradients and Adam update against the JAX
    example's forward with optax.adam(3e-3), from the same weights."""
    rng = np.random.default_rng(0)
    din, dh, dout, n = 96, 64, 6, 40
    params = {
        "w1": (rng.standard_normal((din, dh)) * (2.0 / din) ** 0.5).astype(np.float32),
        "b1": np.zeros(dh, np.float32),
        "w2": (rng.standard_normal((dh, dout)) * (2.0 / dh) ** 0.5).astype(np.float32),
        "b2": np.zeros(dout, np.float32),
    }
    x = rng.standard_normal((n, din)).astype(np.float32)
    y = rng.integers(0, dout, n)

    def jloss(p):  # examples/train_phone_classifier.py:187-197
        logits = jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    _check_against_jax(
        jloss, params, MLP(din, dh, dout),
        lambda m: F.cross_entropy(m(xt), yt),
        {"w1": ("fc1.weight", True), "b1": ("fc1.bias", False),
         "w2": ("fc2.weight", True), "b2": ("fc2.bias", False)},
    )


def test_frontend_steps_match_jax_optax():
    """The learnable frontend (gabor bank + head): losses, the gradient
    w.r.t. the filters and the head, and the Adam update against the JAX
    example's featurize with optax.adam(3e-3), from the same weights."""
    gset = example_cfg().gabor
    rng = np.random.default_rng(1)
    classes, n = 6, 12
    model = LearnableFrontend(gset, classes)
    nf = model.prior.shape[0]
    params = {
        "filters": model.prior.numpy().copy(),
        "w": (rng.standard_normal((2 * nf, classes)) * (1.0 / nf) ** 0.5).astype(np.float32),
        "b": np.zeros(classes, np.float32),
    }
    mel = rng.standard_normal((n, 3, 32, 14)).astype(np.float32)
    y = rng.integers(0, classes, n)

    def jloss(p):  # examples/learnable_frontend.py:101-121
        g = jconvolve(jnp.asarray(mel), p["filters"], gset)
        z = jnp.mean(g, axis=(1, 2, 3)).reshape(n, -1)
        logits = z @ p["w"] + p["b"]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    mt, yt = torch.as_tensor(mel), torch.as_tensor(y)
    _check_against_jax(
        jloss, params, model, lambda m: F.cross_entropy(m(mt), yt),
        {"filters": ("filters", False), "w": ("head.weight", True),
         "b": ("head.bias", False)},
    )


def test_load_trainer_params_refuses_mismatch():
    with pytest.raises(ValueError, match="unknown parameter set"):
        load_trainer_params(MLP(4, 3, 2), {"w1": np.zeros((4, 3))})
    bad = {"w1": np.zeros((5, 3)), "b1": np.zeros(3), "w2": np.zeros((3, 2)),
           "b2": np.zeros(2)}
    with pytest.raises(ValueError, match="does not fit"):
        load_trainer_params(MLP(4, 3, 2), bad)


def _run(module, *args):
    out = subprocess.run(
        [sys.executable, "-m", f"auditory_tpu_torch.examples.{module}",
         "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _line(stdout, prefix):
    lines = [l for l in stdout.splitlines() if l.startswith(prefix)]
    assert lines, stdout
    return lines[-1]


@pytest.mark.parametrize("route", ["inline", "npz"])
def test_phone_classifier_learns(route):
    out = _run("train_phone_classifier", "--steps", "60", "--n-per-class",
               "10", "--features", route)
    if route == "npz":
        assert "[npz] corpus->features" in out
    acc = float(_line(out, "final test").split()[-3])
    assert acc > 0.5, f"classifier failed to learn: {_line(out, 'final test')}"


def test_learnable_frontend_learns_and_resumes(tmp_path):
    """The loss falls below 0.7x, the filters move off the prior, and 30
    steps + a resume to 60 print the straight 60-step run's final loss and
    accuracy (the checkpoint restores model and Adam state exactly)."""
    common = ("--n-per-class", "10")
    straight = _run("learnable_frontend", "--steps", "60", *common)
    first, last = (float(v) for v in _line(straight, "loss:").split(":")[1].split("->"))
    assert last < 0.7 * first, f"frontend failed to train: {first} -> {last}"
    assert float(_line(straight, "filter drift").split()[-3]) > 0.01

    ck = str(tmp_path / "ck")
    _run("learnable_frontend", "--steps", "30", "--ckpt-dir", ck,
         "--ckpt-every", "30", *common)
    os.makedirs(os.path.join(ck, "step_99.tmp-1"))  # a save cut short
    resumed = _run("learnable_frontend", "--steps", "60", "--ckpt-dir", ck,
                   *common)
    assert "resumed from step_30 (step 30)" in resumed
    assert (_line(straight, "loss:").split("->")[1]
            == _line(resumed, "loss:").split("->")[1])
    assert _line(straight, "final test") == _line(resumed, "final test")
    assert sorted(os.listdir(ck)) == ["step_30", "step_50", "step_60",
                                      "step_99.tmp-1"]
