"""FFFB (feedforward + feedback) inhibition dynamics (PyTorch counterpart of
``auditory_tpu/nn/fffb.py``).

Behavioral re-implementation of ``emer/leabra/fffb`` v1.1.48 (an external
dependency of the reference, imported at sound/sndenv.go:19 and used through
``emer/vision/kwta``), following the published Leabra FFFB formulation
(O'Reilly et al., Computational Cognitive Neuroscience, ch. 3):

    ffi   = FF * max(netin_avg + MaxVsAvg*(netin_max - netin_avg) - FF0, 0)
    fbi  += FBDt * (FB * act_avg - fbi)          (time-integrated feedback)
    Gi    = Gi_gain * (ffi + fbi)

Inhibition state is threaded explicitly through the settle loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FFFBParams

__all__ = ["FFFBState", "fffb_init", "fffb_step", "fffb_ffi", "fffb_fb_step"]


class FFFBState(NamedTuple):
    fbi: torch.Tensor  # integrated feedback inhibition (one value per group)
    gi: torch.Tensor   # computed inhibitory conductance (one value per group)


def fffb_init(shape=(), dtype=torch.float32, device=None) -> FFFBState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return FFFBState(fbi=z, gi=z)


def fffb_ffi(
    params: FFFBParams, netin_avg: torch.Tensor, netin_max: torch.Tensor
) -> torch.Tensor:
    """Feedforward inhibition term. Depends only on the (fixed) excitatory
    input statistics, so settle loops compute it once outside the
    iteration."""
    ff_netin = netin_avg + params.max_vs_avg * (netin_max - netin_avg)
    return params.ff * torch.clamp(ff_netin - params.ff0, min=0.0)


def fffb_fb_step(
    params: FFFBParams,
    state: FFFBState,
    ffi: torch.Tensor,
    act_avg: torch.Tensor,
) -> FFFBState:
    """The per-iteration part of the inhibition update: time-integrated
    feedback from the current average activation, combined with the
    precomputed feedforward term."""
    if not params.on:
        return FFFBState(fbi=state.fbi, gi=torch.zeros_like(state.gi))
    fbi = state.fbi + params.fb_dt * (params.fb * act_avg - state.fbi)
    gi = params.gi * (ffi + fbi)
    return FFFBState(fbi=fbi, gi=gi)


def fffb_step(
    params: FFFBParams,
    state: FFFBState,
    netin_avg: torch.Tensor,
    netin_max: torch.Tensor,
    act_avg: torch.Tensor,
) -> FFFBState:
    """One inhibition update for a group (layer or pool); inputs are the
    group's average/max excitatory input and average activation."""
    if not params.on:
        return FFFBState(fbi=state.fbi, gi=torch.zeros_like(state.gi))
    return fffb_fb_step(
        params, state, fffb_ffi(params, netin_avg, netin_max), act_avg
    )
