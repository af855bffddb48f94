"""auditory_tpu_torch: the PyTorch/CUDA port of auditory-tpu.

Pipeline: WAV -> float signal -> overlapping windows -> DFT power spectrum ->
mel filterbank (log) -> MFCC (DCT + energy + deltas) -> 2-D gabor
convolution -> FFFB kWTA sparsification, batched over segments and
utterances on one device. On a CUDA device the frontend (framing, DFT power,
log and mel) is one hand-written kernel (``ops/framefft.py``,
``csrc/framefft.cu``). The JAX package ``auditory_tpu`` is the reference
this port is tested against; this package never imports it.
"""

from .config import (
    DFTParams,
    FilterBank,
    GaborSet,
    GaborSpec,
    KWTAParams,
    MelParams,
    NeighInhibParams,
    SndEnvConfig,
    WindowParams,
    default_gabor_specs,
    msec_to_samples,
    samples_to_msec,
)
from .pipeline.batch import BatchedSndEnv
from .pipeline.sndenv import SndEnv, SndEnvOutputs

__all__ = [
    "BatchedSndEnv",
    "DFTParams",
    "FilterBank",
    "GaborSet",
    "GaborSpec",
    "KWTAParams",
    "MelParams",
    "NeighInhibParams",
    "SndEnv",
    "SndEnvOutputs",
    "SndEnvConfig",
    "WindowParams",
    "default_gabor_specs",
    "msec_to_samples",
    "samples_to_msec",
]
