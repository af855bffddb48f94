"""auditory_tpu_torch: the PyTorch/CUDA port of auditory-tpu.

Pipeline: WAV -> float signal -> overlapping windows -> DFT power spectrum ->
mel filterbank (log) -> MFCC (DCT + energy + deltas) -> 2-D gabor
convolution -> (neighbor inhibition) -> FFFB kWTA sparsification, batched
over segments and utterances on one device; :class:`CorpusRunner` extracts
a corpus of WAV files into ``.npz`` features; :class:`OnlineSndEnv` and
:class:`MultiStreamOnline` serve audio streams chunk by chunk, and
:class:`StreamingProcessor` is the processspeech segment cursor. On a CUDA
device the frontend
of the uniform window grid (framing, DFT power, log and mel) is one
hand-written kernel (``ops/framefft.py``, ``csrc/framefft.cu``). The JAX
package ``auditory_tpu`` is the reference this port is tested against; this
package never imports it.
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
from .pipeline.batch import BatchedSndEnv, CorpusRunner, CorpusStats, PackedBatch
from .pipeline.online import BufferOverflow, MultiStreamOnline, OnlineSndEnv
from .pipeline.sndenv import SndEnv, SndEnvOutputs
from .pipeline.streaming import StreamingProcessor

__all__ = [
    "BatchedSndEnv",
    "BufferOverflow",
    "CorpusRunner",
    "CorpusStats",
    "DFTParams",
    "FilterBank",
    "GaborSet",
    "GaborSpec",
    "KWTAParams",
    "MelParams",
    "MultiStreamOnline",
    "NeighInhibParams",
    "OnlineSndEnv",
    "PackedBatch",
    "SndEnv",
    "SndEnvOutputs",
    "SndEnvConfig",
    "StreamingProcessor",
    "WindowParams",
    "default_gabor_specs",
    "msec_to_samples",
    "samples_to_msec",
]
