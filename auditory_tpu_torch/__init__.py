"""auditory_tpu_torch: the PyTorch/CUDA port of auditory-tpu.

Pipeline: WAV -> float signal -> overlapping windows -> DFT power spectrum ->
mel filterbank (log) -> MFCC (DCT + energy + deltas) -> 2-D gabor
convolution -> (neighbor inhibition) -> FFFB kWTA sparsification, batched
over segments and utterances on one device; :class:`CorpusRunner` extracts
a corpus of WAV files into ``.npz`` features; :class:`OnlineSndEnv` and
:class:`MultiStreamOnline` serve audio streams chunk by chunk, and
:class:`StreamingProcessor` is the processspeech segment cursor;
:class:`SegmentPipeline` and :func:`compare_segments` run one phone slice
at a time (the gaborview path), and :class:`FeatureDataset` reads a corpus
back as padded batches for training. On a CUDA device the frontend of the
uniform window grid (framing, DFT power, log and mel) is one hand-written
kernel (``ops/framefft.py``, ``csrc/framefft.cu``), applied as an autograd
Function: the pipeline differentiates w.r.t. the signals and any constant
made a parameter (the gabor bank), on both devices; call ``backward()``
inside :func:`precision_tier`. ``auditory_tpu_torch.examples`` holds the
trainers, the gaborview and processspeech apps and the serving demo. The JAX package ``auditory_tpu`` is the
reference this port is tested against; this package never imports it.
"""

__version__ = "0.5.0"

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
from .pipeline.dataset import FeatureDataset
from .pipeline.online import BufferOverflow, MultiStreamOnline, OnlineSndEnv
from .pipeline.segments import SegmentPipeline, SegmentWindowParams, compare_segments
from .pipeline.sndenv import SndEnv, SndEnvOutputs, precision_tier
from .pipeline.streaming import StreamingProcessor

__all__ = [
    "BatchedSndEnv",
    "BufferOverflow",
    "CorpusRunner",
    "CorpusStats",
    "DFTParams",
    "FeatureDataset",
    "FilterBank",
    "GaborSet",
    "GaborSpec",
    "KWTAParams",
    "MelParams",
    "MultiStreamOnline",
    "NeighInhibParams",
    "OnlineSndEnv",
    "PackedBatch",
    "SegmentPipeline",
    "SegmentWindowParams",
    "SndEnv",
    "SndEnvOutputs",
    "SndEnvConfig",
    "StreamingProcessor",
    "WindowParams",
    "compare_segments",
    "default_gabor_specs",
    "msec_to_samples",
    "precision_tier",
    "samples_to_msec",
]
