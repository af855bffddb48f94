"""Carry the pipeline's host-built constants into the port's layout.

The pipeline has no trained weights. Its constants -- DFT basis, mel
triangles, DCT-I matrix and gabor bank -- are built on the host from the
config (``dsp/design.py``); the gabor bank is trainable in
``examples/learnable_frontend.py``. :func:`constants_from_numpy` turns the
NumPy arrays the JAX package holds (``SndEnv.mel_des.weights``,
``dct_mat``, ``gabor_bank``, ``design.dft_matrices``, ``analysis_win``)
into the buffers :meth:`auditory_tpu_torch.SndEnv.load_constants` takes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .ops.framefft import pad_basis

__all__ = ["constants_from_numpy"]


def constants_from_numpy(
    mel_weights: np.ndarray,
    dct: np.ndarray,
    gabor_bank: np.ndarray,
    dft_cos: np.ndarray,
    dft_sin: np.ndarray,
    analysis_window: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Host arrays in the design layout -> the ``SndEnv`` buffers:

    - ``mel_weights`` [n_mel, n_bins] -> ``mel_w`` [k_pad, m_pad] (transposed,
      zero-padded to multiples of 128; NaN triangle weights kept);
    - ``dft_cos``/``dft_sin`` [win, n_bins], the unwindowed basis of
      ``design.dft_matrices`` -> [win, k_pad], with ``analysis_window`` [win]
      folded into the rows (as the JAX pipeline folds it);
    - ``dct`` [n_mel, n_mel] and ``gabor_bank`` [n_filters, size_y, size_x]
      unchanged.

    Arrays stay float64; ``SndEnv.load_constants`` casts to its dtype."""
    cos_m = np.asarray(dft_cos, dtype=np.float64)
    sin_m = np.asarray(dft_sin, dtype=np.float64)
    if analysis_window is not None:
        w = np.asarray(analysis_window, dtype=np.float64)[:, None]
        cos_m, sin_m = cos_m * w, sin_m * w
    cos_p, sin_p, mel_p = pad_basis(
        cos_m, sin_m, np.asarray(mel_weights, dtype=np.float64)
    )
    return {
        "dft_cos": cos_p,
        "dft_sin": sin_p,
        "mel_w": mel_p,
        "dct": np.asarray(dct, dtype=np.float64),
        "gabor": np.asarray(gabor_bank, dtype=np.float64),
    }
