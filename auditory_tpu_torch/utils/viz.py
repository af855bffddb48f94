"""Headless visualization export.

The reference validates by eye: GoGi tensor-grid tabs render power/mel/MFCC/
gabor tensors (examples/gaborview/gbv.go:1209-1313,
examples/processspeech/processspeech.go:503-512) and
``agabor.FilterSet.ToTable`` exists "for display and validation purposes"
(agabor/gabor.go:318-326). This module restores that capability without a GUI:
render any pipeline ``.npz`` (or in-memory dict of arrays) and the rendered
gabor bank to PNGs.

matplotlib is an optional dependency, gated like the audio backend: callers
get a clean :class:`RuntimeError` (and the CLI exits rc=2) when it is absent.

Color rules (fixed, not configurable): magnitude tensors use a single
perceptually-uniform, luminance-monotonic sequential ramp; signed tensors
(gabor filters, MFCC deltas) use a two-hue diverging ramp centered on a
neutral midpoint at zero. Identity/annotation text stays in neutral ink.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

__all__ = ["render_npz", "render_gabor_bank", "render_array", "render_compare"]

_SEQ_CMAP = "magma"  # luminance-monotonic sequential (magnitude)
_DIV_CMAP = "RdBu_r"  # two hues + neutral midpoint (polarity)


def _require_mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")  # headless
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover - env without matplotlib
        raise RuntimeError(
            "visualization requires matplotlib, which is not installed"
        ) from e
    return plt


def _cmap_and_norm(arr: np.ndarray):
    """Sequential ramp for magnitudes; diverging ramp centered at 0 for
    signed data (polarity must get a neutral midpoint, not a hue)."""
    # nan- AND inf-aware: the pipeline legitimately emits NaN mel values
    # (the NaN triangle quirk), and external npz files can carry infs;
    # non-finite color limits would blank or degenerate the panel
    finite = arr[np.isfinite(arr)]
    amin = float(finite.min()) if finite.size else 0.0
    amax = float(finite.max()) if finite.size else 1.0
    if amin < 0 < amax:
        bound = max(abs(amin), abs(amax))
        return _DIV_CMAP, -bound, bound
    return _SEQ_CMAP, amin, amax


def render_array(
    arr: np.ndarray,
    path: str,
    title: str = "",
    xlabel: str = "step",
    ylabel: str = "",
    max_panels: int = 16,
) -> str:
    """Render one tensor to ``path`` (PNG).

    - 1-D: line plot over steps.
    - 2-D [Y, X]: heatmap, origin lower (freq/mel row 0 at the bottom,
      matching the reference's tensor-grid orientation).
    - 3-D [seg, Y, X]: grid of per-segment heatmaps (first ``max_panels``)
      with a shared scale and one colorbar.
    """
    plt = _require_mpl()
    arr = np.asarray(arr)
    if arr.dtype == bool:
        arr = arr.astype(np.float64)

    if arr.ndim == 1:
        fig, ax = plt.subplots(figsize=(6, 2.5))
        ax.plot(arr, lw=2, color="#2a6fdb")
        ax.set_xlabel(xlabel)
        ax.set_title(title, fontsize=10)
        ax.grid(alpha=0.25, lw=0.5)
    elif arr.ndim == 2:
        # cap the figure size: figsize scales with the array but matplotlib
        # aborts above 2^16 pixels per side; imshow resamples fine at the
        # cap (an 8-minute utterance's [n_seg, steps] energy would
        # otherwise exceed the limit at dpi 100+)
        fig, ax = plt.subplots(
            figsize=(
                min(max(3.0, arr.shape[1] / 8), 60.0),
                min(max(2.5, arr.shape[0] / 8), 60.0),
            )
        )
        cmap, vmin, vmax = _cmap_and_norm(arr)
        im = ax.imshow(
            arr, aspect="auto", origin="lower", cmap=cmap, vmin=vmin, vmax=vmax
        )
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_title(f"{title}  {arr.shape}", fontsize=10)
        fig.colorbar(im, ax=ax, shrink=0.85)
    elif arr.ndim == 3:
        n = min(arr.shape[0], max_panels)
        cols = min(n, 4)
        rows = -(-n // cols)
        cmap, vmin, vmax = _cmap_and_norm(arr[:n])
        fig, axes = plt.subplots(
            rows, cols, figsize=(3 * cols, 2.4 * rows), squeeze=False
        )
        im = None
        for i in range(rows * cols):
            ax = axes[i // cols][i % cols]
            if i >= n:
                ax.axis("off")
                continue
            im = ax.imshow(
                arr[i], aspect="auto", origin="lower",
                cmap=cmap, vmin=vmin, vmax=vmax,
            )
            ax.set_title(f"seg {i}", fontsize=8)
            ax.tick_params(labelsize=6)
        if arr.shape[0] > n:
            fig.suptitle(
                f"{title}  {arr.shape} (first {n} of {arr.shape[0]} segments)",
                fontsize=10,
            )
        else:
            fig.suptitle(f"{title}  {arr.shape}", fontsize=10)
        if im is not None:
            fig.colorbar(im, ax=[a for row in axes for a in row], shrink=0.8)
    else:
        # flatten leading axes to panels
        return render_array(
            arr.reshape((-1,) + arr.shape[-2:]), path, title, xlabel, ylabel,
            max_panels,
        )

    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def _compare_pairs(data: Mapping[str, np.ndarray]) -> List[str]:
    """Base keys present on both sides of a ``cli segment --compare`` npz
    (``a_<key>`` + ``b_<key>``)."""
    return sorted(
        k[2:] for k in data if k.startswith("a_") and ("b_" + k[2:]) in data
    )


def _as_2d(arr: np.ndarray) -> np.ndarray:
    """Collapse leading axes so a tensor fits one comparison heatmap
    (1-D arrays become one-row heatmaps: a mixed-rank A/B pair -- e.g. a
    config change that collapses an axis -- must still render side by side
    rather than crash on ``shape[1]``)."""
    if arr.ndim == 1:
        return arr[None, :]
    if arr.ndim <= 2:
        return arr
    return arr.reshape(-1, arr.shape[-1])


def render_compare(
    data: Union[str, Mapping[str, np.ndarray]],
    out_dir: str,
    keys: Optional[List[str]] = None,
) -> List[str]:
    """Side-by-side A/B rendering of a ``cli segment --compare`` output —
    the visual half of the reference explorer's dual-parameter capability
    (gaborview's two result tab sets, gbv.go:243-258, 1209-1313).

    For every base key ``X`` present as both ``a_X`` and ``b_X``: 1-D arrays
    plot as two labeled lines on one axes; 2-D arrays render as A | B
    heatmaps on one shared color scale, plus a diverging B−A difference
    panel when the shapes match. Writes ``out_dir/compare_<X>.png`` per key
    and returns the paths.
    """
    plt = _require_mpl()
    if isinstance(data, str):
        data = dict(np.load(data))
    pairs = _compare_pairs(data)
    if keys is not None:
        keys = [k.strip() for k in keys if k.strip()]
        unknown = [k for k in keys if k not in pairs]
        if unknown:
            raise RuntimeError(
                f"no a_/b_ pair for key(s) {unknown}; paired: {pairs}"
            )
        pairs = [k for k in pairs if k in keys]
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    for k in pairs:
        a = np.asarray(data["a_" + k])
        b = np.asarray(data["b_" + k])
        if a.size == 0 or b.size == 0:
            continue
        if a.dtype == bool:
            a = a.astype(np.float64)
        if b.dtype == bool:
            b = b.astype(np.float64)
        path = os.path.join(out_dir, f"compare_{k}.png")
        if a.ndim == 1 and b.ndim == 1:
            fig, ax = plt.subplots(figsize=(6, 2.5))
            ax.plot(a, lw=2, color="#2a6fdb", label="A")
            ax.plot(b, lw=2, color="#d1495b", label="B")
            ax.set_xlabel("step")
            ax.set_title(k, fontsize=10)
            ax.legend(fontsize=8)
            ax.grid(alpha=0.25, lw=0.5)
        else:
            a2, b2 = _as_2d(a), _as_2d(b)
            same = a2.shape == b2.shape
            ncols = 3 if same else 2
            width = min(max(3.0, max(a2.shape[1], b2.shape[1]) / 8), 60.0)
            height = min(max(2.5, max(a2.shape[0], b2.shape[0]) / 8), 60.0)
            fig, axes = plt.subplots(
                1, ncols, figsize=(width * ncols, height), squeeze=False
            )
            # one shared scale across both sides, so differences read true
            both = np.concatenate([a2.ravel(), b2.ravel()])
            cmap, vmin, vmax = _cmap_and_norm(both)
            im = None
            for ax, arr, side in zip(axes[0], (a2, b2), ("A", "B")):
                im = ax.imshow(
                    arr, aspect="auto", origin="lower",
                    cmap=cmap, vmin=vmin, vmax=vmax,
                )
                ax.set_title(f"{side}  {arr.shape}", fontsize=9)
                ax.set_xlabel("step")
            fig.colorbar(im, ax=list(axes[0][:2]), shrink=0.85)
            if same:
                d = b2 - a2
                fin = np.abs(d[np.isfinite(d)])  # NaN-safe diff bound
                bound = float(fin.max()) if fin.size and fin.max() > 0 else 1.0
                imd = axes[0][2].imshow(
                    d, aspect="auto", origin="lower",
                    cmap=_DIV_CMAP, vmin=-bound, vmax=bound,
                )
                axes[0][2].set_title("B − A", fontsize=9)
                axes[0][2].set_xlabel("step")
                fig.colorbar(imd, ax=axes[0][2], shrink=0.85)
            fig.suptitle(k, fontsize=10, y=1.06)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


def render_npz(
    data: Union[str, Mapping[str, np.ndarray]],
    out_dir: str,
    keys: Optional[List[str]] = None,
    max_panels: int = 16,
) -> List[str]:
    """Render every array of a pipeline ``.npz`` (or dict) to
    ``out_dir/<key>.png``; returns the written paths. The de-facto
    validation surface of the reference (gbv.go:1209-1313).

    A ``cli segment --compare`` npz (paired ``a_*``/``b_*`` keys) is
    detected automatically when ``keys`` is not given: each pair renders as
    one side-by-side :func:`render_compare` figure instead of two separate
    files. Passing explicit ``keys`` always renders exactly those arrays.
    """
    if isinstance(data, str):
        data = dict(np.load(data))
    if keys is not None:
        keys = [k.strip() for k in keys if k.strip()]
        unknown = [k for k in keys if k not in data]
        if unknown:
            raise RuntimeError(
                f"unknown key(s) {unknown}; available: {sorted(data)}"
            )
    os.makedirs(out_dir, exist_ok=True)
    written = []
    paired: set = set()
    if keys is None:
        pairs = _compare_pairs(data)
        if pairs:
            written += render_compare(data, out_dir, keys=pairs)
            paired = {p + "_" + k for p in ("a", "b") for k in pairs}
    for k in sorted(keys if keys is not None else data):
        if k in paired:
            continue
        arr = np.asarray(data[k])
        if arr.size == 0:
            continue
        ylabel = "mel band" if "mel" in k else ("freq bin" if "power" in k else "")
        path = os.path.join(out_dir, f"{k}.png")
        written.append(
            render_array(arr, path, title=k, ylabel=ylabel, max_panels=max_panels)
        )
    return written


def render_gabor_bank(gset, path: str) -> str:
    """Render the full gabor filter bank (the agabor.FilterSet.ToTable
    display surface, agabor/gabor.go:318-326) as a grid of diverging-ramp
    patches annotated with orientation/wavelength/phase."""
    plt = _require_mpl()
    from ..dsp.design import gabor_table

    table = gabor_table(gset)
    filters = table["filters"]
    n = filters.shape[0]
    cols = min(n, 8)
    rows = -(-n // cols)
    bound = float(np.max(np.abs(filters))) or 1.0
    fig, axes = plt.subplots(
        rows, cols, figsize=(1.6 * cols, 1.9 * rows), squeeze=False
    )
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= n:
            continue
        ax.imshow(
            filters[i], cmap=_DIV_CMAP, vmin=-bound, vmax=bound,
            origin="lower", interpolation="nearest",
        )
        ax.set_title(
            f"{table['orientation'][i]:.0f}° λ={table['wavelen'][i]:.0f} "
            f"φ={table['phase_offset'][i]:.2f}",
            fontsize=7,
        )
    fig.suptitle(
        f"gabor bank: {n} filters {table['size_y']}x{table['size_x']}",
        fontsize=10,
    )
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
