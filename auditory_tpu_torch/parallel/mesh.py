"""Device mesh and sharding helpers (counterpart of
``auditory_tpu/parallel/mesh.py``).

The scaling model is data parallelism over utterances: a 1-D mesh with a
``data`` axis whose shards each take a contiguous block of batch rows; the
pipeline is pointwise per utterance, so only the feature-stats moments cross
shards. For few very long utterances :func:`segment_sharding` splits the
*segment* axis instead (segments are independent when ``prev_smooth == 0``).

PyTorch has no one-process, many-device mesh type, so :class:`Mesh` is a
small record: this process' devices (one entry per shard; a device may be
listed more than once, each entry its own shard), the axis name, the process
group of a multi-process run, and the global layout of every rank's
placement, gathered from the ranks themselves (never assumed).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Mesh",
    "Placement",
    "check_mesh",
    "make_mesh",
    "batch_sharding",
    "segment_sharding",
    "split_range",
    "pad_to_multiple",
]


@dataclass(frozen=True)
class Placement:
    """Where one shard of a mesh lives: the owning rank, its host, and the
    device (``str(torch.device)``, e.g. ``cuda:1``)."""

    rank: int
    host: str
    device: str


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh.

    ``local_devices``: this process' shards, one device each.
    ``group``: the process group of a multi-process run (None for one
    process). ``layout``: every shard's :class:`Placement` in rank-major
    order, as the ranks reported them."""

    local_devices: Tuple[torch.device, ...]
    axis_name: str = "data"
    group: Optional[object] = None
    layout: Tuple[Placement, ...] = ()

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return len(self.layout)

    @property
    def local_size(self) -> int:
        return len(self.local_devices)

    @property
    def process_count(self) -> int:
        return len({p.rank for p in self.layout})


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` itself when it is None or a :class:`Mesh`; anything else
    raises TypeError."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be an auditory_tpu_torch.parallel.mesh.Mesh "
            f"(make_mesh()), got {type(mesh).__name__}"
        )
    return mesh


def _named_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with a bare ``cuda`` named by its
    index (the current device), so that the same card compares equal
    however it was written."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _local_placements(rank: int, devices) -> Tuple[Placement, ...]:
    host = socket.gethostname()
    return tuple(Placement(rank, host, str(d)) for d in devices)


def make_mesh(
    devices: Optional[Sequence] = None, axis_name: str = "data"
) -> Mesh:
    """1-D mesh over this process' ``devices``.

    Default: every visible GPU when no process group is initialized, else
    this rank's device (:func:`..parallel.distributed.initialize` pins it).
    Under a process group the layout is all-gathered from every rank (each
    reports its own host and devices), rank-major."""
    import torch.distributed as dist

    from . import distributed

    grouped = dist.is_available() and dist.is_initialized()
    if devices is None:
        if grouped:
            devices = [distributed.local_device()]
        else:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "make_mesh(): no CUDA device; pass devices=[...] (e.g. "
                    "[torch.device('cpu')] * 4) to shard on the host"
                )
            devices = [torch.device("cuda", i) for i in range(n)]
    # a bare 'cuda' is the current device: name it, so placements compare
    devs = tuple(_named_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if not grouped:
        return Mesh(devs, axis_name, None, _local_placements(0, devs))
    rank = dist.get_rank()
    layout = distributed.all_gather_object(_local_placements(rank, devs))
    flat = tuple(p for per_rank in sorted(layout, key=lambda ps: ps[0].rank)
                 for p in per_rank)
    return Mesh(devs, axis_name, distributed.data_group(), flat)


def batch_sharding(mesh: Mesh, n: int) -> Tuple[slice, ...]:
    """The contiguous block of each local shard out of ``n`` rows (or
    segments): sizes differ by at most one, larger blocks first, so a row
    count padded to a multiple of ``mesh.local_size``
    (:func:`pad_to_multiple`) splits evenly."""
    return tuple(slice(a, b) for a, b in split_range(n, mesh.local_size))


def split_range(n: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """``n`` items as ``parts`` contiguous (start, stop) ranges whose sizes
    differ by at most one, the larger first (some empty when n < parts)."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n), parts)])
    return tuple((int(bounds[i]), int(bounds[i + 1])) for i in range(parts))


# Shard axis = the segment axis of a single long utterance (CP-style): the
# same contiguous-block partition as batch_sharding, kept as a semantic
# alias so the two can never diverge.
segment_sharding = batch_sharding


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
