"""Multi-process execution over ``torch.distributed`` (counterpart of
``auditory_tpu/parallel/distributed.py``).

Every process calls :func:`initialize` with one coordinator address, the
process count and its rank. Each process then runs the pipeline on its own
device over its LOCAL batch rows (:meth:`..pipeline.batch.BatchedSndEnv.
process_local`); the only collective in the hot path is the feature-stats
all-reduce, and :func:`gather_local_rows` / :func:`allgather` copy results to
every rank when a full copy is wanted.

Two process groups, both with a timeout on every collective:

- the control plane is always gloo (the default group): object exchanges
  such as the path-list digest and ok/fail flags, and barriers, which use
  ``monitored_barrier`` so a rank that does not arrive is named;
- device tensors (the stats all-reduce, the gathers) go over NCCL when every
  rank owns a distinct GPU, else over gloo through host copies: NCCL refuses
  two ranks on one device, so several ranks on one card, or on the CPU, use
  gloo.

Each rank pins ``cuda:{local_rank}`` (``LOCAL_RANK`` when set, else the rank
modulo the visible card count) with ``torch.cuda.set_device``, so the ranks
of a multi-GPU host do not all land on GPU 0.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "initialize",
    "shutdown",
    "process_count",
    "process_index",
    "local_device",
    "data_group",
    "data_backend",
    "is_multiprocess_mesh",
    "all_gather_object",
    "all_reduce_sum",
    "global_batch_from_local",
    "allgather",
    "gather_local_rows",
    "barrier",
]

DEFAULT_TIMEOUT_S = 120.0

# this process' pinned device, the device-tensor group (None: the default
# gloo group) and its backend, and the collectives' timeout
_STATE = {"device": None, "data": None, "backend": "gloo",
          "timeout": datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)}


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the process group at ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``) as rank ``process_id`` of ``num_processes``, pin
    this rank's device and choose the device-tensor backend. ``device``:
    None means the card (as every entry point), ``"cpu"`` the host. Returns
    the pinned device."""
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes} "
            "processes"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        local_rank %= torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group(
        "gloo", init_method=addr, world_size=num_processes, rank=process_id,
        timeout=timeout,
    )
    _STATE.update(device=dev, data=None, backend="gloo", timeout=timeout)
    # NCCL only when every rank owns a distinct GPU; every rank takes the
    # same decision from the same gathered placements
    placed = all_gather_object((socket.gethostname(), str(dev)))
    if dev.type == "cuda" and all(d.startswith("cuda") for _, d in placed) \
            and len(set(placed)) == len(placed):
        _STATE["data"] = dist.new_group(backend="nccl", timeout=timeout)
        _STATE["backend"] = "nccl"
    return dev


def shutdown() -> None:
    """Leave the process group (every rank, after its last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, data=None, backend="gloo")


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def local_device() -> torch.device:
    """The device :func:`initialize` pinned (the card when uninitialized)."""
    return _STATE["device"] or resolve_device(None)


def data_group():
    """The device-tensor process group (None is the default gloo group)."""
    return _STATE["data"]


def data_backend() -> str:
    """``"nccl"`` or ``"gloo"``: the backend of the device-tensor group."""
    return _STATE["backend"]


def is_multiprocess_mesh(mesh) -> bool:
    """True when the mesh's shards span more than one process."""
    return mesh.process_count > 1


def all_gather_object(obj: Any) -> List[Any]:
    """``obj`` from every rank, in rank order, over the gloo control plane
    (``[obj]`` without a process group)."""
    if not _grouped():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the device-tensor backend takes it: on the rank's GPU
    for NCCL, on the host for gloo; bool as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if _STATE["backend"] == "nccl":
        return t.to(local_device()).contiguous()
    return t.cpu().contiguous()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over all ranks (a new tensor on ``t``'s device)."""
    if not _grouped():
        return t
    w = _wire(t.detach()).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=data_group())
    return w.to(t.device)


def _gather_leaf(x, axis: int) -> Optional[np.ndarray]:
    """One leaf from every rank, concatenated along ``axis`` in rank order
    (the ranks' extents along ``axis`` may differ), as a host array."""
    if x is None:
        return None
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if not _grouped():
        return t.cpu().numpy()
    is_bool = t.dtype == torch.bool
    sizes = all_gather_object(tuple(t.shape))
    if len({s[:axis] + s[axis + 1:] for s in sizes}) != 1:
        raise ValueError(f"ranks disagree on the shape around axis {axis}: "
                         f"{sizes}")
    top = max(s[axis] for s in sizes)
    w = _wire(t)
    if w.shape[axis] < top:
        pad = list(w.shape)
        pad[axis] = top - w.shape[axis]
        w = torch.cat([w, w.new_zeros(pad)], dim=axis)
    parts = [torch.empty_like(w) for _ in sizes]
    dist.all_gather(parts, w, group=data_group())
    out = np.concatenate([
        p.narrow(axis, 0, s[axis]).cpu().numpy() for p, s in zip(parts, sizes)
    ], axis=axis)
    return out.astype(bool) if is_bool else out


def _map_leaves(fn, tree):
    """Apply ``fn`` to each tensor/array leaf of a dataclass, dict, tuple or
    list tree (None and other values stay as they are), keeping the
    container types."""
    import dataclasses

    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map_leaves(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    return tree  # metadata (ints, strings) passes through


def allgather(tree, axis: int = 0):
    """Every leaf of ``tree`` (tensors or arrays; a dataclass such as
    SndEnvOutputs, a dict, tuple or list of them) concatenated over the
    ranks along ``axis`` in rank order, as host NumPy copies on every rank.
    ``axis=1`` joins segment-sharded results (``shard_axis='segment'``).
    Without a process group the leaves are just copied to the host."""
    return _map_leaves(lambda x: _gather_leaf(x, axis), tree)


def global_batch_from_local(local) -> np.ndarray:
    """The global batch: every rank's ``local`` rows in rank order, on every
    rank (one all-gather; the rank-local row counts may differ). PyTorch has
    no global array type, so unlike the JAX package's metadata-only
    assembly this moves the rows."""
    return _gather_leaf(local, 0)


def gather_local_rows(tree, local_rows: int, pad_rows: int):
    """Full host copies of :meth:`BatchedSndEnv.process_local` outputs on
    every rank, pad-free and in caller order: each rank keeps its first
    ``local_rows`` rows (dropping its own ``pad_rows``, which never cross
    the wire) and the blocks are joined in rank order. The rows each rank
    contributes are exchanged, not assumed, so ranks may hold different row
    counts and any device placement."""
    def own(x):
        if x is None:
            return None
        if x.shape[0] != local_rows + pad_rows:
            raise ValueError(
                f"leaf of {x.shape[0]} rows is not a process_local block of "
                f"{local_rows} + {pad_rows} rows"
            )
        return _gather_leaf(x[:local_rows], 0)

    return _map_leaves(own, tree)


def barrier(name: str = "auditory_tpu_torch_barrier",
            timeout_s: Optional[float] = None) -> None:
    """Block until every rank arrives, over the gloo control plane; past
    the timeout it raises on the ranks that did arrive, naming the ones
    that did not (``monitored_barrier``). ``name`` labels the call site."""
    if not _grouped():
        return
    timeout = (_STATE["timeout"] if timeout_s is None
               else datetime.timedelta(seconds=timeout_s))
    try:
        dist.monitored_barrier(timeout=timeout, wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
