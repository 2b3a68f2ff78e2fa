"""Data-parallel ranks over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py``).

The JAX package drives every device of a 1-D mesh from one process and
XLA inserts the collectives.  The port runs one process per rank: NCCL on
the card (rank r on ``cuda:r``; NCCL needs one card per rank), gloo on the
CPU and for ranks that share one card.  A :class:`Mesh` is one rank's view
of the group: its rank, the group's size, its device and the process group.

The layout, and what it costs:

* parameters, optimiser state and the prompt bank are replicated.  Every
  rank applies the same all-reduced gradients, so the parameters stay
  bit-equal across ranks with no broadcast after a step;
* the cached dataset is replicated too, not row-sharded.  Every rank draws
  the same epoch permutation and takes its contiguous, rank-major slice of
  every padded global batch (:func:`batch_rows`).  The JAX package
  row-shards its device-resident dataset and XLA gathers the permuted rows
  across shards; on ranks that gather would be an all-to-all every epoch,
  while the replicated dataset gives the same batches with no
  communication, at 98 MB a card for the reference's 191,027 x 128 fp32 rows;
* a train step sums its gradients and loss numerators with one
  ``all_reduce`` over one flat buffer (:func:`all_reduce_sum`).  The
  denominators, the global batch's mask counts, are known on every rank
  from the replicated batch, so the loss is one masked mean over the global
  batch, as in the JAX package, and not a mean of the ranks' means;
* eval scores come back to global row order (:func:`gather_rows`) before
  any metric.

Only ``all_reduce`` and ``broadcast`` are used: they are the two
collectives gloo runs on CUDA tensors, and two ranks on one card need gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import sys
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

DATA_AXIS = "data"
# a rank that waits longer than this in the rendezvous or a collective
# raises, instead of hanging until an outer time limit
TIMEOUT_S = 120

DeviceSpec = Union[str, torch.device, Sequence[Union[str, torch.device]]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = dataclasses.field(repr=False, compare=False)


_mesh: Optional[Mesh] = None  # this process's rank, once it joined a group


def current_mesh() -> Optional[Mesh]:
    """The mesh this process joined (:func:`spawn_ranks` or
    :func:`create_mesh`), or ``None``."""
    return _mesh


def _devices(device: DeviceSpec, n: int) -> List[torch.device]:
    """The ranks' devices: ``"cuda"`` is one card a rank (``cuda:r``),
    ``"cpu"`` any number of CPU ranks, a sequence names each rank's."""
    if isinstance(device, (str, torch.device)):
        dev = torch.device(device)
        if dev.type == "cpu":
            return [dev] * n
        resolve_device(dev)  # raises without CUDA
        if dev.index is not None:
            return [dev] * n
        m = torch.cuda.device_count()
        if m < n:
            raise ValueError(f"need {n} devices, have {m}")
        return [torch.device("cuda", r) for r in range(n)]
    devices = [torch.device(d) for d in device]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return devices[:n]


def _backend(devices: Sequence[torch.device], backend: Optional[str]) -> str:
    cuda = devices[0].type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl" and (not cuda or len({d.index for d in devices}) < len(devices)):
        raise ValueError("NCCL needs one card per rank; use backend='gloo' for ranks that "
                         f"share a card or run on the CPU (devices: {[str(d) for d in devices]})")
    return backend


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, size: int, device: torch.device, backend: str, port: int) -> Mesh:
    """Join the group as ``rank`` and check the backend with one collective."""
    global _mesh
    if device.type == "cuda":
        resolve_device(device)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _mesh = Mesh(rank=rank, size=size, device=device, backend=backend, group=dist.group.WORLD)
    barrier(_mesh)  # a backend that cannot run a collective fails here, not mid-run
    return _mesh


def create_mesh(n_devices: Optional[int] = None, devices: Optional[DeviceSpec] = None,
                backend: Optional[str] = None) -> Mesh:
    """This rank's mesh.

    Inside a group (a rank started by :func:`spawn_ranks`) it returns that
    group's view, whose size must be ``n_devices``.  Otherwise it checks
    that ``devices`` (as :func:`spawn_ranks` reads them; default the
    visible cards) hold ``n_devices`` (default 1, or one a listed device)
    as the JAX ``create_mesh`` does, never truncating silently, and starts
    a group of one rank on the first: more ranks than one need a process
    each (:func:`spawn_ranks`).  ``backend`` defaults to NCCL on the card
    and gloo on the CPU; one that fails to start raises."""
    if _mesh is not None:
        if n_devices not in (None, _mesh.size):
            raise ValueError(f"need {n_devices} devices, have {_mesh.size} ranks in this group")
        return _mesh
    spec = "cuda" if devices is None else devices
    n = n_devices or (1 if isinstance(spec, (str, torch.device)) else len(spec))
    devs = _devices(spec, n)
    if n > 1:
        raise ValueError(f"a mesh of {n} ranks runs one process a rank: start them with "
                         "spawn_ranks")
    return _join(0, 1, devs[0], _backend(devs[:1], backend), _free_port())


def destroy_mesh() -> None:
    """Leave the group (a no-op outside one)."""
    global _mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh = None


# ----------------------------------------------------------------------
# Rows and collectives
# ----------------------------------------------------------------------
def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_bounds(mesh: Mesh, n_rows: int):
    """(start, stop) of this rank's rows of an ``n_rows`` batch: contiguous,
    rank-major, ceil(n_rows / size) rows a rank (the last shards may be
    shorter or empty when the size does not divide ``n_rows``)."""
    per = -(-n_rows // mesh.size)
    start = min(mesh.rank * per, n_rows)
    return start, min(start + per, n_rows)


def batch_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a global batch (a view)."""
    start, stop = shard_bounds(mesh, x.shape[0])
    return x[start:stop]


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; every rank gets the same bits."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def gather_rows(mesh: Mesh, x_local: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The ``n_rows`` global batch from every rank's :func:`batch_rows`
    slice, in row order, on every rank: each rank writes its rows into a
    zero buffer and the buffers are summed (exact: x + 0 = x)."""
    start, stop = shard_bounds(mesh, n_rows)
    if x_local.shape[0] != stop - start:
        raise ValueError(f"rank {mesh.rank} holds {x_local.shape[0]} rows; its shard of "
                         f"{n_rows} is {stop - start}")
    out = x_local.new_zeros((n_rows, *x_local.shape[1:]))
    out[start:stop] = x_local
    return all_reduce_sum(mesh, out)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all_reduce of one scalar)."""
    all_reduce_sum(mesh, torch.zeros(1, device=mesh.device))


def replicate(mesh: Mesh, tree):
    """Rank 0's tensors on every rank (broadcast), for a state restored from
    disk or built apart on each rank; dicts, lists, tuples and NamedTuples
    keep their structure, and no input is written into."""
    if isinstance(tree, torch.Tensor):
        out = tree.detach().clone()
        dist.broadcast(out, src=0, group=mesh.group)
        return out
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(mesh, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------
def _rank_main(fn, rank, size, device, backend, port, results, args):
    """A spawned rank: join the group, run ``fn(*args)``, report.  Ranks
    above 0 print nothing (their standard output goes to the null device)."""
    try:
        if rank > 0:
            sys.stdout = open(os.devnull, "w")
        _join(rank, size, device, backend, port)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent raises with it
        raise
    finally:
        destroy_mesh()


def spawn_ranks(fn: Callable, n: int, device: DeviceSpec, *args, backend: Optional[str] = None):
    """Run ``fn(*args)`` on ``n`` ranks, one process each (the ``spawn``
    start method: ``fn`` and ``args`` must pickle, ``fn`` importable), after
    each joined the group on a free local port; inside, :func:`create_mesh`
    returns the rank's mesh.  ``device`` is ``"cuda"`` (rank r on
    ``cuda:r``), ``"cpu"``, or each rank's device.  Returns the ranks'
    return values in rank order.  If a rank fails, the others are stopped
    and this raises with that rank's traceback."""
    import multiprocessing

    devices = _devices(device, n)
    backend = _backend(devices, backend)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, devices[r], backend, port, results,
                                                   args))
             for r in range(n)]
    for p in procs:
        p.start()
    out: dict = {}
    try:
        while len(out) < n:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {n} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(n)]
