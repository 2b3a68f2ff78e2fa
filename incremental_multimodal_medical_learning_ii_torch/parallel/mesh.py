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

Collectives are ``all_reduce`` and ``broadcast``, the two that gloo runs
on CUDA tensors (two ranks on one card need gloo), and the point-to-point
hop :func:`ppermute`.

A mesh may be 2-D, ``data x inner`` (:func:`create_mesh` with a shape):
the text tower's tensor-, sequence- and pipeline-parallel encodes
(``parallel/tp.py``, ``sp.py``, ``pp.py``) put their ``model``, ``seq`` or
``pipe`` axis inside the data axis, one process a rank, rank ``d * inner +
i``, so the inner axis is the fast-varying one as in the JAX meshes.
:meth:`Mesh.along` is this rank's 1-D line along one axis (its own process
group), and the helpers above take such a line.  :func:`psum`,
:func:`pvary` and :func:`ppermute` are differentiable, as their JAX
counterparts are under ``shard_map``: every rank computes the same
downstream of a :func:`psum`, so its gradient passes through unchanged;
:func:`pvary` sums the gradient of a replicated input over the axis; the
gradient of :func:`ppermute` hops back the other way.

:func:`ppermute` moves a tensor one hop along an axis.  Under NCCL it is
one ``batch_isend_irecv`` (send to the next rank, receive from the
previous); gloo's point-to-point takes CPU tensors only, so a CUDA tensor
on gloo ranks (ranks that share one card) hops through a host copy and
back.  :attr:`Mesh.transport` names the one a mesh uses.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue
import socket
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

DATA_AXIS = "data"
# a rank that waits longer than this in the rendezvous or a collective
# raises, instead of hanging until an outer time limit
TIMEOUT_S = 120

DeviceSpec = Union[str, torch.device, Sequence[Union[str, torch.device]]]


Shape = Union[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a group: a 1-D line (``rank`` and ``size`` along
    its one axis, ``group`` its process group, ``ranks`` the members'
    global ranks) or a 2-D view (``rank`` and ``size`` in the whole group,
    ``lines`` this rank's line along each axis)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = dataclasses.field(repr=False, compare=False)
    axes: Optional[Tuple[Tuple[str, int], ...]] = None  # (name, size), slowest first
    ranks: Optional[Tuple[int, ...]] = None
    lines: Optional[Dict[str, "Mesh"]] = dataclasses.field(default=None, repr=False,
                                                             compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the JAX ``Mesh.shape``."""
        return dict(self.axes) if self.axes else {DATA_AXIS: self.size}

    def along(self, axis: str) -> "Mesh":
        """This rank's 1-D line along ``axis``."""
        if self.lines is not None:
            return self.lines[axis]
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r}; its axes are {list(self.shape)}")
        return self

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.along(axis).rank

    @property
    def transport(self) -> str:
        """How :func:`ppermute` moves a tensor between ranks."""
        if self.backend == "nccl":
            return "nccl batch_isend_irecv"
        if self.device.type == "cuda":
            return "gloo isend/irecv through host copies"
        return "gloo isend/irecv"


_mesh: Optional[Mesh] = None  # this process's rank, once it joined a group
_views: Dict[Tuple, Mesh] = {}  # the group's 2-D views, made once a shape (subgroups are collective)


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
    _mesh = Mesh(rank=rank, size=size, device=device, backend=backend, group=dist.group.WORLD,
                 axes=((DATA_AXIS, size),), ranks=tuple(range(size)))
    barrier(_mesh)  # a backend that cannot run a collective fails here, not mid-run
    return _mesh


def _size(shape: Optional[Shape]) -> Optional[int]:
    return shape if shape is None or isinstance(shape, int) else math.prod(shape)


def create_mesh(n_devices: Optional[Shape] = None, devices: Optional[DeviceSpec] = None,
                backend: Optional[str] = None,
                axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """This rank's mesh.

    Inside a group (a rank started by :func:`spawn_ranks`) it returns that
    group's view, whose size must be ``n_devices``.  Otherwise it checks
    that ``devices`` (as :func:`spawn_ranks` reads them; default the
    visible cards) hold ``n_devices`` (default 1, or one a listed device)
    as the JAX ``create_mesh`` does, never truncating silently, and starts
    a group of one rank on the first: more ranks than one need a process
    each (:func:`spawn_ranks`).  ``backend`` defaults to NCCL on the card
    and gloo on the CPU; one that fails to start raises.

    ``n_devices`` may be a 2-D shape ``(data, inner)`` with ``axis_names``
    (``create_mesh_2d``, ``create_mesh_sp`` and ``create_mesh_pp`` pass
    them): the view then has a line a rank along each axis, each line its
    own process group, made once for the group."""
    n = _size(n_devices)
    if _mesh is not None:
        if n not in (None, _mesh.size):
            raise ValueError(f"need {n} devices, have {_mesh.size} ranks in this group")
        world = _mesh
    else:
        spec = "cuda" if devices is None else devices
        n = n or (1 if isinstance(spec, (str, torch.device)) else len(spec))
        devs = _devices(spec, n)
        if n > 1:
            raise ValueError(f"a mesh of {n} ranks runs one process a rank: start them with "
                             "spawn_ranks")
        world = _join(0, 1, devs[0], _backend(devs[:1], backend), _free_port())
    if isinstance(n_devices, tuple) and len(n_devices) > 1:
        return _view(world, n_devices, tuple(axis_names or ()))
    return world


def _view(world: Mesh, shape: Tuple[int, ...], names: Tuple[str, ...]) -> Mesh:
    """The 2-D ``(data, inner)`` view of ``world``: rank ``d * inner + i``.
    Every rank creates every line's group, in the same order (a rank that
    skipped one would hang in ``new_group``)."""
    if len(shape) != 2 or len(names) != 2:
        raise ValueError(f"a mesh shape is (data, inner) with two axis names; got {shape}, "
                         f"{names}")
    key = (shape, names)
    if key in _views:
        return _views[key]
    n_data, n_inner = shape
    lines = {}
    members = {names[1]: [[d * n_inner + i for i in range(n_inner)] for d in range(n_data)],
               names[0]: [[d * n_inner + i for d in range(n_data)] for i in range(n_inner)]}
    for axis, groups in members.items():
        for ranks in groups:
            group = world.group if len(ranks) == world.size else dist.new_group(
                ranks, timeout=datetime.timedelta(seconds=TIMEOUT_S), backend=world.backend)
            if world.rank in ranks:
                lines[axis] = Mesh(rank=ranks.index(world.rank), size=len(ranks),
                                   device=world.device, backend=world.backend, group=group,
                                   axes=((axis, len(ranks)),), ranks=tuple(ranks))
    view = Mesh(rank=world.rank, size=world.size, device=world.device, backend=world.backend,
                group=world.group, axes=tuple(zip(names, shape)), ranks=world.ranks, lines=lines)
    _views[key] = view
    return view


def destroy_mesh() -> None:
    """Leave the group (a no-op outside one)."""
    global _mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh = None
    _views.clear()


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
    slice, in row order, on every rank: each rank pads its rows with zeros
    to the whole batch and the buffers are summed (exact: x + 0 = x).
    Differentiable as :func:`psum` is."""
    start, stop = shard_bounds(mesh, n_rows)
    if x_local.shape[0] != stop - start:
        raise ValueError(f"rank {mesh.rank} holds {x_local.shape[0]} rows; its shard of "
                         f"{n_rows} is {stop - start}")
    pad = [0, 0] * (x_local.dim() - 1) + [start, n_rows - stop]
    return psum(mesh, mesh.axes[0][0] if mesh.axes else DATA_AXIS, F.pad(x_local, pad))


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


def sum_gradients(mesh: Mesh, named_params, whole: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient after a backward through a partitioned
    program, summed over the ranks of ``mesh`` (a parameter without one
    counts as zeros), on every rank: ``{name: gradient}``.  Parameters
    named with a prefix in ``whole`` keep their own: every rank computed
    their gradient whole (a head run replicated after a gather)."""
    out = {}
    for name, p in named_params:
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        if not name.startswith(tuple(whole)):
            all_reduce_sum(mesh, g)
        out[name] = g
    return out


# ----------------------------------------------------------------------
# Differentiable collectives along one axis (the shard_map primitives)
# ----------------------------------------------------------------------
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=line.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.line.group)
        return g, None


def psum(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``axis`` (``lax.psum``), a new tensor on every rank.
    Every rank computes the same downstream of it, so the gradient each
    rank gets is already the whole one and passes through unchanged."""
    line = mesh.along(axis)
    return x.clone() if line.size == 1 else _Psum.apply(x, line)


def pvary(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``axis``.  For an input
    replicated over the axis of which each rank uses a part (the input of
    a column-parallel linear): each rank's gradient is a partial sum."""
    line = mesh.along(axis)
    return x if line.size == 1 else _Pvary.apply(x, line)


def _hop(line: Mesh, x: torch.Tensor, shift: int, wrap: bool) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` ahead along the line and receive
    from the rank ``shift`` behind; without ``wrap`` the ends neither send
    past the line nor receive from beyond it (a rank with no source gets
    zeros)."""
    n, i = line.size, line.rank
    if wrap and shift % n == 0:
        return x.clone()
    dst = (i + shift) % n if wrap or 0 <= i + shift < n else None
    src = (i - shift) % n if wrap or 0 <= i - shift < n else None
    staged = line.backend != "nccl" and x.device.type != "cpu"  # gloo's p2p takes CPU tensors
    send = x.detach().contiguous()
    send = send.cpu() if staged else send
    recv = torch.zeros_like(send)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send, line.ranks[dst], line.group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv, line.ranks[src], line.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if staged else recv


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, shift, wrap):
        ctx.args = (line, shift, wrap)
        return _hop(line, x, shift, wrap)

    @staticmethod
    def backward(ctx, g):
        line, shift, wrap = ctx.args
        return _hop(line, g, -shift, wrap), None, None, None


def ppermute(mesh: Mesh, axis: str, x: torch.Tensor, shift: int = 1,
             wrap: bool = True) -> torch.Tensor:
    """``x`` from the rank ``shift`` behind along ``axis`` (``lax.ppermute``
    with the permutation ``i -> i + shift``, cyclic with ``wrap``; without
    it the first ``shift`` ranks receive zeros).  Every rank of the line
    calls it.  Its gradient hops back the other way, as JAX transposes
    ``ppermute``."""
    return _Ppermute.apply(x, mesh.along(axis), shift, wrap)


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


def spawn_ranks(fn: Callable, n: Shape, device: DeviceSpec, *args, backend: Optional[str] = None):
    """Run ``fn(*args)`` on ``n`` ranks, one process each (the ``spawn``
    start method: ``fn`` and ``args`` must pickle, ``fn`` importable), after
    each joined the group on a free local port; inside, :func:`create_mesh`
    returns the rank's mesh.  ``n`` may be a 2-D shape ``(data, inner)``
    (its product of ranks; the ranks then build their view with
    ``create_mesh(n, axis_names=...)``).  ``device`` is ``"cuda"`` (rank r
    on ``cuda:r``), ``"cpu"``, or each rank's device.  Returns the ranks'
    return values in rank order.  If a rank fails, the others are stopped
    and this raises with that rank's traceback."""
    import multiprocessing

    n = _size(n)
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
