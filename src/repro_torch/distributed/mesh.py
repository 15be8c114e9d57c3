"""A mesh of ranks over ``torch.distributed``: the counterpart of
``jax.make_mesh`` + ``shard_map`` + the ``lax`` collectives, for the
multi-device DSC program (``core/distributed.py``) and the distributed LM
(``models/moe.py``, ``distributed/pipeline.py``).

One process per mesh rank.  A mesh has one to three named axes (default
``("part", "model")``); ranks are laid out row-major over them, as
``jax.make_mesh`` lays out its devices (``rank = p * M + m`` on a
``(P, M)`` mesh).  Every set of axes has one group per fixed coordinate
of the other axes (``dist.new_group``; the set of all axes is the world).
Inside a rank the collectives are methods of the :class:`MeshComm` that
:func:`spawn` sets up (:func:`current`).  ``axis`` is a name or a tuple
of names taken as one axis, its index row-major in the tuple's order:

* ``axis_index(axis)``, ``axis_size(axis)``;
* ``ppermute(x, axis, perm)``: a rank that receives nothing gets zeros, as
  ``lax.ppermute`` gives (the halo edges depend on it);
* ``all_gather(x, axis)``: the ``[n, ...]`` stack in axis-rank order;
* ``all_to_all(x, axis, split_axis, concat_axis)``: ``lax.all_to_all``'s
  untiled semantics (``x.shape[split_axis] == n``; chunk i goes to rank i
  and the chunks received stack at ``concat_axis`` in source order);
* ``psum`` / ``pmean``: an all-gather, then a sum in axis-rank order 0 ..
  n-1, left to right, on every rank.  Every rank holds the same bits
  whatever the backend's reduction tree.  At n = 2 that is XLA's sum bit
  for bit (one rounded add, which commutes); at n > 2 XLA may associate
  otherwise, so a float sum agrees with the JAX package to a few ulps of
  the largest operand (integer sums, and float sums whose operands are
  zero on all ranks but one, are exact).

The collectives are differentiable where autograd records (a float input
that requires grad); their backward is JAX's transpose, as ``shard_map``
with ``check_vma=False`` differentiates them: ``ppermute`` by the inverse
permutation, ``all_to_all(split=a, concat=b)`` by ``all_to_all(split=b,
concat=a)``, ``all_gather`` by this rank's block of the cotangents summed
over the axis (``psum_scatter``), ``psum`` by ``psum``.

:func:`shard_map` is ``jax.shard_map``'s counterpart on global arguments:
every rank passes the same global arguments, takes its block of each by
its in-spec and its mesh coordinates, runs the body, and all-gathers each
output over the axes of its out-spec, so every rank returns the same
global result.  Its backward follows ``shard_map``'s transpose rule: an
output's cotangent block is divided by the size of the mesh axes its spec
leaves out, and an input's local cotangent is summed over the axes its
spec leaves out, then gathered over the others.  Every rank thus holds
the gradient of the global loss with respect to the global arguments,
the same on every rank.  The ranks must record the same graph (rank
dependent values go through tensors, never through Python branches), so
that their backwards issue the same collectives in the same order.

A spec (:class:`PartitionSpec`, ``jax.sharding.PartitionSpec``'s
counterpart) names the axes that shard each dimension; ``local_block``
cuts a rank's block by it.  ``distributed/partition.py``'s rules build
specs on top of these.

Every collective moves its payload as raw bytes, so a transport never
rounds.  The transport is an explicit
argument of the mesh, never chosen silently:

* ``"gloo"``: any device.  Card tensors are staged through host memory
  (``.cpu()``, then ``.to(device)``), so several ranks may share one card;
  every rank of a gloo mesh on ``"cuda"`` runs on the current card.
* ``"nccl"``: one card per rank (rank r on ``cuda:r``); a mesh larger
  than the visible cards raises.

Each collective adds to ``MeshComm.stats``, keyed ``"<phase>.<op>.<axis>"``
(``MeshComm.phase`` is set by the caller; a tuple axis reads
``a+b``): calls, bytes this rank sent and
seconds on the host clock, staging included.  The seconds mean something
on a card only with ``MeshComm.timing`` set: each collective then
synchronizes the device before and after itself, so its seconds hold
the transport, the staging and the wait for the slowest peer, not the
compute queued before it.  Off (the default), no collective
synchronizes the device for its statistics.

Rendezvous is a ``file://`` store in a fresh temporary directory: no
network address is involved.
"""
from __future__ import annotations

import dataclasses
import io
import itertools
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

COMMS = ("gloo", "nccl")
# seconds a collective may wait for its peers before the process group
# gives up (a failed peer otherwise hangs the others)
COLLECTIVE_TIMEOUT_S = 600
NOT_ON_RANK = "not on a rank of this mesh"

_current: "MeshComm | None" = None
# every MeshComm of this process's process group, by mesh (their axis
# groups are created once; switching meshes reuses them)
_comms: "dict[Mesh, MeshComm]" = {}


# ------------------------------------------------------ partition specs

class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: a tuple of ``None``, axis names or
    tuples of names, one a dimension (trailing dimensions replicated).  As
    JAX's, a tuple of one name reads as the name and an empty tuple as
    ``None``."""

    def __new__(cls, *parts):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis name ``spec`` uses, in order."""
    return tuple(a for e in spec for a in entry_axes(e))


def local_block(x, spec, comm):
    """This rank's block of the global array ``x`` under ``spec``: each
    sharded dimension cut into ``axis_size`` equal blocks, block
    ``axis_index`` (row-major over a tuple of axes).  ``comm`` is a
    rank's ``MeshComm`` (anything with ``axis_size`` / ``axis_index``)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = comm.axis_size(entry), comm.axis_index(entry)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide into {n} blocks over {entry!r}")
        x = x.narrow(dim, i * (size // n), size // n)
    return x


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks on 1-3 named axes: ``sizes`` and ``axis_names`` (one name a
    size), their transport ``comm`` and ``device`` (``"cuda"`` or
    ``"cpu"``).  ``shape`` maps each axis name to its size, as a JAX
    mesh's does."""

    sizes: tuple[int, ...]
    comm: str
    device: str = "cuda"
    axis_names: tuple[str, ...] = ("part", "model")

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if self.comm not in COMMS:
            raise ValueError(f"comm={self.comm!r}: expected one of {COMMS}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device={self.device!r}: expected 'cuda' or "
                             "'cpu'")
        if not 1 <= len(self.sizes) <= 3 or min(self.sizes) < 1:
            raise ValueError(f"mesh sizes {self.sizes}: expected 1 to 3 "
                             "sizes, each >= 1")
        if (len(self.axis_names) != len(self.sizes)
                or len(set(self.axis_names)) != len(self.axis_names)):
            raise ValueError(f"axis_names {self.axis_names}: expected "
                             f"{len(self.sizes)} distinct names, one for "
                             f"each of the sizes {self.sizes}")
        if self.comm == "nccl" and self.device != "cuda":
            raise ValueError("comm='nccl' needs device='cuda'")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """``rank``'s coordinate on each axis (row-major)."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            rank, out[name] = divmod(rank, n)
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for name, n in zip(self.axis_names, self.sizes):
            r = r * n + coords[name]
        return r

    def rank_device(self, rank: int) -> torch.device:
        """The device of ``rank``: the CPU, the current card (gloo, shared
        by every rank) or card ``rank`` (nccl)."""
        if self.device == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError("mesh on 'cuda': no CUDA device is "
                               "available (use device='cpu')")
        if self.comm == "nccl":
            if self.size > torch.cuda.device_count():
                raise RuntimeError(
                    f"comm='nccl' needs one card per rank: {self.size} "
                    f"ranks, {torch.cuda.device_count()} cards (ranks "
                    "that share a card take comm='gloo')")
            return torch.device("cuda", rank)
        return torch.device("cuda", torch.cuda.current_device())


def _wire(x: torch.Tensor, host: bool) -> torch.Tensor:
    """The payload of ``x`` as its raw bytes (uint8, which every backend
    moves), on the host when staged."""
    x = x.contiguous().reshape(-1).view(torch.uint8)
    return x.cpu() if host and x.is_cuda else x


def _unwire(buf: torch.Tensor, like: torch.Tensor, lead=()) -> torch.Tensor:
    """A payload back in ``like``'s dtype and device, shaped ``lead +
    like.shape``."""
    return buf.to(like.device).view(like.dtype).reshape(
        tuple(lead) + tuple(like.shape))


def _tracks(x) -> bool:
    """Whether autograd records an operation on ``x``."""
    return (torch.is_tensor(x) and x.requires_grad
            and torch.is_grad_enabled())


class MeshComm:
    """This process's rank of a :class:`Mesh`: its coordinates, device,
    axis groups and the collectives (module docstring)."""

    def __init__(self, mesh: Mesh, rank: int):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.rank_device(rank)
        self.coords = mesh.coords(rank)
        self.host = mesh.comm == "gloo" and self.device.type == "cuda"
        self.world = dist.group.WORLD
        self.phase = "run"
        self.timing = False
        self.stats: dict[str, list] = {}
        # every rank creates every group, in the same order (single axes
        # first, in mesh order); a group of one rank needs none (its
        # collectives move nothing), one of every rank is the world
        self._groups = {}
        names, sizes = mesh.axis_names, mesh.sizes
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(range(len(names)), k):
                rest = [i for i in range(len(names)) if i not in sub]
                for fixed in itertools.product(*(range(sizes[i])
                                                 for i in rest)):
                    ranks = []
                    for c in itertools.product(*(range(sizes[i])
                                                 for i in sub)):
                        co = dict(zip((names[i] for i in rest), fixed))
                        co.update(zip((names[i] for i in sub), c))
                        ranks.append(mesh.rank_of(co))
                    if len(ranks) < 2:
                        continue
                    g = (dist.group.WORLD if len(ranks) == mesh.size
                         else dist.new_group(ranks, backend=mesh.comm))
                    if rank in ranks:
                        self._groups[tuple(names[i] for i in sub)] = (
                            g, ranks)

    # ------------------------------------------------------------- queries
    def _axes(self, axis) -> tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        bad = [a for a in axes if a not in self.mesh.shape]
        if bad or len(set(axes)) != len(axes):
            raise ValueError(f"axis {axis!r}: expected distinct names of "
                             f"the mesh's axes {self.mesh.axis_names}")
        return axes

    def axis_size(self, axis) -> int:
        return math.prod(self.mesh.shape[a] for a in self._axes(axis))

    def axis_index(self, axis) -> int:
        i = 0
        for a in self._axes(axis):
            i = i * self.mesh.shape[a] + self.coords[a]
        return i

    def _group(self, axis):
        """(process group, its ranks in ascending order, the position in
        that list of each axis index of ``axis``)."""
        axes = self._axes(axis)
        g, ranks = self._groups[tuple(a for a in self.mesh.axis_names
                                      if a in axes)]
        members = []
        for c in itertools.product(*(range(self.mesh.shape[a])
                                     for a in axes)):
            co = dict(self.coords)
            co.update(zip(axes, c))
            members.append(ranks.index(self.mesh.rank_of(co)))
        return g, ranks, members

    def reset_stats(self) -> None:
        self.stats = {}

    def _sync(self) -> None:
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self) -> float:
        self._sync()
        return time.perf_counter()

    def _note(self, op: str, axis, nbytes: int, t0: float) -> None:
        self._sync()
        label = axis if isinstance(axis, str) else "+".join(axis)
        row = self.stats.setdefault(f"{self.phase}.{op}.{label}",
                                    [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += time.perf_counter() - t0

    # --------------------------------------------------------- collectives
    def ppermute(self, x: torch.Tensor, axis, perm) -> torch.Tensor:
        """``lax.ppermute``: rank ``s`` sends ``x`` to ``d`` for each pair
        ``(s, d)`` of ``perm`` (axis indices); a rank that receives
        nothing gets zeros."""
        perm = tuple((int(s), int(d)) for s, d in perm)
        if _tracks(x):
            return _PPermute.apply(x, self, axis, perm)
        return self._ppermute(x, axis, perm)

    def all_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.all_gather``: ``[n, *x.shape]`` in axis-rank order."""
        if _tracks(x):
            return _AllGather.apply(x, self, axis)
        return self._all_gather(x, axis)

    def all_to_all(self, x: torch.Tensor, axis, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all`` (untiled): chunk ``i`` of ``x`` along
        ``split_axis`` (whose size is the axis size) goes to rank ``i``;
        the output drops ``split_axis`` and stacks the received chunks
        at ``concat_axis``, in source-rank order."""
        if _tracks(x):
            return _AllToAll.apply(x, self, axis, split_axis, concat_axis)
        return self._all_to_all(x, axis, split_axis, concat_axis)

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.psum``, summed in axis-rank order 0 .. n-1 on every rank
        (module docstring)."""
        if self.axis_size(axis) == 1:
            return x
        if _tracks(x):
            return _PSum.apply(x, self, axis)
        return self._psum(x, axis)

    def pmean(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.pmean``: ``psum(x) / n``."""
        return self.psum(x, axis) / self.axis_size(axis)

    # ----------------------------------------- the transport (no autograd)
    def _ppermute(self, x: torch.Tensor, axis, perm) -> torch.Tensor:
        t0 = self._start()
        me = self.axis_index(axis)
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        out = torch.zeros_like(x)
        if dst == [me]:                     # a pair onto itself
            out.copy_(x)
            dst, src = [], []
        sent = 0
        if dst or src:
            g, ranks, members = self._group(axis)
            payload = _wire(x, self.host)
            reqs = []
            if dst:
                reqs.append(dist.isend(payload, ranks[members[dst[0]]],
                                       group=g))
                sent = payload.numel() * payload.element_size()
            if src:
                buf = torch.empty_like(payload)
                reqs.append(dist.irecv(buf, ranks[members[src[0]]],
                                       group=g))
            for r in reqs:
                r.wait()
            if src:
                out = _unwire(buf, x)
        self._note("ppermute", axis, sent, t0)
        return out

    def _all_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        t0 = self._start()
        if self.axis_size(axis) == 1:
            out = x[None].clone()
            self._note("all_gather", axis, 0, t0)
            return out
        g, ranks, members = self._group(axis)
        payload = _wire(x, self.host)
        got = payload.new_empty((len(ranks), payload.numel()))
        dist.all_gather(list(got.unbind(0)), payload, group=g)
        if members != list(range(len(ranks))):
            got = got[members]
        out = _unwire(got, x, lead=(len(ranks),))
        self._note("all_gather", axis,
                   payload.numel() * payload.element_size(), t0)
        return out

    def _all_to_all(self, x: torch.Tensor, axis, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
        t0 = self._start()
        n = self.axis_size(axis)
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all: split axis {split_axis} of "
                             f"{tuple(x.shape)} is not the {axis} size {n}")
        chunks = torch.movedim(x, split_axis, 0)
        if n == 1:
            got = chunks.clone()
            sent = 0
        else:
            g, _, members = self._group(axis)
            if members != list(range(n)):
                raise ValueError(f"all_to_all over {axis!r}: name the axes "
                                 "in the mesh's order")
            payload = _wire(chunks, self.host)
            buf = torch.empty_like(payload)
            dist.all_to_all_single(buf, payload, group=g)
            got = _unwire(buf, chunks)
            sent = (payload.numel() * payload.element_size() * (n - 1)) // n
        out = torch.movedim(got, 0, concat_axis).contiguous()
        self._note("all_to_all", axis, sent, t0)
        return out

    def _psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return x
        g = self._all_gather(x, axis)
        acc = g[0]
        for i in range(1, g.shape[0]):
            acc = acc + g[i]
        return acc


# ------------------------------------------- differentiable collectives

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, perm):
        ctx.comm, ctx.axis, ctx.perm = comm, axis, perm
        return comm._ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return ctx.comm._ppermute(g, ctx.axis, inv), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        # psum_scatter: part j of the exchange is rank j's cotangent of
        # this rank's block, summed in axis-rank order
        parts = ctx.comm._all_to_all(g, ctx.axis, 0, 0)
        acc = parts[0]
        for j in range(1, parts.shape[0]):
            acc = acc + parts[j]
        return acc, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, split_axis, concat_axis):
        ctx.comm, ctx.args = comm, (axis, concat_axis, split_axis)
        return comm._all_to_all(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_to_all(g, *ctx.args), None, None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._psum(g, ctx.axis), None, None


# ---------------------------------------------------------- shard_map

def _left_out(comm: MeshComm, spec) -> tuple[str, ...]:
    """The mesh axes of size > 1 that ``spec`` leaves out."""
    used = spec_axes(spec)
    return tuple(a for a in comm.mesh.axis_names
                 if a not in used and comm.mesh.shape[a] > 1)


def _assemble(comm: MeshComm, y: torch.Tensor, spec) -> torch.Tensor:
    """The global array of which ``y`` is this rank's block under
    ``spec``: gathered over each sharded dimension's axes in turn."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        g = comm._all_gather(y.contiguous(), entry)        # [n, ...]
        g = torch.movedim(g, 0, dim)
        y = g.reshape(*g.shape[:dim], -1, *g.shape[dim + 2:])
    return y


class _ShardIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, spec):
        ctx.comm, ctx.spec = comm, spec
        return local_block(x, spec, comm)

    @staticmethod
    def backward(ctx, g):
        comm, spec = ctx.comm, ctx.spec
        out = _left_out(comm, spec)
        if out:
            g = comm._psum(g.contiguous(), out)
        return _assemble(comm, g, spec), None, None


class _ShardOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, comm, spec):
        ctx.comm, ctx.spec = comm, spec
        out = _assemble(comm, y, spec)
        return out.clone() if out is y else out

    @staticmethod
    def backward(ctx, g):
        comm, spec = ctx.comm, ctx.spec
        g = local_block(g, spec, comm)
        n = math.prod(comm.mesh.shape[a] for a in _left_out(comm, spec))
        return (g / n if n > 1 else g), None, None


def _shard_in(comm, x, spec):
    if not torch.is_tensor(x):
        return x
    if _tracks(x):
        return _ShardIn.apply(x, comm, spec)
    return local_block(x, spec, comm)


def _shard_out(comm, y, spec):
    if not torch.is_tensor(y):
        return y
    if _tracks(y):
        return _ShardOut.apply(y, comm, spec)
    return _assemble(comm, y, spec)


def _map_specs(fn, tree, spec):
    """``fn(leaf, leaf_spec)`` over ``tree``; a :class:`PartitionSpec`
    applies to every leaf below it (a prefix, as ``shard_map`` allows)."""
    prefix = isinstance(spec, PartitionSpec)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, spec if prefix else spec[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        specs = [spec] * len(tree) if prefix else spec
        return type(tree)(_map_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, spec)


def shard_map(f, mesh, in_specs, out_specs, what: str = "shard_map"):
    """``jax.shard_map(f, mesh=mesh, in_specs=..., out_specs=...,
    check_vma=False)`` on global arguments, run on the calling rank of
    ``mesh`` (module docstring); outside one it raises."""
    def run(*args):
        global _current
        comm = require(mesh, what)
        local = [_map_specs(lambda x, s: _shard_in(comm, x, s), a, sp)
                 for a, sp in zip(args, in_specs)]
        # the body's collectives (``current()``) are this mesh's
        outer, _current = _current, comm
        try:
            out = f(*local)
        finally:
            _current = outer
        return _map_specs(lambda y, s: _shard_out(comm, y, s), out,
                          out_specs)
    return run


def current() -> MeshComm | None:
    """This process's :class:`MeshComm` (``None`` outside a mesh rank):
    the spawned mesh's, or inside a :func:`shard_map` body its mesh's."""
    return _current


def comm_for(mesh: Mesh) -> MeshComm | None:
    """The rank of ``mesh`` this process runs, or ``None`` when no process
    group of the mesh's size is up.  Each mesh's :class:`MeshComm` is made
    once per process group and kept (every rank must make it together: it
    creates the axis groups); a group started without :func:`spawn` gets
    its first one as :func:`current`."""
    global _current
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks is up; the "
            f"mesh has {mesh.size}")
    world = dist.group.WORLD
    if any(c.world is not world for c in _comms.values()):
        _comms.clear()                  # a new process group: new groups
    if mesh not in _comms:
        _comms[mesh] = MeshComm(mesh, dist.get_rank())
    if _current is None or _current.world is not world:
        _current = _comms[mesh]
    return _comms[mesh]


def require(mesh, what: str) -> MeshComm:
    """The calling rank of ``mesh``; raises outside one (no one-process
    fallback)."""
    comm = comm_for(mesh) if isinstance(mesh, Mesh) else None
    if comm is None:
        raise RuntimeError(
            f"{what}: {NOT_ON_RANK} (start its ranks with "
            "repro_torch.distributed.mesh.spawn; every rank passes the same "
            "global arguments and returns the same global result)")
    return comm


def axis_comm(axis, what: str) -> MeshComm:
    """The calling rank's :class:`MeshComm` for a collective over
    ``axis``; raises outside a rank."""
    comm = current()
    if comm is None:
        raise RuntimeError(f"{what} over {axis!r}: {NOT_ON_RANK} (run it "
                           "inside shard_map on a spawned rank)")
    comm._axes(axis)
    return comm


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes, device="cpu"):
    return torch.load(io.BytesIO(data), map_location=device,
                      weights_only=False)


def to_device(obj, device):
    """``obj`` with every tensor in it moved to ``device`` (dataclasses,
    tuples, lists and dicts are walked)."""
    if torch.is_tensor(obj):
        return obj.detach().to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def _to_cpu(obj):
    return to_device(obj, "cpu")


def _worker(mesh: Mesh, rank: int, store: str, threads, fn_args: str,
            results) -> None:
    """One rank: join the group, run ``fn(*args)``, send the result (on
    the host) or the traceback to the parent."""
    global _current
    try:
        if mesh.device == "cuda" and mesh.comm == "gloo":
            # ranks that share a card: segments that grow and shrink
            # fragment its memory less between the ranks' caches
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                  "expandable_segments:True")
        if threads is not None:
            torch.set_num_threads(threads)
        dev = mesh.rank_device(rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            mesh.comm, init_method=f"file://{store}", rank=rank,
            world_size=mesh.size,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        _current = _comms[mesh] = MeshComm(mesh, rank)
        with open(fn_args, "rb") as f:
            fn, args = _loads(f.read())
        out = _to_cpu(fn(*args))
        results.put((rank, "ok", _dumps(out)))
        dist.destroy_process_group()
    except BaseException:                  # noqa: BLE001 - sent to parent
        results.put((rank, "error", traceback.format_exc()))


def spawn(fn, mesh: Mesh, *args, threads: int | None = None,
          timeout: float = 3600.0) -> list:
    """Run ``fn(*args)`` on every rank of ``mesh``, one spawned process a
    rank, and return the per-rank results in rank order (tensors on the
    host).  ``fn`` must be importable by name (a module-level function);
    inside it :func:`current` is the rank's :class:`MeshComm`.  Card
    tensors among ``args`` travel through the host.  ``threads`` sets
    each rank's ``torch.set_num_threads`` (default on a CPU mesh: the
    host's cores shared out among the ranks).

    A rank that fails makes this raise ``RuntimeError`` with its
    traceback; the other ranks are terminated.  Every process started
    here has ended when it returns."""
    import torch.multiprocessing as mp
    if mesh.device == "cuda":
        # the kernels build once, here, before the ranks load them
        from repro_torch.kernels import library
        mesh.rank_device(mesh.size - 1)
        library()
    if threads is None and mesh.device == "cpu":
        threads = max(1, (os.cpu_count() or 1) // mesh.size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    # the arguments go through a file: a large pickle through each
    # process's start pipe would start the ranks one after another
    payload = os.path.join(tmp, "args.pt")
    with open(payload, "wb") as f:
        f.write(_dumps((fn, _to_cpu(args))))
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(mesh, r, os.path.join(tmp, "store"), threads,
                               payload, results))
             for r in range(mesh.size)]
    try:
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < mesh.size:
            try:
                rank, status, data = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(
                        f"mesh rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before its result")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"mesh ranks did not finish within "
                                       f"{timeout} s")
                continue
            if status != "ok":
                raise RuntimeError(f"mesh rank {rank} failed:\n{data}")
            out[rank] = _loads(data)
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(mesh.size)]
    finally:
        procs = [p for p in procs if p.pid is not None]     # started
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
