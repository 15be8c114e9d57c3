"""A ``(part, model)`` mesh of ranks over ``torch.distributed``: the
counterpart of ``jax.make_mesh`` + ``shard_map`` + the ``lax`` collectives
that the multi-device DSC program (``core/distributed.py``) uses.

One process per mesh rank.  Ranks are laid out row-major, ``rank = p * M
+ m``, as ``jax.make_mesh((P, M), ("part", "model"))`` lays out its
devices; each axis has one sub-group per fixed coordinate of the other
(``dist.new_group``).  Inside a rank the collectives are methods of the
:class:`MeshComm` that :func:`spawn` sets up (:func:`current`):

* ``axis_index(axis)``;
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

Every collective moves its payload as raw bytes, so a transport never
rounds.  The transport is an explicit
argument of the mesh, never chosen silently:

* ``"gloo"``: any device.  Card tensors are staged through host memory
  (``.cpu()``, then ``.to(device)``), so several ranks may share one card;
  every rank of a gloo mesh on ``"cuda"`` runs on the current card.
* ``"nccl"``: one card per rank (rank r on ``cuda:r``); a mesh larger
  than the visible cards raises.

Each collective adds to ``MeshComm.stats``, keyed ``"<phase>.<op>.<axis>"``
(``MeshComm.phase`` is set by the caller): calls, bytes this rank sent and
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

_current: "MeshComm | None" = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``P x M`` ranks on axes ``axis_names``, their transport ``comm``
    and ``device`` (``"cuda"`` or ``"cpu"``).  ``shape`` maps each axis
    name to its size, as a JAX mesh's does."""

    sizes: tuple[int, int]
    comm: str
    device: str = "cuda"
    axis_names: tuple[str, str] = ("part", "model")

    def __post_init__(self):
        if self.comm not in COMMS:
            raise ValueError(f"comm={self.comm!r}: expected one of {COMMS}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device={self.device!r}: expected 'cuda' or "
                             "'cpu'")
        if len(self.sizes) != 2 or min(self.sizes) < 1:
            raise ValueError(f"mesh sizes {self.sizes}: expected (P, M) "
                             ">= (1, 1)")
        if self.comm == "nccl" and self.device != "cuda":
            raise ValueError("comm='nccl' needs device='cuda'")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return self.sizes[0] * self.sizes[1]

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


class MeshComm:
    """This process's rank of a :class:`Mesh`: its coordinates, device,
    axis groups and the collectives (module docstring)."""

    def __init__(self, mesh: Mesh, rank: int):
        self.mesh = mesh
        self.rank = rank
        P, M = mesh.sizes
        self.device = mesh.rank_device(rank)
        self.coords = dict(zip(mesh.axis_names, (rank // M, rank % M)))
        self.host = mesh.comm == "gloo" and self.device.type == "cuda"
        self.phase = "run"
        self.timing = False
        self.stats: dict[str, list] = {}
        # every rank creates every group, in the same order; an axis of
        # size 1 needs none (its collectives move nothing)
        self._groups = {}
        part, model = mesh.axis_names
        layouts = {part: [[p * M + m for p in range(P)] for m in range(M)],
                   model: [[p * M + m for m in range(M)] for p in range(P)]}
        for axis, groups in layouts.items():
            for ranks in groups:
                if len(ranks) < 2:
                    continue
                g = dist.new_group(ranks, backend=mesh.comm)
                if rank in ranks:
                    self._groups[axis] = (g, ranks)

    # ------------------------------------------------------------- queries
    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def reset_stats(self) -> None:
        self.stats = {}

    def _sync(self) -> None:
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self) -> float:
        self._sync()
        return time.perf_counter()

    def _note(self, op: str, axis: str, nbytes: int, t0: float) -> None:
        self._sync()
        row = self.stats.setdefault(f"{self.phase}.{op}.{axis}", [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += time.perf_counter() - t0

    # --------------------------------------------------------- collectives
    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``lax.ppermute``: rank ``s`` sends ``x`` to ``d`` for each pair
        ``(s, d)`` of ``perm`` (axis indices); a rank that receives
        nothing gets zeros."""
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
            g, ranks = self._groups[axis]
            payload = _wire(x, self.host)
            reqs = []
            if dst:
                reqs.append(dist.isend(payload, ranks[dst[0]], group=g))
                sent = payload.numel() * payload.element_size()
            if src:
                buf = torch.empty_like(payload)
                reqs.append(dist.irecv(buf, ranks[src[0]], group=g))
            for r in reqs:
                r.wait()
            if src:
                out = _unwire(buf, x)
        self._note("ppermute", axis, sent, t0)
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.all_gather``: ``[n, *x.shape]`` in axis-rank order."""
        t0 = self._start()
        if self.axis_size(axis) == 1:
            out = x[None].clone()
            self._note("all_gather", axis, 0, t0)
            return out
        g, ranks = self._groups[axis]
        payload = _wire(x, self.host)
        got = payload.new_empty((len(ranks), payload.numel()))
        dist.all_gather(list(got.unbind(0)), payload, group=g)
        out = _unwire(got, x, lead=(len(ranks),))
        self._note("all_gather", axis,
                   payload.numel() * payload.element_size(), t0)
        return out

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all`` (untiled): chunk ``i`` of ``x`` along
        ``split_axis`` (whose size is the axis size) goes to rank ``i``;
        the output drops ``split_axis`` and stacks the received chunks
        at ``concat_axis``, in source-rank order."""
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
            g, _ = self._groups[axis]
            payload = _wire(chunks, self.host)
            buf = torch.empty_like(payload)
            dist.all_to_all_single(buf, payload, group=g)
            got = _unwire(buf, chunks)
            sent = (payload.numel() * payload.element_size() * (n - 1)) // n
        out = torch.movedim(got, 0, concat_axis).contiguous()
        self._note("all_to_all", axis, sent, t0)
        return out

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum``, summed in axis-rank order 0 .. n-1 on every rank
        (module docstring)."""
        if self.axis_size(axis) == 1:
            return x
        g = self.all_gather(x, axis)
        acc = g[0]
        for i in range(1, g.shape[0]):
            acc = acc + g[i]
        return acc

    def pmean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.pmean``: ``psum(x) / n``."""
        return self.psum(x, axis) / self.axis_size(axis)


def current() -> MeshComm | None:
    """This process's :class:`MeshComm` (``None`` outside a mesh rank)."""
    return _current


def comm_for(mesh: Mesh) -> MeshComm | None:
    """The rank of ``mesh`` this process runs, or ``None`` when no process
    group of the mesh's size is up.  A group started without
    :func:`spawn` gets its :class:`MeshComm` here (every rank must call it
    together: it creates the axis groups)."""
    global _current
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks is up; the "
            f"mesh has {mesh.size}")
    if _current is None or _current.mesh != mesh:
        _current = MeshComm(mesh, dist.get_rank())
    return _current


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
        _current = MeshComm(mesh, rank)
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
