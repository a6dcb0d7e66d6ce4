"""Process groups as meshes: the counterpart of ``repro.launch.mesh``'s
``make_mesh`` and of ``shard_map``'s axis operations (``axis_index``,
``psum``, ``pmax``, ``all_to_all``, ``ppermute``) for the multi-device
GNN engine.

Where the reference runs one ``shard_map`` over a mesh axis, the port
runs one process per rank over one ``torch.distributed`` process group:
every rank runs the same program on its own partition, and a
:class:`Mesh` gives it the collectives. The group's backend follows the
device: NCCL for ``cuda`` (rank r on ``cuda:r``) and gloo for ``cpu``.
A gloo group over CUDA tensors (two ranks on one card) is built only on
request (``backend="gloo"``); a collective that gloo cannot run on CUDA
tensors goes through pinned host memory there, and :attr:`Mesh.staged`
names each one. The compute stays on the card.

  # N ranks, each calling fn(mesh, *args); rank 0's return value back
  out = spawn(fn, N, *args)                 # NCCL, rank r on cuda:r
  out = spawn(fn, N, *args, device="cpu")   # gloo on the CPU
  # or, inside a program that already is a rank (or alone, N = 1):
  mesh = make_mesh(N, device="cuda")
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

#: the collectives a gloo group never runs on CUDA tensors (its
#: send/recv has no CUDA path): staged through pinned host memory
_GLOO_HOST_ONLY = ("ppermute",)


def backend_for(device) -> str:
    """The process-group backend of a device type: NCCL on ``cuda``,
    gloo on ``cpu``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int, backend: str) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` under NCCL, the card
    ``rank % device_count`` (``cuda:0`` on one card) in a gloo group
    over CUDA tensors, the CPU otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """One rank's view of a 1-D mesh over the default process group:
    ``rank`` and ``size`` are the reference's ``axis_index`` and axis
    size, the methods its collectives. Every rank must call the same
    collectives in the same order."""

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.device = torch.device(device)
        self._gloo_cuda = (self.backend == "gloo"
                           and self.device.type == "cuda")
        #: collectives that go through pinned host memory (a gloo group
        #: over CUDA tensors only)
        self.staged = set(_GLOO_HOST_ONLY) if self._gloo_cuda else set()
        self._probed = set()
        #: payload bytes this rank sent by collective kind
        #: ("all-reduce", "all-to-all", "collective-permute"), for the
        #: roofline's collective term (``launch/perf.py``)
        self.moved = {}

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.moved[kind] = (self.moved.get(kind, 0)
                            + x.numel() * x.element_size())

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def _run(self, name: str, op: Callable, out: torch.Tensor,
             inp: torch.Tensor) -> torch.Tensor:
        """``op(out, inp)`` on the group; on a gloo group over CUDA
        tensors a collective that gloo refuses is staged through pinned
        host buffers (and named in :attr:`staged`)."""
        if self._gloo_cuda and inp.is_cuda:
            if name not in self.staged and name not in self._probed:
                self._probed.add(name)
                try:
                    op(out, inp)
                    return out
                except (RuntimeError, ValueError):
                    # gloo checks the device before it communicates, on
                    # every rank alike
                    self.staged.add(name)
            if name in self.staged:
                h_in = torch.empty(inp.shape, dtype=inp.dtype,
                                   pin_memory=True).copy_(inp)
                h_out = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
                op(h_out, h_in)
                return out.copy_(h_out)
        op(out, inp)
        return out

    def _all_reduce(self, x: torch.Tensor, red, name: str) -> torch.Tensor:
        def op(out, inp):
            if out is not inp:
                out.copy_(inp)
            dist.all_reduce(out, op=red)
        y = x.contiguous().clone()
        self._count("all-reduce", y)
        return self._run(name, op, y, y)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every rank (each rank gets the same value)."""
        return self._all_reduce(x, dist.ReduceOp.SUM, "psum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over every rank."""
        return self._all_reduce(x, dist.ReduceOp.MAX, "pmax")

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every rank: ``psum(x) / size``."""
        return self.psum(x) / self.size

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (P, ...): row p goes to rank p; row q of the result came
        from rank q (the reference's ``all_to_all(split_axis=0,
        concat_axis=0)``)."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all needs a leading axis of "
                             f"{self.size}, got {tuple(x.shape)}")
        x = x.contiguous()
        self._count("all-to-all", x)

        def op(out, inp):
            dist.all_to_all_single(out, inp)
        return self._run("all_to_all", op, torch.empty_like(x), x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(P, ...) with row q = rank q's ``x`` (one all-to-all)."""
        rep = x.unsqueeze(0).expand(self.size, *x.shape)
        return self.all_to_all(rep)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Send ``x`` to rank ``(rank + shift) % P`` and return what rank
        ``(rank - shift) % P`` sent (the reference's ring ``ppermute``)."""
        if self.size == 1:
            return x.clone()
        x = x.contiguous()
        self._count("collective-permute", x)
        to = (self.rank + shift) % self.size
        frm = (self.rank - shift) % self.size

        def op(out, inp):
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, inp, to),
                dist.P2POp(dist.irecv, out, frm)])
            for r in reqs:
                r.wait()
        return self._run("ppermute", op, torch.empty_like(x), x)


def make_mesh(num_devices: int, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """This rank's :class:`Mesh` over the default process group, which
    must hold ``num_devices`` ranks. With no group yet and one device,
    a one-rank group is set up here (rendezvous on a free local port);
    more ranks come from :func:`spawn`. ``backend`` defaults to the
    device's (:func:`backend_for`); a group of another backend is
    refused, not switched."""
    backend = backend or backend_for(device)
    if not dist.is_initialized():
        if num_devices != 1:
            raise RuntimeError(
                f"a {num_devices}-rank mesh needs its ranks started first: "
                "repro_torch.launch.mesh.spawn, or the train launcher's "
                "--mesh-devices")
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}",
            world_size=1, rank=0)
    got = str(dist.get_backend())
    if got != backend:
        raise RuntimeError(f"the process group runs {got!r}, but "
                           f"{backend!r} was asked for on {device}")
    size = dist.get_world_size()
    if size != num_devices:
        raise RuntimeError(f"the process group has {size} ranks, the mesh "
                           f"asks for {num_devices}")
    dev = rank_device(device, dist.get_rank(), backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dev)


def _rank_main(rank: int, fn, world: int, port: int, device, backend: str,
               timeout_s: float, out_path: str, args) -> None:
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores: intra-op threads beyond a
        # rank's share spin against the other ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_mesh(world, device, backend), *args)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device="cuda",
          backend: Optional[str] = None, timeout_s: float = 600.0) -> Any:
    """Start ``nprocs`` ranks (spawned processes, one group with
    rendezvous on a free local port), run ``fn(mesh, *args)`` in each
    and return rank 0's result (picklable by ``torch.save``). The ranks
    run on the card (rank r on ``cuda:r``) unless ``device="cpu"``. A
    rank that raises makes this raise; every rank has ended on return."""
    import torch.multiprocessing as mp

    backend = backend or backend_for(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pt")
        mp.start_processes(
            _rank_main, args=(fn, nprocs, free_port(), str(device), backend,
                              timeout_s, path, args),
            nprocs=nprocs, join=True, start_method="spawn")
        return torch.load(path, weights_only=False)
