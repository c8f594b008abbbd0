"""Named meshes over the ranks of a ``torch.distributed`` world
(counterpart of ``paddle_tpu/parallel/mesh.py``).

The JAX package drives N devices from one controller.  The port is SPMD:
every rank runs the same program, and a `Mesh` names the axes of the
world's ranks (``{"dp": 2, "tp": 2}``: rank = dp * 2 + tp, row-major in
the axes' insertion order, as the JAX mesh lays out its devices).  Its
``device_mesh`` is a `torch.distributed.device_mesh.DeviceMesh` with the
same axis names, and ``group(axis)`` is this rank's sub-group along an
axis, over which `parallel.collectives` runs.

- A mesh of more than one rank needs an initialised process group whose
  world size is the mesh's size; any other size raises and names both.
- A one-rank mesh needs no process group: it runs the plain path with
  no collectives (`Partitioner.use_sharding` is False), on any world.
- The backend is the world's: NCCL on the card, gloo when
  `init_distributed` is given ``device="cpu"`` or ``backend="gloo"``.
  NCCL puts one rank on a device: more ranks on a host than its cards
  raise in `init_distributed` instead of switching backend.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_current_mesh: Optional["Mesh"] = None


class Mesh:
    """Axis names and sizes over the world's ranks.

    ``shape`` maps each axis to its size in insertion order;
    ``devices`` is the rank grid (``devices.size`` is the mesh size);
    ``coords`` this rank's index along each axis."""

    def __init__(self, axes: Dict[str, int],
                 device_type: Optional[str] = None):
        import torch.distributed as dist
        self.axis_names: Tuple[str, ...] = tuple(str(a) for a in axes)
        self.shape: Dict[str, int] = {str(a): int(n) for a, n in axes.items()}
        sizes = tuple(self.shape.values())
        n = int(math.prod(sizes)) if sizes else 1
        self.devices = np.arange(n).reshape(sizes or (1,))
        self.device_mesh = None
        self.rank = 0
        if n > 1:
            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(
                    f"mesh {self.shape} spans {n} ranks but no process "
                    "group is initialised: call parallel.init_distributed "
                    "on every rank first (or use a one-rank mesh)")
            world = dist.get_world_size()
            if world != n:
                raise ValueError(
                    f"mesh {self.shape} has {n} devices but the process "
                    f"group's world size is {world}: the mesh must cover "
                    "every rank of the world")
            from torch.distributed.device_mesh import DeviceMesh
            backend = dist.get_backend()
            self.device_type = device_type or (
                "cuda" if backend == "nccl" else "cpu")
            self.device_mesh = DeviceMesh(
                self.device_type, self.devices.tolist(),
                mesh_dim_names=self.axis_names)
            self.rank = dist.get_rank()
        else:
            self.device_type = device_type or "cpu"
        idx = np.unravel_index(self.rank, sizes) if sizes else ()
        self.coords: Dict[str, int] = {a: int(i) for a, i in
                                       zip(self.axis_names, idx)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None on a one-rank
        mesh, or for an axis of size 1)."""
        if self.device_mesh is None or self.shape.get(axis, 1) == 1:
            return None
        return self.device_mesh.get_group(mesh_dim=axis)

    def world_group(self):
        """The group of every rank of the mesh (the default group)."""
        if self.device_mesh is None:
            return None
        import torch.distributed as dist
        return dist.group.WORLD

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


class NamedSharding:
    """A placement on a mesh: the mesh and a `PartitionSpec`."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def create_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None,
                device_type: Optional[str] = None) -> Mesh:
    """``create_mesh({"dp": 2, "tp": 2})`` -> a `Mesh` over the world's
    ranks.  Put the most bandwidth-hungry axis (tp) last, as in the JAX
    package.  ``devices`` is accepted for the JAX signature; the ranks
    are always the world's."""
    return Mesh(axes, device_type=device_type)


def create_hybrid_mesh(ici_axes: Dict[str, int],
                       dcn_axis: str = "dp_dcn") -> Mesh:
    """The JAX multi-host mesh with a leading cross-host axis.  The port
    runs on one host, so the cross-host axis has size 1."""
    return create_mesh({dcn_axis: 1, **ici_axes})


def create_training_mesh(axes: Dict[str, int], dcn_axis: str = "dp") -> Mesh:
    """The one mesh factory behind ``Partitioner(mesh="dp=N,tp=M")``: on
    one host a plain mesh in the caller's axis order."""
    return create_mesh({str(a): int(n) for a, n in axes.items()})


def replicated(mesh: Mesh) -> NamedSharding:
    from .logical_axes import PartitionSpec
    return NamedSharding(mesh, PartitionSpec())


def shard_batch(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    from .logical_axes import PartitionSpec
    return NamedSharding(mesh, PartitionSpec(axis))


def cpu_multiprocess_collectives_supported() -> bool:
    """True when this torch build can run collectives between CPU
    processes (gloo compiled in)."""
    import torch.distributed as dist
    return bool(dist.is_available() and dist.is_gloo_available())


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> Tuple[int, int]:
    """Join the world: explicit arguments, else torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), else the
    JAX package's launcher variables (``PADDLE_TPU_COORDINATOR``,
    ``PADDLE_TPU_NPROC``, ``PADDLE_TPU_PROC_ID``).  -> (rank, world size).

    ``coordinator_address`` is ``host:port``, ``tcp://host:port`` or
    ``file:///path``.  The backend is NCCL on the card and gloo for
    ``device="cpu"``; ``backend="gloo"`` asks for gloo over CUDA tensors
    (several ranks time-slicing one card).  NCCL refuses two ranks on one
    device, so an NCCL world with more ranks on this host than its cards
    raises here: torchrun's ``LOCAL_WORLD_SIZE`` ranks per host, else
    every rank of the world (the explicit arguments and the JAX
    launcher's variables start one host's ranks).  A second call in an
    initialised world returns its rank and size."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = "env://"
        else:
            coordinator_address = env.get("PADDLE_TPU_COORDINATOR")
    if num_processes is None:
        n = env.get("WORLD_SIZE") or env.get("PADDLE_TPU_NPROC")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("RANK") or env.get("PADDLE_TPU_PROC_ID")
        process_id = int(r) if r else None
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs a coordinator address, a world size "
            "and a rank: pass them, or run under torchrun")
    on_cpu = device is not None and str(device).startswith("cpu")
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if backend == "nccl":
        if on_cpu:
            raise ValueError("backend='nccl' needs the card; the CPU takes "
                             "backend='gloo'")
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for the "
                               "NCCL backend (pass device='cpu' for gloo)")
        cards = torch.cuda.device_count()
        per_host = int(num_processes)
        if coordinator_address == "env://" and "LOCAL_WORLD_SIZE" in env:
            per_host = int(env["LOCAL_WORLD_SIZE"])
        if per_host > cards:
            raise RuntimeError(
                f"NCCL puts one rank on a device: {per_host} ranks on "
                f"this host's {cards} card(s) are refused; pass "
                "backend='gloo' to time-slice the card")
        local = int(env.get("LOCAL_RANK", process_id)) % cards
        torch.cuda.set_device(local)
    init = coordinator_address
    if "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()
