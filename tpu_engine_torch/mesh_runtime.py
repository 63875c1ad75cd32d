"""Device mesh runtime of the port: rendezvous, mesh construction, topology
(port of ``tpu_engine/mesh_runtime.py``).

The mesh has JAX's five axes, outer to inner:
``("data", "fsdp", "pipe", "sequence", "model")``

- ``data``: data parallelism (gradients all-reduced);
- ``fsdp``: ZeRO sharding of parameters, gradients and optimizer state
  (``tpu_engine_torch/sharding.py``);
- ``pipe``: pipeline stages, one rank a stage: each holds a contiguous
  block of the layers and trades boundary activations and their
  cotangents with its neighbours (:meth:`MeshRuntime.stage_peers`,
  ``tpu_engine_torch/parallel/pipeline.py``);
- ``sequence``: sequence parallelism (ring or Ulysses attention across
  ranks, ``tpu_engine_torch/parallel``);
- ``model``: tensor and expert parallelism (whole heads, MLP columns,
  experts and vocabulary blocks a rank,
  ``tpu_engine_torch/parallel/tensor_parallel.py``); its ranks hold the
  same tokens, so ``TOKEN_AXES`` leaves it out.

A rank is one process with one device. :func:`initialize_distributed`
joins the process group (NCCL for a CUDA device, ``gloo`` only when the
caller asks for the CPU); :func:`build_mesh` lays the ranks out on the five
axes with ``torch.distributed.device_mesh.init_device_mesh``, rank r at the
row-major coordinates of the resolved shape, as JAX's ``Mesh`` orders its
devices; :class:`MeshRuntime` hands out the process groups of an axis or of
several axes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

MESH_AXES = ("data", "fsdp", "pipe", "sequence", "model")

# Axes over which the batch dimension is sharded (everything that is not
# tensor- or sequence-parallel).
BATCH_AXES = ("data", "fsdp")

# Axes whose ranks each hold a part of a microbatch's tokens (the batch axes
# and ``sequence``): a gradient, a loss or a MoE mean sums over them.
TOKEN_AXES = ("data", "fsdp", "sequence")


@dataclass
class MeshConfig:
    """Shape of the logical device mesh (JAX's ``MeshConfig``, a dataclass
    here: the card's installation has no pydantic). ``data = -1`` (the
    default) absorbs every rank the other axes do not claim."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    sequence: int = 1
    model: int = 1
    # Data-parallel replica groups across slices: the outer dcn_data blocks
    # of the "data" axis.
    dcn_data: int = 1

    def __post_init__(self):
        # pydantic's Field(ge=...) checks, then JAX's model validator.
        if self.data < -1:
            raise ValueError("data must be >= -1")
        for name in ("fsdp", "pipe", "sequence", "model", "dcn_data"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.data == 0:
            raise ValueError("data axis size must be -1 (infer) or >= 1")
        if self.data != -1 and self.data % self.dcn_data != 0:
            raise ValueError(
                f"data={self.data} must be divisible by dcn_data={self.dcn_data}"
            )

    def resolved_shape(self, n_devices: int) -> tuple[int, int, int, int, int]:
        """Resolve ``-1`` and validate the shape against the device count."""
        fixed = self.fsdp * self.pipe * self.sequence * self.model
        if fixed <= 0 or n_devices % fixed != 0:
            raise ValueError(
                f"fsdp*pipe*sequence*model = {fixed} does not divide device count {n_devices}"
            )
        data = self.data
        if data == -1:
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh shape data={data} fsdp={self.fsdp} pipe={self.pipe} "
                f"sequence={self.sequence} model={self.model} needs "
                f"{data * fixed} devices, have {n_devices}"
            )
        return (data, self.fsdp, self.pipe, self.sequence, self.model)


def derive_elastic_mesh(mesh: MeshConfig, n_visible: int, min_devices: int,
                        max_devices: Optional[int] = None) -> MeshConfig:
    """The largest admissible mesh for ``n_visible`` devices within
    [``min_devices``, ``max_devices``]: the model, pipe and sequence axes
    kept, data parallelism shrunk first and fsdp halved only when even that
    cannot fit. Raises ValueError when nothing admissible exists."""
    if min_devices < 1:
        raise ValueError(f"min_devices must be >= 1, got {min_devices}")
    cap = min(n_visible, max_devices if max_devices is not None else n_visible)
    fsdp = mesh.fsdp
    while True:
        fixed = fsdp * mesh.pipe * mesh.sequence * mesh.model
        n = (cap // fixed) * fixed if fixed else 0
        while n >= max(min_devices, fixed):
            data = n // fixed
            if data % mesh.dcn_data == 0:
                return MeshConfig(data=data, fsdp=fsdp, pipe=mesh.pipe,
                                  sequence=mesh.sequence, model=mesh.model,
                                  dcn_data=mesh.dcn_data)
            n -= fixed
        if fsdp > 1 and fsdp % 2 == 0:
            fsdp //= 2
            continue
        raise ValueError(
            f"no admissible mesh for {n_visible} visible device(s) within "
            f"[{min_devices}, {max_devices if max_devices is not None else n_visible}] "
            f"with fixed axes pipe={mesh.pipe} sequence={mesh.sequence} "
            f"model={mesh.model} (fsdp tried down from {mesh.fsdp})"
        )


def detect_topology(device="cuda") -> dict[str, Any]:
    """The devices this process sees and the process group it belongs to,
    read from ``torch.cuda`` and ``torch.distributed``: a row a device
    (index, name, PCI bus id) and the process's rank and world size. On
    ``device="cpu"`` there are no device rows beyond the CPU's."""
    device = torch.device(device)
    rows = []
    if device.type == "cuda":
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            bus = getattr(props, "pci_bus_id", None)
            rows.append({
                "id": i, "platform": "gpu", "device_kind": props.name,
                "pci_bus_id": (f"{props.pci_domain_id:04x}:{bus:02x}:{props.pci_device_id:02x}"
                               if bus is not None else None),
                "memory_bytes": props.total_memory,
            })
    else:
        rows.append({"id": 0, "platform": "cpu", "device_kind": "cpu"})
    joined = dist.is_available() and dist.is_initialized()
    return {
        "num_devices": len(rows),
        "num_processes": dist.get_world_size() if joined else 1,
        "process_index": dist.get_rank() if joined else 0,
        "backend": dist.get_backend() if joined else None,
        "platform": rows[0]["platform"] if rows else "none",
        "devices": rows,
    }


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> bool:
    """Join the process group: JAX's arguments, or torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``). Returns True once joined, False for a run of one
    process (nothing given, no ``WORLD_SIZE`` in the environment).

    ``coordinator_address`` is ``host:port`` or an init-method URL
    (``tcp://...``, ``file://...``). The backend follows ``device``: NCCL
    for ``cuda`` (this process's card is ``cuda:LOCAL_RANK`` for a bare
    ``"cuda"``, or the index given), ``gloo`` for ``"cpu"``."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and num_processes is None and "WORLD_SIZE" not in env:
        return False
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError("initialize_distributed needs coordinator_address or "
                             "MASTER_ADDR and MASTER_PORT in the environment")
        coordinator_address = f"{addr}:{port}"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else int(env.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_distributed: device {device} is neither cuda nor cpu")
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    return True


def build_mesh(config: Optional[MeshConfig] = None, device="cuda"):
    """The :class:`~torch.distributed.device_mesh.DeviceMesh` of ``config``
    over this process group's ranks, with the five axis names. Needs
    :func:`initialize_distributed` first; ``dcn_data > 1`` (several slices)
    raises ``NotImplementedError``: one host has no slices."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call initialize_distributed")
    shape = config.resolved_shape(dist.get_world_size())
    if config.dcn_data != 1:
        raise NotImplementedError("dcn_data > 1 (a mesh across slices) is not ported")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=MESH_AXES)


class MeshRuntime:
    """Owns this rank's mesh and its process groups; one per training
    process. :meth:`group` gives the group of the ranks that differ from
    this one along ``axes`` only (None for a group of one rank: its
    collectives are copies, and the callers skip them)."""

    def __init__(self, config: Optional[MeshConfig] = None, device="cuda"):
        self.config = config or MeshConfig()
        self.device = torch.device(device)
        self.mesh = build_mesh(self.config, self.device)
        self.shape = tuple(int(s) for s in self.mesh.mesh.shape)
        self.rank = dist.get_rank()
        self.coords = dict(zip(MESH_AXES, (int(c) for c in self.mesh.get_coordinate())))
        self._groups: dict[tuple[str, ...], Any] = {}
        # Every rank makes the same groups in the same order (new_group is
        # collective over the world).
        for axes in (TOKEN_AXES, ("data", "sequence"), (*TOKEN_AXES, "model"),
                     ("data", "sequence", "model")):
            self._make(axes)
        self._ends = self._make_ends()

    def _make_ends(self):
        """The group of the first and the last stage of this rank's
        pipeline (the two holders of a tied table), or None under three
        stages (the ``pipe`` group itself serves at two)."""
        n = self.axis_sizes["pipe"]
        if n < 3:
            return None
        ranks = torch.arange(self.n_devices).reshape(self.shape).movedim(2, -1)
        mine = None
        for row in ranks.reshape(-1, n).tolist():
            g = dist.new_group([row[0], row[-1]])
            if self.rank in (row[0], row[-1]):
                mine = g
        return mine

    def stage_peers(self) -> tuple[Optional[int], Optional[int]]:
        """The global ranks of this rank's previous and next pipeline
        stage (None at the first and the last)."""
        n, p = self.axis_sizes["pipe"], self.coords["pipe"]
        ranks = torch.arange(self.n_devices).reshape(self.shape)
        idx = [self.coords[a] for a in MESH_AXES]

        def at(q):
            idx[2] = q
            return int(ranks[tuple(idx)])

        return (at(p - 1) if p > 0 else None), (at(p + 1) if p < n - 1 else None)

    def ends_group(self):
        """The group of the first and the last pipeline stage (None at one
        stage)."""
        if self.axis_sizes["pipe"] == 1:
            return None
        return self.group("pipe") if self.axis_sizes["pipe"] == 2 else self._ends

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(MESH_AXES, self.shape))

    @property
    def n_devices(self) -> int:
        return int(torch.tensor(self.shape).prod())

    def data_parallel_size(self) -> int:
        s = self.axis_sizes
        return s["data"] * s["fsdp"]

    def size(self, axes: Sequence[str]) -> int:
        s = self.axis_sizes
        n = 1
        for a in axes:
            n *= s[a]
        return n

    def _make(self, axes: tuple[str, ...]) -> None:
        ranks = torch.arange(self.n_devices).reshape(self.shape)
        keep = [i for i, a in enumerate(MESH_AXES) if a not in axes]
        vary = [i for i, a in enumerate(MESH_AXES) if a in axes]
        grid = ranks.permute(*keep, *vary).reshape(-1, self.size(axes))
        mine = None
        for row in grid.tolist():
            g = dist.new_group(row) if len(row) > 1 else None
            if self.rank in row:
                mine = g
        self._groups[axes] = mine

    def group(self, axes) -> Optional[Any]:
        """The process group over ``axes`` (an axis name or a tuple of
        them), or None where it has one rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.size(axes) == 1:
            return None
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if axes not in self._groups:
            raise KeyError(f"no group made over {axes}")
        return self._groups[axes]

    def topology_report(self) -> dict[str, Any]:
        report = detect_topology(self.device)
        report["mesh"] = {"axes": self.axis_sizes,
                          "device_ids": torch.arange(self.n_devices).reshape(self.shape).tolist()}
        return report
