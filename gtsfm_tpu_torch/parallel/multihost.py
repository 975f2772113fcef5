"""Multi-process runtime over torch.distributed: one process per GPU.

Port of gtsfm_tpu/parallel/multihost.py (the reference's SSHCluster
deployment, gtsfm/runner/gtsfm_runner_base.py:244-273). Every process runs
the same program; ``initialize`` joins them into one process group (NCCL on
the card, gloo only when the caller asks for the CPU) and a ``Mesh`` holds
this rank's device and that group.

Launch, on each host:

  * ``torchrun --nproc_per_node N -m gtsfm_tpu_torch.runner --multihost ...``:
    ``initialize()`` with no arguments reads the variables torchrun sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), the
    counterpart of JAX's auto-detection on a pod;
  * or one command per process with ``--coordinator_address host:port
    --num_processes N --process_id r``.

Data model (as the JAX package's): every rank computes the pipeline's
state from the same inputs and seeds. ``shard_inputs`` gives each rank its
contiguous row slice of the leading-sharded values, ``gather_outputs``
all-gathers sharded results into full tensors on every rank. Unlike XLA on
a TPU, the card's atomics (``index_add_``) round a replicated stage
differently from rank to rank, so a stage that needs the ranks to agree on
its inputs takes the first rank's (``Mesh.broadcast``): global BA does.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

logger = logging.getLogger("gtsfm_tpu_torch")

# Every collective of a process group waits at most this long: a rank that
# died or never arrived fails the others instead of hanging them.
DEFAULT_TIMEOUT_S = 600.0


class PartitionSpec(NamedTuple):
    """Per-leaf layout marker (stand-in for jax.sharding.PartitionSpec):
    ``P("data")`` shards the leading axis over the mesh, ``P()`` replicates."""

    axis: str | None = None


P = PartitionSpec


class Mesh:
    """A 1-D mesh of ranks: this rank's device and the process group joining
    the ranks (stand-in for jax.sharding.Mesh). With no group it is a mesh of
    one rank whose collectives return their inputs.

    Collectives stay on the device under NCCL. Gloo supports CUDA tensors
    only for broadcast and all_reduce, so under gloo every collective moves
    its tensors through host memory explicitly (the compute stays on the
    device). Each collective's calls and bytes (as sent by this rank) are
    counted in ``collective_calls`` / ``collective_bytes``; ``broadcast``
    pickles through host memory on either backend."""

    def __init__(self, device: str | torch.device, group=None, axis_name: str = "data"):
        self.device = torch.device(device)
        self.group = group
        self.axis_names = (axis_name,)
        self.size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.backend = None if group is None else dist.get_backend(group)
        self.collective_calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
        self.collective_bytes = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, rank={self.rank}, device={self.device}, backend={self.backend}, "
                f"axis_names={self.axis_names})")

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend takes it: gloo through host memory."""
        return t.cpu() if self.backend == "gloo" and t.device.type != "cpu" else t

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.collective_calls[kind] += 1
        self.collective_bytes[kind] += t.numel() * t.element_size()

    def all_reduce(self, tensors) -> list[torch.Tensor]:
        """Sum of each tensor over the ranks, in one collective: the tensors
        (one dtype) are packed into one buffer."""
        tensors = list(tensors)
        if self.group is None:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        buf = self._staged(flat)
        self._count("all_reduce", buf)
        dist.all_reduce(buf, group=self.group)
        buf = buf.to(flat.device)
        out, o = [], 0
        for t in tensors:
            out.append(buf[o:o + t.numel()].reshape(t.shape))
            o += t.numel()
        return out

    def any_rank(self, flags) -> torch.Tensor:
        """Each host flag OR-ed over the ranks (a bool tensor on the CPU), in
        one all_reduce of the count of ranks that raised it: "every rank"
        is the negation of "any rank" of the negated flags. The ranks branch
        on the result alike, so they go on to make the same collectives. A
        mesh of one rank returns the flags and makes no call."""
        flags = torch.as_tensor(flags, dtype=torch.bool).cpu()
        if self.size == 1:
            return flags
        (count,) = self.all_reduce([flags.to(self.device, torch.int32)])
        return count.cpu() > 0

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shape tensors concatenated along axis 0, in rank
        order, on every rank."""
        if self.group is None:
            return t
        is_bool = t.dtype == torch.bool
        src = self._staged(t.to(torch.uint8) if is_bool else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        self._count("all_gather", src)
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts).to(t.device)
        return out.bool() if is_bool else out


    def broadcast(self, value):
        """The first rank's ``value`` (tensors in tuples, NamedTuples, lists,
        dicts or dataclasses such as SceneData; shapes may differ from this
        rank's) on every rank, its tensors on this rank's device. Pickled
        through host memory (broadcast_object_list); a mesh of one rank
        returns ``value``."""
        if self.size == 1:
            return value
        box = [_to_device(value, "cpu") if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0), group=self.group)
        self.collective_calls["broadcast"] += 1
        self.collective_bytes["broadcast"] += _tensor_bytes(box[0])
        return _to_device(box[0], self.device)


def _to_device(value, device):
    """``value`` with every tensor in it moved to ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.replace(value, **{f.name: _to_device(getattr(value, f.name), device)
                                             for f in dataclasses.fields(value) if f.init})
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        out = [_to_device(v, device) for v in value]
        return type(value)(*out) if hasattr(value, "_fields") else type(value)(out)
    return value


def _tensor_bytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return sum(_tensor_bytes(getattr(value, f.name)) for f in dataclasses.fields(value))
    if isinstance(value, dict):
        return sum(_tensor_bytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_tensor_bytes(v) for v in value)
    return 0


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(backend: str | None = None) -> torch.device:
    """This rank's device: its card under NCCL (``initialize`` set it), the
    CPU under gloo."""
    backend = backend or (dist.get_backend() if dist.is_initialized() else None)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    from gtsfm_tpu_torch import resolve_device

    return resolve_device("cuda")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process to the default process group (idempotent: returns
    False if a group already exists, True if this call made it).

    coordinator_address: "host:port" of rank 0 (a ``file://`` path also
      works, for ranks on one host); None reads MASTER_ADDR / MASTER_PORT as
      torchrun sets them.
    num_processes / process_id: default to WORLD_SIZE / RANK, else 1 / 0.
    device: "cuda" puts this rank on card LOCAL_RANK (default: process_id
      modulo the card count) and uses NCCL; "cuda:i" puts it on card i;
      "cpu" uses gloo. A CUDA device with no card raises: there is no
      fallback to gloo or to the CPU.
    backend: None picks NCCL for a card and gloo for the CPU. "gloo" with a
      card is for several ranks sharing one card (NCCL refuses that); its
      collectives go through host memory (Mesh).
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator: pass coordinator_address (--coordinator_address host:port) or launch "
                             "with torchrun, which sets MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} requested but torch.cuda.is_available() is False; pass "
                               "device='cpu' for gloo on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs a CUDA device")
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("multihost: rank %d/%d, backend %s, device %s", process_id, num_processes, backend, dev)
    return True


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(axis_name: str = "data", device: str | torch.device | None = None) -> Mesh:
    """A mesh over every rank of the default process group (rank-major, so a
    contiguous row block of a sharded axis lives on one rank)."""
    from gtsfm_tpu_torch.parallel.distributed import make_mesh

    return make_mesh(None, axis_name, device)


def is_multiprocess() -> bool:
    return world_size() > 1


def _tree_map(fn, spec, value):
    """Applies fn(spec_leaf, value_leaf) over matching trees of tuples,
    NamedTuples, lists and dicts; a PartitionSpec applies to the whole
    subtree under it, and None stays None."""
    if value is None:
        return None
    if isinstance(spec, PartitionSpec):
        if isinstance(value, dict):
            return {k: _tree_map(fn, spec, v) for k, v in value.items()}
        if isinstance(value, (tuple, list)):
            out = [_tree_map(fn, spec, v) for v in value]
            return type(value)(*out) if hasattr(value, "_fields") else type(value)(out)
        return fn(spec, value)
    if isinstance(value, dict):
        return {k: _tree_map(fn, spec[k], v) for k, v in value.items()}
    out = [_tree_map(fn, s, v) for s, v in zip(spec, value, strict=True)]
    return type(value)(*out) if hasattr(value, "_fields") else type(value)(out)


def _leading_sharded(spec: PartitionSpec, mesh: Mesh) -> bool:
    return spec.axis is not None and spec.axis == mesh.axis_names[0]


def shard_inputs(mesh: Mesh, specs, values):
    """Full values (identical on every rank) -> this rank's inputs: its
    contiguous row slice of each leading-sharded leaf (tensor or array), the
    whole of each replicated one. Raises if a sharded axis does not divide
    by the mesh size."""

    def local(spec, v):
        if not _leading_sharded(spec, mesh):
            return v
        if v.shape[0] % mesh.size != 0:
            raise ValueError(f"sharded axis {v.shape[0]} not divisible by {mesh.size} ranks")
        chunk = v.shape[0] // mesh.size
        return v[mesh.rank * chunk:(mesh.rank + 1) * chunk]

    return _tree_map(local, specs, values)


def gather_outputs(mesh: Mesh, specs, outputs):
    """This rank's outputs -> full tensors on every rank: sharded leaves are
    all-gathered along their leading axis, replicated ones kept."""
    return _tree_map(lambda spec, o: mesh.all_gather(o) if _leading_sharded(spec, mesh) else o, specs, outputs)
