"""Multi-process data parallelism over ``torch.distributed``.

Port of ``livelyspeaker_tpu/parallel/multihost.py``. The JAX package joins
processes with ``jax.distributed.initialize`` and lets GSPMD insert the
cross-process gradient all-reduce into one global program. Here each
process drives its own local shards of the mesh, and the mesh's
collectives (``mesh.pmean``, ``mesh.gather_processes``) go through the
process group once :func:`init_distributed` has joined it:

- :func:`init_distributed` calls ``torch.distributed.init_process_group``
  with the coordinator's address, the world size and this process's rank;
  the transport is NCCL between cards and gloo on the CPU, or the one the
  caller names (never swapped for another when it fails);
- each process feeds its own shard of the index stream through
  ``DataLoader(host_id=rank, num_hosts=world)`` (``data/loader.py``);
- :func:`global_batch` splits this process's local batch over its local
  shards, and the data-parallel step (``parallel.shard_train_step``) then
  averages over every shard of every process.

Demo: ``python -m livelyspeaker_tpu_torch.scripts.train_multihost_demo``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, shard_batch

__all__ = ["init_distributed", "global_batch", "process_local_batch_size"]


def init_distributed(coordinator_address: str, num_processes: int, process_id: int,
                     local_device_ids: Optional[Sequence[int]] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> List[torch.device]:
    """Join the process group at ``coordinator_address`` (``host:port``) as
    rank ``process_id`` of ``num_processes``; returns this process's local
    devices.

    ``device=None`` means the cards: ``local_device_ids`` (all local cards
    by default), and without a card this raises (no quiet CPU run).
    ``device="cpu"`` joins with the CPU as the one local device.

    The backend defaults to ``nccl`` on cards and ``gloo`` on the CPU; a
    backend the caller names is used as named (gloo over a card is how two
    ranks share one card: NCCL refuses that)."""
    if device == "cpu":
        if local_device_ids is not None:
            raise ValueError('local_device_ids name cards; device="cpu" takes none')
        devices = [torch.device("cpu")]
    elif device is not None:
        raise ValueError(f'device is None (the cards) or "cpu", got {device!r}')
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed runs on NVIDIA GPUs by default and torch.cuda.is_available() "
            'is False; pass device="cpu" to join the group on the CPU')
    else:
        ids = range(torch.cuda.device_count()) if local_device_ids is None else local_device_ids
        devices = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(devices[0])
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return devices


def global_batch(batch: Dict, mesh: Mesh) -> List[Dict]:
    """This process's local batch (its rows of the global batch) as one
    batch a local shard, each on its device: what the data-parallel step
    takes. Non-array values pass through to every shard."""
    return shard_batch(batch, mesh)


def process_local_batch_size(global_batch_size: int) -> int:
    """This process's share of a global batch; raises when the world size
    does not divide it."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not divide over {n} "
                         "processes")
    return global_batch_size // n
