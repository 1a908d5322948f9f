"""Multi-process hooks: the process group and rank-0-only side effects.

Counterpart of ``fiude_tpu/parallel/distributed.py:23-56``.  The JAX package
wraps ``jax.distributed.initialize``; here :func:`initialize` makes the
``torch.distributed`` process group from what ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``)
or from its arguments, and does nothing when no world is configured, so
every driver runs unchanged in one process.

A rank's device is ``cuda:LOCAL_RANK`` unless the caller names one
(:func:`rank_device`); ``device="cpu"`` takes the CPU.  The backend is NCCL
on a card and gloo on the CPU.  A caller may name ``backend="gloo"`` with a
CUDA device, so that ranks share one card (NCCL takes one rank a device).
When NCCL fails the call raises: nothing falls back to gloo.

The ledger (``utils/ledger.py``) stays the work queue between processes, as
in the reference; :func:`primary_only` and :func:`broadcast_from_primary`
keep the side effects (results rows, checkpoints, ledger claims) to rank 0.
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

#: How long a collective or the rendezvous may wait for a peer before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:LOCAL_RANK``
    (``LOCAL_RANK`` 0 when unset).  Raises when there is no card, or when
    ``LOCAL_RANK`` names a card that is not there."""
    if device is not None:
        return torch.device(device)
    local = _env_int("LOCAL_RANK") or 0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to run the ranks on the CPU")
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"LOCAL_RANK {local} has no card: {count} visible")
    return torch.device("cuda", local)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Make the default process group when a world is configured.

    ``coordinator_address``: ``"host:port"`` (taken as ``tcp://``) or a URL
    (``tcp://...``, ``file://...``); ``MASTER_ADDR:MASTER_PORT`` when None.
    ``num_processes`` / ``process_id``: ``WORLD_SIZE`` / ``RANK`` when None.
    ``backend``: NCCL for a CUDA :func:`rank_device`, gloo for the CPU, when
    None.  Returns True when this process is one rank of a world (also when
    the group existed already) and False, having done nothing, when no
    coordinator is configured.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            return False
        coordinator_address = f"{addr}:{port}"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("a coordinator without a world size and a rank: pass num_processes "
                         "and process_id, or set WORLD_SIZE and RANK")
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev        # makes the communicator now: a failure raises here
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank,
                            timeout=timeout, **kwargs)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_host() -> bool:
    """Whether this process is rank 0 (or alone)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def primary_only(fn):
    """Decorator: run side-effecting host code (results tables, checkpoints)
    on rank 0 only; other ranks get None."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary_host():
            return fn(*args, **kwargs)
        return None
    return wrapper


def broadcast_from_primary(value: Any) -> Any:
    """``value`` as rank 0 has it, on every rank (picklable; ``value`` itself
    in one process)."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
