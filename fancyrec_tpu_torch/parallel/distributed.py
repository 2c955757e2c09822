"""Joining a world of processes: port of fancyrec_tpu/parallel/distributed.py
over `torch.distributed`.

A world is R*M processes, one a rank: R data slots, each on its own slice
of every global batch (the JAX package's processes on a pod), of M model
ranks each, which split the wide parameters (`parallel/mesh.py`). The
standard environment describes it: RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT, which `torchrun` sets, and
so can any launcher:

    torchrun --nproc_per_node R*M -m fancyrec_tpu_torch.train.trainer \\
        ... --mesh_shape R,M

Without WORLD_SIZE there is no world and nothing here communicates. A
rank's device is `cuda:LOCAL_RANK % device_count()` (or the CPU under
--device cpu). The backend follows from the layout: NCCL where each local
rank has a card of its own; gloo where ranks share a card (NCCL refuses
two ranks on one device), where several local ranks name their cards
(--device cuda:N, maybe one card for all) and on the CPU. The group is
created with a timeout, so that a rank left waiting in a collective fails
instead of hanging. Writes (checkpoints, metrics) come from the primary, rank 0; a
decision that rests on files only the primary may see (skip, exit) is the
primary's, broadcast to every rank (`primary_decision`), so that no rank
exits while the others wait in a collective.
"""

from __future__ import annotations

import atexit
import datetime
import os

import torch
import torch.distributed as dist

from fancyrec_tpu_torch.device import resolve_device
from fancyrec_tpu_torch.parallel.collectives import (
    comm_device, data_rank, rank, world_size)

# how long a rank waits in init or in a collective before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def rank_device(device: str = "cuda") -> torch.device:
    """This process's device: `device` as given outside a world, or where
    it names an index or the CPU; in a world, else the card of the local
    rank (LOCAL_RANK modulo the cards), made current. Raises for CUDA
    without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "WORLD_SIZE" in os.environ:
        if dev.index is None:
            dev = torch.device("cuda", _env_int("LOCAL_RANK", 0)
                               % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def backend_for(dev: torch.device, local_world: int,
                named_index: bool = False) -> str:
    """NCCL where every local rank has a card of its own, else gloo. A
    card the caller named (--device cuda:N) may be the same on every local
    rank, so more than one local rank on named cards takes gloo too."""
    if (dev.type == "cuda" and local_world <= torch.cuda.device_count()
            and not (named_index and local_world > 1)):
        return "nccl"
    return "gloo"


def initialize_multihost(device: str = "cuda") -> torch.device:
    """Join the world the environment describes, if any -> this rank's
    device. Without WORLD_SIZE nothing is joined; WORLD_SIZE=1 makes a
    world of one (whose collectives are the identity). Joining twice is a
    no-op, so CLI mains called again in one process stay in their world;
    the group is destroyed when the process exits."""
    dev = rank_device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    world = _env_int("WORLD_SIZE", 1)
    r = _env_int("RANK", 0)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if "MASTER_PORT" not in os.environ:
        raise RuntimeError("WORLD_SIZE is set but MASTER_PORT is not: the "
                           "ranks meet at MASTER_ADDR:MASTER_PORT")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    named = torch.device(device).index is not None
    dist.init_process_group(
        backend_for(dev, local_world, named),
        init_method="tcp://%s:%s" % (addr, os.environ["MASTER_PORT"]),
        world_size=world, rank=r, timeout=TIMEOUT)
    atexit.register(_destroy)
    return dev


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def dropout_seed(seed: int) -> int:
    """The seed of this rank's dropout draws: `seed` on data slot 0 (and
    outside a world), another stream on every other data slot, whose rows
    are other posts. The model ranks of a slot hold the same activations
    and must drop the same elements of them, so they share their slot's
    stream: a world of (1, M) draws what one process draws. The weights
    stay seeded with `seed` on every rank. Call after `build_mesh`."""
    return seed + 1_000_003 * data_rank()


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs."""
    return rank() == 0


def barrier() -> None:
    """Every rank of the world waits here for the others: so that the
    primary's writes land before another rank reads them, and every rank's
    reads come before the primary writes. A no-op outside a world."""
    if world_size() > 1:
        dist.barrier()


def primary_decision(value: int) -> int:
    """Every rank adopts the primary's value (a skip or exit decision from
    files that may exist on the primary only). Identity outside a world."""
    if world_size() <= 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=comm_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def assert_agreement(name: str, value: int) -> None:
    """Every rank must hold the same value (the auto-resume epoch found on
    disk): a rank that resumed from another epoch would train a different
    model and hang at the next collective. Raises on every rank, since all
    of them see the gathered values."""
    if world_size() <= 1:
        return
    t = torch.tensor([int(value)], dtype=torch.int64, device=comm_device())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    values = [int(p.item()) for p in parts]
    if len(set(values)) != 1:
        raise RuntimeError(
            "%s disagrees across ranks (rank %d sees %d, all: %s): resuming "
            "a world needs the checkpoint directory on a shared filesystem"
            % (name, rank(), value, values))
