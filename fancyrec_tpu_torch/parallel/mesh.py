"""The (data, model) layout of a world: port of the data axis of
fancyrec_tpu/parallel/mesh.py.

The JAX package lays its devices out as a ('data', 'model') mesh and lets
GSPMD shard the batch over 'data' and the wide tables over 'model'. The
port runs one process a device, so its mesh is a layout of the world's
ranks: `--mesh_shape R,1` (or "", all ranks on data) puts every rank on
the data axis, each on a contiguous 1/R of every global batch, with the
model replicated. A model axis above 1 (tensor parallelism, the JAX
package's `_PARAM_RULES`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from fancyrec_tpu_torch.parallel.collectives import rank, world_size

MODEL_AXIS_LATER = (
    "a model mesh axis above 1 (tensor parallelism: the JAX package's "
    "_PARAM_RULES, fancyrec_tpu/parallel/mesh.py:58-86) is a later slice of "
    "the PyTorch port; use --mesh_shape R,1")


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int            # ranks on the data axis (the model is replicated)
    rank: int = 0        # this process's place on the data axis


def parse_mesh_shape(spec: str) -> Optional[Tuple[int, int]]:
    """"R,M" -> (R, M), "R" -> (R, 1), "" -> None. Raises ValueError for a
    malformed shape and NotImplementedError for a model axis above 1."""
    if not spec:
        return None
    try:
        dims = tuple(int(x) for x in str(spec).split(","))
    except ValueError:
        raise ValueError("--mesh_shape must be 'data,model', got %r"
                         % (spec,)) from None
    if len(dims) == 1:
        dims = (dims[0], 1)
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError("--mesh_shape must be 'data,model' with both >= 1, "
                         "got %r" % (spec,))
    if dims[1] > 1:
        raise NotImplementedError(MODEL_AXIS_LATER + " (got %r)" % (spec,))
    return dims


def build_mesh(mesh_shape: str = "", world: Optional[int] = None) -> Mesh:
    """mesh_shape "R,1" -> Mesh(data=R) over the world; "" -> every rank on
    data. Raises ValueError when the shape needs more ranks than the world
    has (as the JAX package does for devices), and when it leaves ranks
    off the data axis: each rank of the world holds one slot of it."""
    world = world_size() if world is None else world
    dims = parse_mesh_shape(mesh_shape) or (world, 1)
    n = dims[0] * dims[1]
    if n > world:
        raise ValueError("mesh %s needs %d ranks, have %d" % (dims, n, world))
    if dims[0] != world:
        raise ValueError(
            "mesh %s leaves %d of the world's %d ranks idle: every rank takes "
            "one slot of the data axis (--mesh_shape %d,1, or '')"
            % (dims, world - dims[0], world, world))
    return Mesh(data=dims[0], rank=rank())


def process_batch_shard(mesh: Mesh, batch_size: int
                        ) -> Optional[Tuple[int, int]]:
    """(rank, ranks) when each rank should load its own contiguous slice of
    every batch: more than one rank on data and a batch they divide. None
    otherwise (every process loads whole batches); a world of more than
    one rank calls `require_divisible_batch` first, so None there means
    one rank."""
    if mesh.data <= 1 or batch_size % mesh.data:
        return None
    return (mesh.rank, mesh.data)


def require_divisible_batch(mesh: Mesh, batch_size: int,
                            flag: str = "--batch_size") -> None:
    """Refuse a batch that the data axis does not divide: the ranks could
    not hold equal slices of it."""
    if mesh.data > 1 and batch_size % mesh.data:
        raise ValueError(
            "%s %d is not divisible by the data mesh axis %d: the ranks "
            "cannot hold equal slices of each batch. Pick a multiple of %d."
            % (flag, batch_size, mesh.data, mesh.data))

