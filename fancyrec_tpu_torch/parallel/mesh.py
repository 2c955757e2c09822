"""The (data, model) layout of a world and the parameters' sharding rules:
port of fancyrec_tpu/parallel/mesh.py.

The JAX package lays its devices out as a ('data', 'model') mesh and lets
GSPMD shard the batch over 'data' and the wide tables over 'model'. The
port runs one process a device, so its mesh is a layout of the world's
ranks, row-major as the JAX package's reshape: `--mesh_shape R,M` puts
rank r at data index r // M and model index r % M. The R data slots each
hold a contiguous 1/R of every global batch (the M model ranks of a slot
load the same rows); the M model ranks of a slot split the parameters
that `_PARAM_RULES` names and replicate the rest. `--mesh_shape ""` puts
every rank on data.

The rules are the JAX package's, on the port's parameter names and torch
layouts (a Linear's weight is (out, in), the transpose of a flax kernel):

  * brand_encoding.aspects_embeddings (A, C): rows (the aspects);
  * brand_encoding.brand_embeddings (B+1, A): columns (the same aspects),
    so the aspect mixture is a local product summed over the model group;
  * (visual|text)_mapping.fc1.weight (out, in): the input columns
    (row-parallel: partial products summed over the model group, then the
    replicated bias);
  * bert.layer_i.intermediate.weight (3072, 768) and .bias: the outputs
    (column-parallel);
  * bert.layer_i.output.weight (768, 3072): the input columns
    (row-parallel, its bias replicated).

As in the JAX package's `_rule_for`, a tensor whose split dimension the
model axis does not divide stays replicated. Adam's moments follow their
parameters (the rules key on the names the moments share).

Serving lays out devices, not ranks (`ServingMesh`, `serving_mesh`): the
JAX package serves a mesh from one controller, a process whose posts are
sharded over its host's devices, and so does the port, one process that
holds post shard s on device s of a list. That list follows the JAX
`build_mesh` rules over the host's cards.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from fancyrec_tpu_torch.device import resolve_device
from fancyrec_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int            # ranks on the data axis
    model: int = 1       # ranks on the model axis
    rank: int = 0        # this process's rank in the world

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def part(self, n: int) -> Optional[Tuple[int, int]]:
        """This model rank's (offset, size) of a dimension of n that the
        model axis splits, or None where it stays whole: one model rank,
        or an n the axis does not divide (`_rule_for`'s fallback)."""
        if self.model <= 1 or n % self.model:
            return None
        size = n // self.model
        return self.model_rank * size, size


def parse_mesh_shape(spec: str) -> Optional[Tuple[int, int]]:
    """"R,M" -> (R, M), "R" -> (R, 1), "" -> None. Raises ValueError for a
    malformed shape."""
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
    return dims


def build_mesh(mesh_shape: str = "", world: Optional[int] = None) -> Mesh:
    """mesh_shape "R,M" -> Mesh(data=R, model=M) over the world; "" ->
    every rank on data. Raises ValueError when the shape needs more ranks
    than the world has (as the JAX package does for devices), and when it
    leaves ranks idle: each rank of the world holds one place of the mesh.
    In a world, lays the world out (`collectives.set_layout`): every rank
    must call it with the same shape."""
    in_world = world is None
    world = collectives.world_size() if world is None else world
    dims = parse_mesh_shape(mesh_shape) or (world, 1)
    n = dims[0] * dims[1]
    if n > world:
        raise ValueError("mesh %s needs %d ranks, have %d" % (dims, n, world))
    if n != world:
        raise ValueError(
            "mesh %s leaves %d of the world's %d ranks idle: every rank takes "
            "one place of the mesh (R * M must equal the world: --mesh_shape "
            "%d,1, or '')" % (dims, world - n, world, world))
    if in_world:
        collectives.set_layout(*dims)
    return Mesh(data=dims[0], model=dims[1], rank=collectives.rank())


# parameter name -> the dim the model axis splits (the JAX package's
# PartitionSpecs, on torch layouts)
_PARAM_RULES: Tuple[Tuple[str, int], ...] = (
    (r"brand_encoding\.aspects_embeddings$", 0),
    (r"brand_encoding\.brand_embeddings$", 1),
    (r"(visual|text)_mapping\.fc1\.weight$", 1),
    (r"bert\.layer_\d+\.intermediate\.weight$", 0),
    (r"bert\.layer_\d+\.intermediate\.bias$", 0),
    (r"bert\.layer_\d+\.output\.weight$", 1),
)


def _rule_for(mesh: Mesh, name: str, shape: Sequence[int]) -> Optional[int]:
    """The dim of the full tensor `name` of `shape` that the model axis
    splits, or None (replicated): no rule, one model rank, or a dim the
    axis does not divide."""
    for pat, dim in _PARAM_RULES:
        if re.search(pat, name):
            split = len(shape) > dim and mesh.part(shape[dim]) is not None
            return dim if split else None
    return None


def param_shardings(mesh: Mesh, shapes: Mapping[str, Sequence[int]]
                    ) -> Dict[str, Optional[int]]:
    """{name: split dim or None} for the FULL tensors' shapes (a state
    dict, or {name: shape})."""
    return {k: _rule_for(mesh, k, tuple(getattr(v, "shape", v)))
            for k, v in shapes.items()}


def cut(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's contiguous part of the full tensor t along dim."""
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_rank * n, n).clone()


def join(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' parts t, concatenated along dim in model order: the
    inverse of `cut`, a collective of the model group."""
    return collectives.all_gather(t.detach().movedim(dim, 0).contiguous(),
                                  collectives.MODEL).movedim(0, dim
                                                             ).contiguous()


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict -> this model rank's: each split tensor `cut` to
    the rank's part of its split dim, the rest as they are."""
    return {k: full[k] if dim is None else cut(full[k], dim, mesh)
            for k, dim in param_shardings(mesh, full).items()}


def gather_state_dict(local: Mapping[str, torch.Tensor],
                      split: Mapping[str, Optional[int]]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_state_dict`, over the model group: every split
    tensor (`split`, the `param_shardings` of the full shapes, as the
    model's `split_dims` gives them) joined from the model ranks along its
    dim. A collective: every rank of the model group calls it, with the
    same names in the same order."""
    return {k: t if split.get(k) is None else join(t, split[k])
            for k, t in local.items()}


def process_batch_shard(mesh: Mesh, batch_size: int
                        ) -> Optional[Tuple[int, int]]:
    """(data rank, data ranks) when each data slot should load its own
    contiguous slice of every batch: more than one rank on data and a
    batch they divide; the model ranks of a slot load the same rows. None
    otherwise (every process loads whole batches); a world calls
    `require_divisible_batch` first, so None there means one data slot."""
    if mesh.data <= 1 or batch_size % mesh.data:
        return None
    return (mesh.data_rank, mesh.data)


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """The devices of one serving process: post shard s lives on
    devices[s], along the JAX mesh's data axis. A device may repeat, so
    several shards can share one card (or the CPU)."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a serving mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shards(self) -> int:
        return len(self.devices)


def visible_devices(device: str = "cuda") -> Tuple[torch.device, ...]:
    """The devices a serving mesh may take: every card of the host for
    'cuda' (or 'cuda:N'; raises without one), the one CPU for 'cpu'."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def serving_mesh(mesh_shape: str = "",
                 devices: Optional[Sequence] = None) -> ServingMesh:
    """The JAX `build_mesh` rules over devices (the host's cards when
    None): "" or "auto" shards over every device, "N" means "N,1", a shape
    smaller than the device count takes the leading devices, and one that
    needs more raises. The data axis holds the shards. Where the JAX mesh
    replicates a data shard over the M devices of its model row, the port
    keeps one copy, on the first of them."""
    devices = tuple(visible_devices() if devices is None else devices)
    spec = "" if mesh_shape == "auto" else mesh_shape
    data, model = parse_mesh_shape(spec) or (len(devices), 1)
    if data * model > len(devices):
        raise ValueError("mesh %s needs %d devices, have %d"
                         % ((data, model), data * model, len(devices)))
    return ServingMesh(tuple(devices[s * model] for s in range(data)))


def require_divisible_batch(mesh: Mesh, batch_size: int,
                            flag: str = "--batch_size") -> None:
    """Refuse a batch that the data axis does not divide: the ranks could
    not hold equal slices of it."""
    if mesh.data > 1 and batch_size % mesh.data:
        raise ValueError(
            "%s %d is not divisible by the data mesh axis %d: the ranks "
            "cannot hold equal slices of each batch. Pick a multiple of %d."
            % (flag, batch_size, mesh.data, mesh.data))
