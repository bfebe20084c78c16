"""Device meshes and shardings over `torch.distributed` ranks.

Counterpart: ray_tpu/parallel/mesh.py. The reference builds one
`jax.sharding.Mesh` whose named axes carry every parallelism dimension and
lets GSPMD insert the collectives. Here the view is `shard_map`'s: every
rank is a process that holds its local box of each sharded tensor, and
every cross-rank step is an explicit collective over a mesh axis
(`parallel/collectives.py`).

Axis conventions (the reference's):
    dp — data parallelism (batch dim; gradient psum)
    fsdp — parameter sharding a la ZeRO-3 (params gathered on use)
    tp — tensor parallelism (matmul output/head dim)
    sp — sequence/context parallelism (sequence dim)
    pp — pipeline stages
    ep — expert parallelism (MoE expert dim)

Ranks are laid out row-major over the mesh's axes, as the reference
reshapes its device list. A `Mesh` holds, for every set of axes of size
> 1, the process group of the ranks that differ from this one only along
those axes, so a collective over a tuple of axes (the loss's sum over
(dp, fsdp, sp), a gather over (dp, fsdp)) is one call over one group.

A spec is the reference's PartitionSpec (`P`): per tensor dimension None,
an axis name, or a tuple of names (the first the major one). An axis the
mesh lacks counts as size 1.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")


@dataclass(frozen=True)
class MeshConfig:
    """Degrees for each parallelism axis; -1 on one axis = use the remaining
    ranks. Axes of degree 1 still exist in the mesh so specs can always
    name them."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        fixed = 1
        wild = None
        for a, s in sizes.items():
            if s == -1:
                if wild is not None:
                    raise ValueError("only one mesh axis may be -1")
                wild = a
            else:
                fixed *= s
        if wild is not None:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by {fixed}")
            sizes[wild] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


class P(tuple):
    """PartitionSpec: one entry per tensor dimension, each None, an axis
    name, or a tuple of axis names. Trailing dimensions left out are not
    sharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def devices_distinct(device_ids) -> bool:
    """True when every rank names a device and no two name the same one."""
    ids = list(device_ids)
    return None not in ids and len(set(ids)) == len(ids)


def cuda_device_id(device=None) -> str:
    """A card's identity across processes: its UUID."""
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device)
    return str(props.uuid)


class Mesh:
    """Named axes over the ranks of the default process group (or over one
    process, with no group, when every axis has size 1).

    `backend` is the default group's backend. It decides how a collective
    moves a CUDA tensor: under "gloo" through pinned host memory, under
    "nccl" directly. Under "nccl" every rank must hold its own card: ranks
    that share one raise here, before any collective runs. `stats` counts
    the collectives run through the mesh, their bytes and their host
    seconds (under gloo with CUDA tensors: from the staging copy out to the
    copy back, after the producing kernels have finished)."""

    def __init__(self, sizes: dict[str, int]):
        self.axis_names = tuple(sizes)
        self.shape = {a: int(n) for a, n in sizes.items()}
        world = math.prod(self.shape.values())
        if dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != world:
                raise ValueError(
                    f"mesh {self.shape} needs {world} ranks, the process "
                    f"group has {dist.get_world_size()}")
            self.rank = dist.get_rank()
            self.backend = dist.get_backend()
        elif world != 1:
            raise RuntimeError(
                f"mesh {self.shape} spans {world} ranks: call "
                f"torch.distributed.init_process_group first")
        else:
            self.rank, self.backend = 0, None
        self.coords = {}
        rest = self.rank
        for a in reversed(self.axis_names):
            rest, self.coords[a] = divmod(rest, self.shape[a])
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        if self.backend == "nccl":
            self._check_own_cards()
        # one group per (set of live axes, coordinates of the other axes);
        # every rank creates every group, in the same order. A group's
        # members, row-major over its axes in mesh order, are ascending
        # global ranks, which is the order torch gives its group ranks.
        live = [a for a in self.axis_names if self.shape[a] > 1]
        self._groups: dict[tuple, object] = {}
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                others = [(0,) if b in axes else range(self.shape[b])
                          for b in self.axis_names]
                lines = [self._members(axes, dict(zip(self.axis_names, fixed)))
                         for fixed in itertools.product(*others)]
                self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                    lines)

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _members(self, axes, coords: dict) -> list[int]:
        """Global ranks of the block along `axes` through `coords`,
        row-major over `axes` in the order given."""
        return [self._rank_of({**coords, **dict(zip(axes, js))})
                for js in itertools.product(*(range(self.shape[a])
                                              for a in axes))]

    def _check_own_cards(self):
        """NCCL takes one card per rank: raise when two ranks share one."""
        check = dist.new_group(backend="gloo")
        ids = [None] * dist.get_world_size()
        dist.all_gather_object(ids, cuda_device_id(), group=check)
        dist.destroy_process_group(check)
        if not devices_distinct(ids):
            raise RuntimeError(
                f"nccl needs one CUDA device per rank; the ranks' devices "
                f"are {ids}: use the gloo backend for ranks that share a "
                f"card")

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"

    # ------------------------------------------------------------ queries
    def size(self, axes) -> int:
        """Product of the sizes of `axes` (a name, a tuple, or None); an
        axis the mesh lacks counts 1."""
        return math.prod(self.shape.get(a, 1) for a in spec_axes(axes))

    def index(self, axes) -> int:
        """This rank's coordinate along `axes`, row-major over a tuple."""
        i = 0
        for a in spec_axes(axes):
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def live_axes(self, axes) -> tuple[str, ...]:
        """The axes of `axes` that have size > 1."""
        return tuple(a for a in spec_axes(axes) if self.shape.get(a, 1) > 1)

    def group(self, axes):
        """(process group, its members' global ranks row-major over the
        live axes of `axes` in the order given) of this rank's block along
        those axes (at least one of size > 1). The group numbers its
        members by ascending global rank, which differs from the list's
        order only when `axes` is not in mesh order."""
        live = self.live_axes(axes)
        key = tuple(a for a in self.axis_names if a in live)
        return self._groups[key], self._members(live, self.coords)

    def local_box(self, shape, spec) -> list[tuple[int, int]]:
        """[start, stop) of this rank's block along each dimension of a
        tensor of global `shape` under `spec`."""
        spec = tuple(spec or ())
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than {tuple(shape)}")
        box = []
        for d, n in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            parts = self.size(entry)
            if n % parts:
                raise ValueError(
                    f"dimension {d} of {tuple(shape)} ({n}) does not divide "
                    f"over {entry} ({parts})")
            step = n // parts
            i = self.index(entry)
            box.append((i * step, (i + 1) * step))
        return box

    def local_shape(self, shape, spec) -> tuple[int, ...]:
        return tuple(b - a for a, b in self.local_box(shape, spec))

    def global_shape(self, local_shape, spec) -> tuple[int, ...]:
        spec = tuple(spec or ())
        return tuple(n * self.size(spec[d] if d < len(spec) else None)
                     for d, n in enumerate(local_shape))


def build_mesh(config: MeshConfig | None = None,
               world_size: int | None = None) -> Mesh:
    """A mesh over every rank of the default process group (one process
    when there is none), with the axes of AXIS_ORDER sized by `config`."""
    config = config or MeshConfig()
    if world_size is None:
        world_size = (dist.get_world_size()
                      if dist.is_available() and dist.is_initialized() else 1)
    return Mesh(config.resolve(world_size))


def local_mesh(n: int | None = None, axis: str = "dp") -> Mesh:
    """1-axis mesh over the ranks (n, when given, must be their number)."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if n is not None and n != world:
        raise ValueError(f"local_mesh({n}) over a world of {world} ranks")
    return Mesh({axis: world})


def replicated(mesh: Mesh) -> P:
    return P()


def data_sharding(mesh: Mesh, *, batch_axes: tuple[str, ...] = ("dp", "fsdp"),
                  seq_axis: str | None = None) -> P:
    """Batch sharded over the data axes; optionally sequence over sp.
    For [batch, seq, ...] inputs."""
    if seq_axis:
        return P(batch_axes, seq_axis)
    return P(batch_axes)


def shard_tensor(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor `x` under `spec` (a copy)."""
    box = mesh.local_box(x.shape, spec)
    return x[tuple(slice(a, b) for a, b in box)].clone()


def shard_params(params, specs, mesh: Mesh):
    """Cut each full tensor of `params` into this rank's local box under the
    matching spec of `specs` (a tree of the same structure)."""
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, s, mesh)
                            for v, s in zip(params, specs))
    return shard_tensor(params, specs, mesh)


def spec_tree_like(params, fn):
    """Build a spec tree by calling fn(path, leaf) over params. Dotted keys
    (a state_dict's) split into path components, so a flat state_dict and
    the nested tree it names give the same paths."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + tuple(str(k).split(".")))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (str(i),))
                              for i, v in enumerate(tree))
        return fn(path, tree)

    return walk(params, ())
