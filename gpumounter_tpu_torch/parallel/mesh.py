"""A process mesh of one or two axes over torch.distributed.

Counterpart of ``gpumounter_tpu/parallel/mesh.py``. The reference hands a
``jax.sharding.Mesh`` to GSPMD, which places the shards and inserts the
collectives. PyTorch has no GSPMD: the port runs one process per rank, and
each rank holds a ``Mesh`` that says where it sits (its coordinate on each
axis), which ranks share each axis (one process group per axis) and which
device it computes on. The collectives are explicit
(``parallel/collectives.py``) and counted on the mesh. Two axes serve the
(data, model) and (data, seq) layouts, one axis the pipeline's ("pipe",)
and the ring's ("seq",).
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.parallel.collectives import all_gather


def mesh_shape_for(n_devices: int) -> tuple[int, int]:
    """(data, model) mesh shape: widest model axis that divides n_devices,
    capped at 8 (a v5e host), model axis preferred over ICI-local groups."""
    model = 1
    for cand in (8, 4, 2):
        if n_devices % cand == 0 and n_devices >= cand:
            model = cand
            break
    return n_devices // model, model


class Mesh:
    """This rank's place in a grid of ranks of one or two axes, laid out
    row-major as ``np.array(ranks).reshape(shape)`` is in the reference.

    axis_names: the axes, the data axis first where there are two. shape,
    coords: each axis's size and this rank's index along it. groups: each
    axis's process group (the ranks that differ from this one only along
    it). device: where this rank computes. calls, bytes: the collectives
    run over each axis since the last ``reset_counts()``, and the bytes of
    the tensors they reduced, gathered or sent (the payload, not the
    traffic on the wire). sent: the point-to-point messages sent over each
    axis since the mesh was made, which ``collectives.ring_shift`` uses as
    tags; reset_counts leaves it, so that every rank numbers alike.
    """

    def __init__(self, axis_names, shape, rank: int, groups: dict,
                 device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape, strict=True))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, divmod(rank, shape[1]) if len(shape) == 2
                               else (rank,), strict=True))
        self.groups = groups
        self.device = device
        self.sent = dict.fromkeys(self.axis_names, 0)
        self.reset_counts()

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def rank_at(self, axis: str, coord: int) -> int:
        """The global rank at `coord` along `axis`, this rank's coordinates
        on the other axis kept."""
        coords = dict(self.coords, **{axis: coord})
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + coords[name]
        return rank

    def reset_counts(self) -> None:
        self.calls = dict.fromkeys(self.axis_names, 0)
        self.bytes = dict.fromkeys(self.axis_names, 0)


def build_mesh(shape: tuple[int, ...] | None = None,
               axis_names: tuple[str, ...] = ("data", "model"),
               device="cuda") -> Mesh | None:
    """This rank's Mesh over the initialised default process group.

    The caller starts torch.distributed with the backend it chooses; this
    never picks or swaps one. shape, of one axis or two, defaults to
    ``mesh_shape_for(world size)``; axis_names has one name per axis (a
    one-axis mesh is the reference's ``Mesh(devices, ("pipe",))``). The
    mesh holds the first prod(shape) ranks, the whole world unless the
    shape is smaller (the reference's ``Mesh(devices[:n])``); a rank
    outside it gets None. Every rank must call this, in the same order as
    its other group creations: each axis's groups are made with
    ``dist.new_group`` on all ranks. The device is
    ``cuda:(LOCAL_RANK % device_count)`` (LOCAL_RANK from the environment,
    else the global rank), or the CPU when the caller passes device="cpu".
    """
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs torch.distributed initialised "
                           "(init_process_group with the backend of your choice)")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = tuple(shape) if shape is not None else mesh_shape_for(world)
    if (len(shape) not in (1, 2) or len(axis_names) != len(shape)
            or not 1 <= math.prod(shape) <= world):
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not fit "
                         f"the world of {world} ranks")
    if len(shape) == 1:
        sets_by_axis = [(axis_names[0], [list(range(shape[0]))])]
    else:
        n_data, n_model = shape
        rows = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
        cols = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
        sets_by_axis = [(axis_names[1], rows), (axis_names[0], cols)]
    groups = {}
    for axis, sets in sets_by_axis:
        for ranks in sets:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    if rank >= math.prod(shape):
        return None
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return Mesh(axis_names, shape, rank, groups, device)


class HeadSplit(tuple):
    """The spec of the fused ``wqkv``: as a tuple it is the reference's
    ``(None, "model")`` (and compares equal to it), and it also carries the
    heads, so that ``shard_leaf`` and ``gather_leaf`` cut its columns by
    heads. The columns hold, left to right, the q heads', then the k
    heads', then the v heads' (n_heads, n_kv_heads, n_kv_heads blocks of
    d_head). The reference's contiguous column blocks leave GSPMD to move
    the data where each head needs it; a contiguous half here would hold
    only q. So rank r's block is its share of each of the three: its own q
    heads' columns, then its k heads', then its v heads', whole heads and
    whole GQA groups."""

    def __new__(cls, spec, n_heads: int, n_kv_heads: int, d_head: int):
        self = super().__new__(cls, spec)
        self.n_heads, self.n_kv_heads, self.d_head = n_heads, n_kv_heads, d_head
        return self

    def __getnewargs__(self):
        return tuple(self), self.n_heads, self.n_kv_heads, self.d_head

    def segments(self, axis: str, n: int) -> list[int]:
        """The widths of the q, k and v column blocks; raises ValueError
        unless both head counts divide the axis of size n."""
        if self.n_heads % n or self.n_kv_heads % n:
            raise ValueError(f"heads must divide the {axis!r} axis evenly: H={self.n_heads}, "
                             f"H_kv={self.n_kv_heads}, axis size {n}")
        return [h * self.d_head for h in (self.n_heads, self.n_kv_heads, self.n_kv_heads)]


def _segments(shape: tuple, spec: tuple, dim: int, axis: str, n: int) -> list[int]:
    """The widths of the blocks of a tensor's dim (whole shape `shape`)
    that are each cut into n equal parts, one a rank: the q, k and v
    columns of a ``HeadSplit``, else the whole dim."""
    if isinstance(spec, HeadSplit):
        widths = spec.segments(axis, n)
        if sum(widths) != shape[dim]:
            raise ValueError(f"dim {dim} of shape {shape} is not the {widths} columns of "
                             f"q, k and v")
        return widths
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {shape} does not split evenly "
                         f"over the {axis!r} axis of size {n}")
    return [shape[dim]]


def shard_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of x, a new contiguous tensor on the mesh's device.

    spec names, per dim of x, the mesh axis it is split over, or None (the
    reference's PartitionSpec as a tuple; dims past its end are whole, so
    ``()`` is the replicated ``P()``). A dim split over an axis of size n
    is cut into n equal blocks, and the rank keeps the block at its
    coordinate on that axis; a ``HeadSplit`` cuts each of q, k and v so."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(x.shape)}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, c = mesh.size(axis), mesh.coord(axis)
        parts = [seg.narrow(dim, c * seg.shape[dim] // n, seg.shape[dim] // n)
                 for seg in x.split(_segments(tuple(x.shape), spec, dim, axis, n), dim)]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return x.to(mesh.device, copy=True).contiguous()


def gather_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which x is this rank's ``shard_leaf`` shard (x
    itself when spec splits nothing). Every rank of each axis that spec
    names must call it together."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        pieces = all_gather(x, mesh, axis)
        n = len(pieces)
        whole = tuple(x.shape[:dim]) + (x.shape[dim] * n,) + tuple(x.shape[dim + 1:])
        widths = [w // n for w in _segments(whole, spec, dim, axis, n)]
        x = torch.cat([torch.cat([p.split(widths, dim)[s] for p in pieces], dim)
                       for s in range(len(widths))], dim)
    return x


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch (dim 0) split over the data axis (the
    mesh's first), on the mesh's device."""
    data = mesh.axis_names[0]
    n = mesh.size(data)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split evenly over the "
                         f"{data!r} axis of size {n}")
    rows = x.shape[0] // n
    return x[mesh.coord(data) * rows:(mesh.coord(data) + 1) * rows].to(mesh.device)


def shard_qkv(x: torch.Tensor, mesh: Mesh, seq_axis: str = "seq") -> torch.Tensor:
    """This rank's chunk of a (B, H, L, D) tensor whose L is split over
    `seq_axis`, on the mesh's device: the counterpart of the reference's
    ``ring_attention.shard_qkv``."""
    return shard_leaf(x, (None, None, seq_axis, None), mesh)


def shard_tokens(tokens: torch.Tensor, mesh: Mesh, seq: bool = False) -> torch.Tensor:
    """This rank's share of a (B, L) token batch, on the mesh's device: its
    rows over the data axis (the first), and with seq also its chunk of
    positions over the second axis; the counterpart of the reference's
    ``train_step._data_spec``. The seq layout's loss scores a rank's
    positions against the next token, which may sit in the next chunk, so
    ``parallel.train_step`` hands each rank its rows whole and the model
    cuts the chunk (``models.probe``)."""
    spec = (mesh.axis_names[0], mesh.axis_names[1] if seq else None)
    return shard_leaf(tokens, spec, mesh)
