"""The ranks as a (data, model) mesh (port of imagharmony_tpu/parallel/mesh.py).

The JAX mesh is one controller's devices, and GSPMD inserts the
collectives; here each rank is a process, and the port calls the
collectives itself over two kinds of process group:

  data:  the batch dimension (train batches, an edit's noise rows, the PNS
         seed fan-out); the DP gradient reduction, FSDP's gathers and
         reduce-scatters and the gather of an edit's rows run over it
  model: tensor parallelism of the attention and FFN projections
         (``tp_rules.py``); the row-parallel all-reduce runs over it

Rank r sits at model index ``r % n_model`` and data index
``(r // n_model) % n_data``. JAX leaves the devices beyond
``n_data * n_model`` idle; the port runs them as replicas of a data shard
(a batch of 3 rows on 4 ranks: rank 3 repeats rank 0's row). A data group
holds every rank of one model index, replicas included, and the DP
reduction weights each rank by 1 / (n_data * copies of its shard), so it
still gives the global batch's mean. ``n_model`` must divide the world.

Without a process group (one process, no ``init_process_group``) a mesh is
1 x 1 and every collective here is a no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh and its two groups."""

    n_data: int
    n_model: int
    world: int
    rank: int
    data_group: Optional[object] = None  # None: no collective (a world of one)
    model_group: Optional[object] = None

    @property
    def data_index(self) -> int:
        return (self.rank // self.n_model) % self.n_data

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def data_size(self) -> int:
        """Ranks in this rank's data group, replicas included."""
        return self.world // self.n_model

    @property
    def data_pos(self) -> int:
        """This rank's position in its data group (its FSDP shard)."""
        return self.rank // self.n_model

    @property
    def copies(self) -> int:
        """Ranks of the data group holding this rank's data shard."""
        g = self.data_size
        return g // self.n_data + (1 if self.data_index < g % self.n_data else 0)

    @property
    def grad_weight(self) -> float:
        """This rank's weight in the DP reduction: the weighted sum over
        the data group is the mean over the data shards."""
        return 1.0 / (self.n_data * self.copies)

    @property
    def key(self):
        """What a captured program depends on: (rank, n_data, n_model)."""
        return (self.rank, self.n_data, self.n_model)

    def __repr__(self):
        return (f"Mesh(data={self.n_data}, model={self.n_model}, rank {self.rank} of "
                f"{self.world})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the process group (collective: every
    rank calls it, in the same order as any other group it makes).
    ``n_data`` defaults to world // n_model."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model {n_model} does not divide the world of {world} ranks")
    if n_data is None:
        n_data = world // n_model
    if not 1 <= n_data <= world // n_model:
        raise ValueError(f"n_data {n_data} x n_model {n_model} does not fit {world} ranks")
    mesh = Mesh(n_data, n_model, world, rank)
    if not dist.is_initialized():
        return mesh
    if n_model == 1:
        mesh.data_group = dist.group.WORLD
        return mesh
    for m in range(n_model):  # every rank makes every group, in one order
        g = dist.new_group(list(range(m, world, n_model)))
        if m == mesh.model_index:
            mesh.data_group = g
    for b in range(world // n_model):
        g = dist.new_group(list(range(b * n_model, (b + 1) * n_model)))
        if b == rank // n_model:
            mesh.model_group = g
    return mesh


def fit_data_axis(batch_size: int, world: int, n_model: int = 1) -> int:
    """The largest data axis of at most world // n_model ranks that divides
    ``batch_size`` (JAX ``fit_data_mesh``'s rule)."""
    n_data = 1
    for d in range(1, world // n_model + 1):
        if batch_size % d == 0:
            n_data = d
    return n_data


def fit_data_mesh(batch_size: int, n_model: int = 1) -> Mesh:
    """A mesh whose data axis divides ``batch_size``: a 2-row debug batch on
    eight ranks shards 2-way (the other six are replicas)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(fit_data_axis(batch_size, world, n_model), n_model)


def row_slice(mesh: Optional[Mesh], rows: int) -> Optional[slice]:
    """This rank's rows of ``rows`` split over ``data``; None where a rank
    takes all of them (no mesh, a data axis of 1, or rows it does not
    divide, which every rank then computes: JAX's replicated fallback)."""
    if mesh is None or mesh.n_data == 1 or rows % mesh.n_data:
        return None
    per = rows // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This rank's rows of each tensor of a batch dict (axis 0 over
    ``data``, JAX's ``data_sharded`` placement; None values kept); the rows
    must divide. The batch itself without a mesh or with a data axis of 1."""
    if mesh is None or mesh.n_data == 1:
        return batch
    out = {}
    for k, x in batch.items():
        sl = None if x is None else row_slice(mesh, x.shape[0])
        if x is not None and sl is None:
            raise ValueError(f"{k}: {x.shape[0]} rows do not split over {mesh.n_data} shards")
        out[k] = x if sl is None else x[sl]
    return out


@torch.no_grad()
def replicate(mesh: Mesh, tensors):
    """Broadcast each tensor of ``tensors`` (an iterable, or a dict's
    values) from rank 0 over the world, in place (JAX's ``replicated``
    placement); returns ``tensors``."""
    if dist.is_initialized() and mesh.world > 1:
        for x in (tensors.values() if isinstance(tensors, dict) else tensors):
            dist.broadcast(x, 0)
    return tensors


def gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The whole batch from each rank's rows (``row_slice``'s split): an
    all-gather over the data group, the first copy of each shard kept."""
    if mesh is None or mesh.n_data == 1:
        return x
    x = x.contiguous()
    out = torch.empty((mesh.data_size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.data_group)
    return out[:mesh.n_data * x.shape[0]]


@torch.no_grad()
def reduce_mean(mesh: Optional[Mesh], tensors) -> None:
    """The mean over the data shards of each tensor of ``tensors``, in place
    on every rank: one flat all-reduce over the data group a dtype (bf16
    gradients stay bf16 on the wire), the tensors weighted by
    ``grad_weight``. Runs at a world of one too (a captured program then
    holds the collective)."""
    if mesh is None or mesh.data_group is None:
        return
    by_dtype = {}
    for t in tensors:
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        if mesh.grad_weight != 1.0:
            flat.mul_(mesh.grad_weight)
        dist.all_reduce(flat, group=mesh.data_group)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
