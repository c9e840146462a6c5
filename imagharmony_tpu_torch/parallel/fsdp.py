"""ZeRO-3 sharding of parameters, gradients and AdamW state over the data
group (port of imagharmony_tpu/parallel/fsdp.py).

The reference trains DDP only: every GPU holds the whole UNet, towers and
AdamW moments (reference train.py:492-496). ``shard_tree`` keeps of each
large parameter one slice a rank (``fsdp_spec``: the largest dim the group
divides, as JAX picks it), as a Parameter of the slice's shape under the
same name, so the trainable parameters, their AdamW moments, the clip and
the EMA all work on slices. GSPMD inserts the collectives behind the JAX
rule; here forward hooks do:

* the full weight is gathered (``all_gather_into_tensor``) just before the
  module that uses it runs and dropped after it (the module's parameter is
  swapped for the gathered tensor for the call, then back); under the
  train step's activation checkpoint the UNet's recompute in the backward
  gathers again: ZeRO-3;
* a trainable weight's gather is differentiable: its backward
  reduce-scatters (``reduce_scatter_tensor``) the full gradient into the
  slice, each rank's part weighted by ``Mesh.grad_weight``, so a slice's
  gradient is the mean over the data shards, as the DP all-reduce gives
  the replicated parameters'.

The unit a hook gathers for is a leaf module's nearest ancestor that is
not a container (an ``Attention`` gathers its projections, a GEGLU its
``proj``, which it reads without calling) and, for a leaf whose ancestor
is never called (the VAE's ``quant_conv`` under ``encode``), the leaf
itself; a parameter already gathered by an outer unit is left alone.

The shard dim follows the JAX rule in JAX's logical order
(``io/from_jax.jax_order``): torch keeps (out, in) and OIHW where JAX
keeps (in, out) and HWIO, and on a tie the first dim wins, so the port
walks the dims as JAX does and shards the same logical axis.

The group is the mesh's data group, replicas included (``mesh.py``): the
JAX data axis when the batch divides over the world.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from imagharmony_tpu_torch.io import from_jax
from imagharmony_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

# Leaves smaller than this stay replicated: sharding a 32-float norm scale
# buys nothing and costs a gather. 2^13 elements = 16 KiB bf16.
MIN_SHARD_ELEMS = 2**13

_CONTAINERS = (nn.ModuleList, nn.ModuleDict, nn.Sequential)


def fsdp_spec(shape, n_shards: int, *, base=(), min_elems: int = MIN_SHARD_ELEMS,
              order=None) -> tuple:
    """``base`` (a TP spec, or () for pure FSDP) with the data axis on the
    largest still-free dim that ``n_shards`` divides, the dims walked in
    ``order`` (default 0, 1, ...; the first of equal dims wins). ``base``
    unchanged for leaves under ``min_elems`` elements or with no such dim."""
    shape = tuple(shape)
    if not shape or n_shards <= 1:
        return tuple(base)
    size = 1
    for d in shape:
        size *= d
    if size < min_elems:
        return tuple(base)
    taken = tuple(base) + (None,) * (len(shape) - len(tuple(base)))
    best = -1
    for i in (order if order is not None else range(len(shape))):
        if taken[i] is not None:
            continue
        if shape[i] % n_shards == 0 and (best < 0 or shape[i] > shape[best]):
            best = i
    if best < 0:
        return tuple(base)
    spec = list(taken)
    spec[best] = DATA_AXIS
    return tuple(spec)


def shard_dim(spec) -> Optional[int]:
    return spec.index(DATA_AXIS) if DATA_AXIS in spec else None


@dataclasses.dataclass(frozen=True, eq=False)
class ShardInfo:
    """How a Parameter is sliced: along ``dim`` of ``full_shape``, slice
    ``pos`` of ``n`` over ``mesh``'s data group."""

    dim: int
    full_shape: tuple
    n: int
    pos: int
    mesh: Mesh


def info(p) -> Optional[ShardInfo]:
    """A Parameter's ShardInfo, None for a whole one."""
    return getattr(p, "_fsdp", None)


def _gather(shard: torch.Tensor, si: ShardInfo) -> torch.Tensor:
    local = shard.detach().movedim(si.dim, 0).contiguous()
    out = torch.empty((si.n * local.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    dist.all_gather_into_tensor(out, local, group=si.mesh.data_group)
    return out.movedim(0, si.dim).contiguous()


def _reduce_scatter(full: torch.Tensor, si: ShardInfo) -> torch.Tensor:
    g = full.movedim(si.dim, 0).contiguous()
    if si.mesh.grad_weight != 1.0:
        g.mul_(si.mesh.grad_weight)
    out = torch.empty((g.shape[0] // si.n,) + tuple(g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    dist.reduce_scatter_tensor(out, g, group=si.mesh.data_group)
    return out.movedim(0, si.dim).contiguous()


class _Gather(torch.autograd.Function):
    """The full weight from its slice; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, shard, si):
        ctx.si = si
        return _gather(shard, si)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.si), None


def gather_param(x: torch.Tensor, si: ShardInfo) -> torch.Tensor:
    """The full tensor of the slice ``x`` (a sliced Parameter, or a tensor
    made from one, such as its fp32 copy), differentiable where ``x``
    requires grad and grad mode is on."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(x, si)
    with torch.no_grad():
        return _gather(x, si)


class _Unit:
    """The forward hooks of one module: gather the sliced parameters of
    ``slots`` ((module, name, ShardInfo)) that no outer unit has gathered,
    swap them in for the call, swap the slices back after. What a slot
    holds at the call may be a tensor made from the slice: the VAE's fp32
    encode passes fp32 copies of its parameters through
    ``torch.func.functional_call``; that copy is gathered."""

    def __init__(self, slots):
        self.slots = slots
        self.active = []

    def pre(self, module, args):
        mine = []
        for m, name, si in self.slots:
            cur = m._parameters[name]
            if cur is not None and tuple(cur.shape) != si.full_shape:
                m._parameters[name] = gather_param(cur, si)
                mine.append((m, name, cur))
        self.active.append(mine)

    def post(self, module, args, output):
        for m, name, p in self.active.pop():
            m._parameters[name] = p


def _unit_of(owner: nn.Module, parents) -> nn.Module:
    """The module whose call gathers ``owner``'s parameters: a leaf's
    nearest ancestor that is not a container, else ``owner``."""
    if next(owner.children(), None) is not None:
        return owner
    up = parents.get(owner)
    while up is not None and isinstance(up, _CONTAINERS):
        up = parents.get(up)
    return owner if up is None else up


def _install(root: nn.Module, sharded):
    """Forward hooks gathering ``sharded`` ((owner, name) pairs) around the
    modules that use them; returns the hook handles."""
    parents = {c: m for m in root.modules() for c in m.children()}
    units = {}
    for owner, name in sharded:
        for mod in {_unit_of(owner, parents), owner}:
            units.setdefault(mod, []).append((owner, name, info(owner._parameters[name])))
    handles = []
    for mod, slots in units.items():
        u = _Unit(slots)
        handles.append(mod.register_forward_pre_hook(u.pre))
        handles.append(mod.register_forward_hook(u.post, always_call=True))
    return handles


@torch.no_grad()
def _slice(x: torch.Tensor, dim: int, n: int, pos: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, pos * size, size).clone()


def shard_tree(mesh: Mesh, module: nn.Module, *, min_elems: int = MIN_SHARD_ELEMS,
               base: Optional[Callable[[str, tuple], tuple]] = None,
               skip: Callable[[str], bool] = lambda name: False) -> int:
    """Slice every large parameter of ``module`` over ``mesh``'s data group
    (``fsdp_spec`` in JAX's dim order), in place, and hook the gathers.
    ``base(name, shape)``: a spec whose taken dims FSDP leaves alone (the
    TP spec for ``shard_params_tp_fsdp``); ``skip(name)``: parameters to
    keep whole. Returns the number sliced (0 on a data group of one)."""
    n = mesh.data_size
    if n <= 1:
        return 0
    sharded = []
    for mname, m in module.named_modules():
        for pname, p in list(m._parameters.items()):
            name = f"{mname}.{pname}" if mname else pname
            if p is None or skip(name):
                continue
            spec = fsdp_spec(p.shape, n, base=base(name, tuple(p.shape)) if base else (),
                             min_elems=min_elems, order=from_jax.jax_order(name, p.ndim))
            dim = shard_dim(spec)
            if dim is None:
                continue
            shard = nn.Parameter(_slice(p.detach(), dim, n, mesh.data_pos),
                                 requires_grad=p.requires_grad)
            shard._fsdp = ShardInfo(dim, tuple(p.shape), n, mesh.data_pos, mesh)
            m._parameters[pname] = shard
            sharded.append((m, pname))
    module._fsdp_hooks = _install(module, sharded)
    return len(sharded)


def shard_params_tp_fsdp(mesh: Mesh, module: nn.Module, *,
                         min_elems: int = MIN_SHARD_ELEMS) -> int:
    """TP (``tp_rules.shard_module_tp`` over the model axis) composed with
    ZeRO-3 over the data axis: every parameter keeps its TP slice and
    further slices its largest free dim (JAX's production layout: DP batch
    x TP matmuls x FSDP storage). Returns the parameters FSDP sliced."""
    from imagharmony_tpu_torch.parallel import tp_rules

    tp_rules.shard_module_tp(mesh, module)
    return shard_tree(mesh, module, min_elems=min_elems, base=(
        lambda name, shape: tp_rules.tp_spec(name, shape) if mesh.n_model > 1 else ()))


@contextmanager
def gathered(*modules: nn.Module):
    """Every sliced parameter of ``modules`` whole for the block (an
    export), the slices back after. Collective: every rank enters."""
    swapped = []
    with torch.no_grad():
        for m in (m for module in modules if module is not None for m in module.modules()):
            for name, p in list(m._parameters.items()):
                if isinstance(p, nn.Parameter) and info(p) is not None:
                    m._parameters[name] = _gather(p, info(p))
                    swapped.append((m, name, p))
    try:
        yield modules
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


def full_tensor(x: torch.Tensor, si: Optional[ShardInfo]) -> torch.Tensor:
    """A sliced tensor (a parameter's or its AdamW moment's) made whole."""
    return x if si is None or x.dim() == 0 else _gather(x, si)


def local_tensor(x: torch.Tensor, si: Optional[ShardInfo]) -> torch.Tensor:
    """This rank's slice of a whole tensor."""
    return x if si is None or x.dim() == 0 else _slice(x, si.dim, si.n, si.pos)


def _map_state(sd, state, fn):
    """``TrainState.state_dict`` ``sd`` with ``fn(tensor, ShardInfo)``
    applied to the trainable values, the EMA and the AdamW moments."""
    infos = {n: info(p) for n, p in state.trainable.items()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    opt = dict(sd["optimizer"])
    opt["state"] = {i: {k: (fn(v, info(params[i])) if torch.is_tensor(v) and k != "step"
                            else v) for k, v in s.items()}
                    for i, s in sd["optimizer"]["state"].items()}
    out = dict(sd, optimizer=opt,
               trainable={n: fn(v, infos[n]) for n, v in sd["trainable"].items()})
    if sd.get("ema") is not None:
        out["ema"] = {n: fn(v, infos[n]) for n, v in sd["ema"].items()}
    return out


def full_state_dict(sd, state):
    """A sharded ``TrainState``'s ``state_dict`` made whole: what one
    device's state would be (collective: every rank calls it). Each
    tensor keeps the device it had."""
    dev = state.lr.device
    return _map_state(sd, state, lambda x, si: x if si is None else
                      full_tensor(x.to(dev), si).to(x.device))


def local_state_dict(sd, state):
    """A whole state dict (``full_state_dict``'s, or a one-device run's)
    sliced to this rank's shards, for ``TrainState.load_state_dict``."""
    return _map_state(sd, state, lambda x, si: local_tensor(x, si))
