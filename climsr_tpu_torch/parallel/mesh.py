# -*- coding: utf-8 -*-
"""Process mesh and ZeRO partitioning: the port of ``climsr_tpu.parallel.mesh``.

The JAX package drives one process over a mesh of N devices and lets GSPMD
insert the collectives. The port runs one process per rank (``torchrun``, or
the ranks that ``cli.train`` / ``cli.inference`` start) and reads the world
from ``torch.distributed``; a caller may initialize the process group itself,
with the backend of its choice, and the port takes that group as given.

- :func:`create_mesh`: the ``("data",)`` or ``("data", "spatial")``
  ``DeviceMesh`` over the initialized world, with the JAX rule for the
  spatial axis (pinned by ``last_axis_size``, else 2 when the world is even);
- :func:`shard_leading_dim_if_divisible` and
  :func:`shard_largest_divisible_dim`: the ZeRO rules, returning for each
  tensor the dim it is split on over the data axis, or ``None``;
- :func:`zero_gather_on_use`: all-gather a sharded parameter where it is used,
  with a backward that reduce-scatters its gradient to the rank's shard;
- :class:`ZeroPartition`: ZeRO stages 0-3 of one module's parameters, as the
  JAX step factories and Trainer place them (stage 1: optimizer state on
  shards; 2: gradients reduce-scattered too; 3: parameters kept sharded);
- :func:`process_local_slice`, :func:`put_global`, :func:`put_replicated`,
  :func:`broadcast_string`: the input helpers; :func:`shard_samples` splits
  a per-sample function of a batch every rank holds over the ranks;
  :func:`ranks_sharing_device` counts the ranks that run on one card.

The collectives here (all-reduce, all-gather, reduce-scatter, broadcast) are
ones that NCCL and gloo both take for CUDA tensors (gloo with torch 2.11 on an
H100 takes all of them). A collective that the backend refuses raises.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

MIN_SHARD_SIZE = 2**14


def world() -> Tuple[int, int]:
    """(rank, world size) of the initialized process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def create_mesh(
    num_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("data",),
    last_axis_size: Optional[int] = None,
):
    """The ``DeviceMesh`` over the initialized world (``climsr_tpu/parallel/mesh.py:23``).

    ``num_devices`` (``None``: the world) must be the world size: one process
    per rank. Returns ``None`` for a world of one process."""
    _, n = world()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"trainer.num_devices={num_devices} but the process group has {n} ranks (one per device)")
    if len(axes) == 1:
        shape: Sequence[int] = (n,)
    elif len(axes) == 2:
        if last_axis_size is not None:
            if n % last_axis_size:
                raise ValueError(f"{n} devices not divisible by {axes[1]}={last_axis_size}")
            spatial = last_axis_size
        else:
            spatial = 2 if n % 2 == 0 else 1  # favour the data axis
        shape = (n // spatial, spatial)
    else:
        raise ValueError(f"Unsupported mesh axes: {axes}")
    if n == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh only holds the groups; "cpu" keeps DeviceMesh from binding a
    # card per rank, which a gloo group sharing one card must not do
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def axis_info(mesh, axis: str) -> Tuple[Optional[dist.ProcessGroup], int, int]:
    """(group, rank in the axis, axis size) of a mesh axis; (None, 0, 1) where
    there is no mesh or no such axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None, 0, 1
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if size == 1:
        return None, 0, 1
    return mesh.get_group(axis), mesh.get_local_rank(axis), size


def _axis_size(mesh, axis: str) -> int:
    return mesh if isinstance(mesh, int) else axis_info(mesh, axis)[2]


def _shape(t) -> Tuple[int, ...]:
    return tuple(t.shape) if hasattr(t, "shape") else tuple(t)


def shard_leading_dim_if_divisible(tensors: Mapping[str, object], mesh, axis: str = "data",
                                   min_size: int = MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """ZeRO-1 rule (``:61``): dim 0 where it divides the axis size and the
    tensor has at least ``min_size`` elements, else ``None``. ``tensors`` maps
    names to tensors or shapes; ``mesh`` is a mesh or the axis size."""
    n = _axis_size(mesh, axis)
    out = {}
    for name, t in tensors.items():
        shape = _shape(t)
        size = 1
        for s in shape:
            size *= s
        out[name] = 0 if len(shape) >= 1 and size >= min_size and shape[0] % n == 0 else None
    return out


def shard_largest_divisible_dim(tensors: Mapping[str, object], mesh, axis: str = "data",
                                min_size: int = MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """ZeRO-2/3 rule (``:81``): the strictly largest dim that divides the axis
    size (the first one on a tie), for tensors of at least ``min_size``
    elements, else ``None``. Torch lays conv weights out OIHW where JAX has
    HWIO, so on ties the two packages may pick different dims; the update is
    elementwise, so the numbers do not change."""
    n = _axis_size(mesh, axis)
    out = {}
    for name, t in tensors.items():
        shape = _shape(t)
        size = 1
        for s in shape:
            size *= s
        best = None
        if len(shape) >= 1 and size >= min_size:
            for d, s in enumerate(shape):
                if s % n == 0 and s > 0 and (best is None or s > shape[best]):
                    best = d
        out[name] = best
    return out


# ---- collectives -------------------------------------------------------------
def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (rank order)."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((size * moved.shape[0],) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The sum over ranks of ``x``, split along ``dim``: this rank's chunk."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // size,) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


class _AllReduceSum(torch.autograd.Function):
    """Differentiable all-reduce (SUM) for losses that are summed over ranks:
    its backward all-reduces the gradient (the transpose of a replicated sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiably (``psum``)."""
    return _AllReduceSum.apply(x, group)


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return all_gather_dim(shard, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.size), None, None, None


def zero_gather_on_use(shard: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """ZeRO-3 gather-on-use (``:110``): the full parameter from every rank's
    shard along ``dim``; the backward reduce-scatters the parameter's gradient
    to this rank's shard, so the full gradient is never kept."""
    return _GatherOnUse.apply(shard, dim, group, size)


# ---- ZeRO partition --------------------------------------------------------------
class ZeroPartition:
    """ZeRO stage ``stage`` of ``model``'s trainable parameters over the mesh's
    data axis (``spatial`` ranks hold the same shards and sum their gradients).

    - every stage: the gradients are summed over the world (each rank's loss
      is its share of the global loss; with ``sum_spatial=False`` over the
      data axis only), and :meth:`grad_norm` is the global norm, each element
      counted once;
    - stage >= 1: each parameter that :func:`shard_largest_divisible_dim`
      splits is updated on this rank's shard only (:attr:`opt_params` are
      the leaves the optimizer holds), so the optimizer state is sharded;
      the updated shards are all-gathered back (:meth:`publish`);
    - stage >= 2: those gradients are reduce-scattered, not all-reduced;
    - stage 3: the parameters stay sharded between steps; :meth:`gathered`
      swaps the gathered parameters in for a forward (:func:`zero_gather_on_use`),
      and the module's own parameters are empty until :meth:`materialize`.
    """

    def __init__(self, model: nn.Module, stage: int, mesh, min_size: int = MIN_SHARD_SIZE,
                 sum_spatial: bool = True):
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"zero stage must be 0-3, got {stage}")
        self.model, self.stage, self.mesh = model, stage, mesh
        self.group, self.rank, self.size = axis_info(mesh, "data")
        # a model every spatial rank runs on the same whole frames (the spatial
        # GAN step's discriminator) has the same gradient there: summed over
        # the data axis only
        self.spatial_group = axis_info(mesh, "spatial")[0] if sum_spatial else None
        self.replicated_group = None if sum_spatial else self.group
        self.named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.dims: Dict[str, Optional[int]] = (
            shard_largest_divisible_dim(dict(self.named), self.size, min_size=min_size)
            if stage >= 1 and self.size > 1 else {n: None for n, _ in self.named})
        self.shapes = {n: tuple(p.shape) for n, p in self.named}
        self.shards: Dict[str, torch.Tensor] = {}
        for n, p in self.named:
            self.shards[n] = p if self.dims[n] is None else nn.Parameter(self.shard_of(n, p.detach()).clone())
        if stage >= 3:
            self.release()

    @property
    def opt_params(self) -> List[torch.Tensor]:
        return [self.shards[n] for n, _ in self.named]

    def is_sharded(self, name: str) -> bool:
        return self.dims[name] is not None

    # -- forward --------------------------------------------------------------
    @contextmanager
    def gathered(self) -> Iterator[None]:
        """Stage 3: the module's sharded parameters are the gathered ones for
        the forward in the block (their gradients reach the shards). Other
        stages: nothing to do."""
        if self.stage < 3:
            yield
            return
        owners = dict(self.model.named_modules())
        saved = []
        for n, _ in self.named:
            if self.dims[n] is None:
                continue
            mod_name, _, attr = n.rpartition(".")
            mod = owners[mod_name]
            saved.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = zero_gather_on_use(self.shards[n], self.dims[n], self.group, self.size)
        for mod in self.model.modules():
            if hasattr(mod, "_packed"):  # weight packings cached by storage address
                mod._packed = None
        try:
            yield
        finally:
            for mod, attr, p in saved:
                mod._parameters[attr] = p

    # -- gradients ---------------------------------------------------------------
    def reduce_gradients(self) -> None:
        """Sum the gradients of this step over the world, onto the leaves the
        optimizer holds."""
        replicated, sharded = [], []
        for n, p in self.named:
            if self.dims[n] is None:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                replicated.append(p.grad)
            else:
                sharded.append(n)
        if self.stage < 2:  # stages 0 and 1: one all-reduce of every gradient
            replicated = replicated + [self.model.get_parameter(n).grad for n in sharded]
            _all_reduce_flat(replicated, self.replicated_group)
            for n in sharded:
                p = self.model.get_parameter(n)
                self.shards[n].grad = self.shard_of(n, p.grad).clone()
                p.grad = None
            return
        _all_reduce_flat(replicated, self.replicated_group)
        for n in sharded:
            if self.stage == 2:
                p = self.model.get_parameter(n)
                self.shards[n].grad = reduce_scatter_dim(p.grad, self.dims[n], self.group, self.size)
                p.grad = None
            elif self.shards[n].grad is None:
                self.shards[n].grad = torch.zeros_like(self.shards[n])
        if self.spatial_group is not None:
            _all_reduce_flat([self.shards[n].grad for n in sharded], self.spatial_group)

    def grad_norm(self, grads: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The global L2 norm of the reduced gradients (or of ``grads``, given
        in :attr:`opt_params` order), each element counted once."""
        grads = [s.grad for s in self.opt_params] if grads is None else grads
        rep, shd = [], []
        for (n, _), g in zip(self.named, grads):
            if g is not None:
                (shd if self.dims[n] is not None else rep).append(torch.sum(torch.square(g.float())))
        dev = self.opt_params[0].device
        total_rep = torch.stack(rep).sum() if rep else torch.zeros((), device=dev)
        total_shd = torch.stack(shd).sum() if shd else torch.zeros((), device=dev)
        if shd and self.group is not None:
            dist.all_reduce(total_shd, group=self.group)
        return torch.sqrt(total_rep + total_shd)

    # -- parameters ----------------------------------------------------------------
    @torch.no_grad()
    def publish(self) -> None:
        """Stages 1 and 2: all-gather the updated shards into the module's
        parameters (in place, so every cache keyed on them sees the change)."""
        if self.stage in (1, 2):
            for n, _ in self.named:
                if self.dims[n] is not None:
                    self.model.get_parameter(n).copy_(
                        all_gather_dim(self.shards[n].detach(), self.dims[n], self.group, self.size))

    @torch.no_grad()
    def materialize(self) -> None:
        """Stage 3: the module's parameters, gathered from the shards (for
        evaluation and checkpoints); :meth:`release` empties them again."""
        if self.stage >= 3:
            for n, _ in self.named:
                if self.dims[n] is not None:
                    self.model.get_parameter(n).data = all_gather_dim(
                        self.shards[n].detach(), self.dims[n], self.group, self.size)

    def shard_of(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``, a tensor of parameter ``name``'s full
        shape, cut as the parameter is sharded (``t`` itself where it is not)."""
        d = self.dims[name]
        return t if d is None else t.chunk(self.size, d)[self.rank]

    @torch.no_grad()
    def reshard(self) -> None:
        """Copy this rank's chunks of the module's (full) parameters into the
        shards, after a load; stage 3 then wants :meth:`release`."""
        for n, p in self.named:
            if self.dims[n] is not None:
                self.shards[n].copy_(self.shard_of(n, p))

    def release(self) -> None:
        if self.stage >= 3:
            for n, p in self.named:
                if self.dims[n] is not None:
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
                    p.grad = None

    # -- optimizer state -------------------------------------------------------------
    def full_optimizer_state(self, state: dict) -> dict:
        """A sharded optimizer's ``state_dict`` with each per-parameter tensor
        of a sharded parameter gathered to its full shape: the single-process
        layout, for a checkpoint."""
        return self._map_state(state, lambda t, n: all_gather_dim(t, self.dims[n], self.group, self.size))

    def shard_optimizer_state(self, state: dict) -> dict:
        """The reverse of :meth:`full_optimizer_state`: this rank's chunks."""
        return self._map_state(state, lambda t, n: self.shard_of(n, t).clone())

    def _map_state(self, state: dict, fn) -> dict:
        names = [n for n, _ in self.named]
        out = dict(state)
        out["state"] = {
            i: {k: (fn(v, names[i]) if torch.is_tensor(v) and self.dims[names[i]] is not None
                    and tuple(v.shape) != () else v) for k, v in s.items()}
            for i, s in state["state"].items()
        }
        chain = dict(state.get("chain") or {})
        if chain.get("acc") is not None:
            chain["acc"] = [fn(a, n) if self.dims[n] is not None else a for a, n in zip(chain["acc"], names)]
            out["chain"] = chain
        return out


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """All-reduce (SUM) a list of tensors in place, as one flat buffer."""
    if not tensors or not dist.is_initialized():
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


# ---- inputs ----------------------------------------------------------------------
def process_local_slice(n: int, mesh=None, axis: str = "data") -> slice:
    """This rank's contiguous slice of a length-``n`` global batch axis
    (``:197``): the mesh's data axis, or the whole world without a mesh."""
    if mesh is None:
        rank, size = world()
    else:
        _, rank, size = axis_info(mesh, axis)
    if n % size:
        raise ValueError(
            f"global batch axis of size {n} does not divide over {size} processes; "
            "drop_last/padding must be handled upstream (data/pipeline.py)"
        )
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def shard_samples(fn, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``fn(batch)`` for a batch that every rank holds whole, the samples split
    over the world: each rank runs ``fn`` on its ``ceil(n / world)`` samples
    (the last sample repeated past ``n``) and the outputs are all-gathered in
    rank order and cut back to ``n``, as the JAX eval shards its batches over
    the data axis. ``fn`` must treat each sample alone; tensors whose leading
    dim is not ``n`` are passed whole. One rank: ``fn(batch)``."""
    rank, size = world()
    if size == 1:
        return fn(batch)
    n = next(v.shape[0] for v in batch.values() if torch.is_tensor(v) and v.ndim)
    per = -(-n // size)

    def take(v):
        if not (torch.is_tensor(v) and v.ndim and v.shape[0] == n):
            return v
        idx = torch.arange(rank * per, (rank + 1) * per, device=v.device).clamp_(max=n - 1)
        return v.index_select(0, idx)

    out = fn({k: take(v) for k, v in batch.items()})
    return all_gather_dim(out, 0, None, size)[:n]


Tree = Union[torch.Tensor, Mapping, Sequence]


def put_global(tree, device, mesh=None, axis: str = "data"):
    """Each rank moves its own slice of every batch-leading tensor of a
    global batch to ``device`` (``:145``); scalars are moved as they are."""

    def put(x):
        t = torch.as_tensor(x)
        if t.ndim == 0:
            return t.to(device)
        return t[process_local_slice(t.shape[0], mesh, axis)].to(device)

    return _tree_map(put, tree)


def put_replicated(tree, device):
    """Every rank moves the whole of ``tree`` to ``device``."""
    return _tree_map(lambda x: torch.as_tensor(x).to(device), tree)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def broadcast_string(s: str, max_len: int = 256) -> str:
    """Rank 0's string on every rank (``:175``); the length is checked even
    on one process, so an over-long value fails before the first multi-rank run."""
    raw = s.encode()
    if len(raw) > max_len:
        raise ValueError(f"broadcast_string: {len(raw)}-byte string exceeds max_len={max_len}")
    if world()[1] == 1:
        return s
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    buf = torch.zeros(max_len + 1, dtype=torch.uint8, device=dev)
    if dist.get_rank() == 0:
        buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    dist.broadcast(buf, 0)
    out = buf.cpu().numpy().tobytes()
    return out[: out.index(0)].decode() if 0 in out else out.decode()


def ranks_sharing_device(device) -> int:
    """The number of ranks of the world that run on this rank's ``device`` of
    this host: several gloo ranks may share one card, NCCL ranks take one
    each; 1 on one process."""
    _, n = world()
    if n == 1:
        return 1
    import socket

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mine = (socket.gethostname(), str(dev))
    everyone: List[Optional[Tuple[str, str]]] = [None] * n
    dist.all_gather_object(everyone, mine)
    return everyone.count(mine)
