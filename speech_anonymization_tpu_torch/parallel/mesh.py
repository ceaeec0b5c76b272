"""Process groups, the rank-0 gating of the recipes, and the collectives of a
data-parallel step whose values are batch-global.

Counterpart of ``speech_anonymization_tpu/parallel/mesh.py``. The JAX package
runs one program over a mesh of devices: a jitted step over a batch sharded on
``data`` computes every max, sum and mean over the GLOBAL batch, and XLA
inserts the collectives. Here each rank is one process on ``torch.distributed``
and holds its own shard, so every such value is reduced by hand, through the
helpers below:

  * :func:`psum` (differentiable: the backward all-reduces the gradient),
    :func:`pmax` (no gradient), :func:`all_gather_rows` (differentiable) and
    :func:`all_gather_objects`, over one axis of a :class:`Mesh`. Each is the
    identity, with no launch, on a one-rank axis or without a mesh;
  * :func:`psum_grads`: one all-reduce of a whole gradient dict;
    :func:`data_parallel_grads`: a micro-batch's gradients and loss terms
    summed over the ranks, the contract the brains share;
    :func:`all_gather_concat`: per-row results (lists, numpy arrays)
    gathered for an evaluation stage's statistics;
  * :func:`local_rows`: this rank's rows of a global-batch tensor (random
    draws are made for the global batch from one seeded generator, as JAX
    draws over the global shape, and each rank takes its rows);
  * :func:`use_mesh`: hands the mesh to the objects that reduce over it (the
    fbank's ``top_db`` floor, the normalizer's running statistics, the
    train-mode BatchNorms), once, in a brain's constructor.

The launch: :func:`initialize_distributed` reads the JAX package's
environment (``SATPU_COORDINATOR``, ``SATPU_NUM_PROCESSES``,
``SATPU_PROCESS_ID``; ``SATPU_MULTIHOST=1`` for ``torchrun``'s ``env://``)
and is a no-op without it; :func:`is_main_process`, :func:`global_barrier` and
:func:`run_on_main` gate the recipes' side effects on rank 0.

The multi-process contract of :func:`shard_batch` is JAX's: every rank holds
an equal-shaped shard of the global batch, padded to the global batch's time
length (relative lengths against it), the shards in rank order.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def initialize_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None) -> bool:
    """Join this process to the job's process group; call once, before
    anything touches the device. -> True when a group is (or already was)
    initialized, False when nothing announces a multi-process run.

    Configuration, in precedence order: the arguments; ``SATPU_COORDINATOR``
    (``host:port``, taken as ``tcp://host:port``; a URL such as
    ``file:///path`` is used as it is), ``SATPU_NUM_PROCESSES`` (the world
    size) and ``SATPU_PROCESS_ID`` (this rank); with neither a coordinator nor
    a process count, ``SATPU_MULTIHOST=1`` takes torch's ``env://`` launch
    (``torchrun`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``backend``: ``nccl`` (default with a card; this rank's card is
    ``LOCAL_RANK``, else the rank modulo the cards) or ``gloo`` (default
    without one; the caller may name it on the card, where it all-reduces
    CUDA tensors through the host). A failing init raises: it never falls
    back to another backend.
    """
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("SATPU_COORDINATOR")
    if num_processes is None and os.environ.get("SATPU_NUM_PROCESSES") is not None:
        num_processes = int(os.environ["SATPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SATPU_PROCESS_ID") is not None:
        process_id = int(os.environ["SATPU_PROCESS_ID"])
    auto = os.environ.get("SATPU_MULTIHOST") == "1"
    if coordinator_address is None and num_processes is None and not auto:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None and num_processes is None:
        init_method, world, rank = "env://", -1, -1
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process run needs SATPU_COORDINATOR, SATPU_NUM_PROCESSES and "
                             f"SATPU_PROCESS_ID; got {coordinator_address!r}, {num_processes!r}, "
                             f"{process_id!r}")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
        local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or True with no process group (the reference's ``if_main_process``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_barrier() -> None:
    """An all-reduce that every rank must reach before any passes, read back
    so that it has completed (a no-op with no process group)."""
    if not dist.is_initialized():
        return
    device = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
              else torch.device("cpu"))
    flag = torch.zeros(1, device=device)
    dist.all_reduce(flag)
    flag.item()


def run_on_main(fn: Callable, *args, **kwargs):
    """Run a host side effect (data preparation, a tokenizer save) on rank 0
    only, then barrier when the world has more than one rank, so that no rank
    races past it. -> ``fn``'s result on rank 0, None elsewhere."""
    result = fn(*args, **kwargs) if is_main_process() else None
    if world_size() > 1:
        global_barrier()
    return result


class Mesh:
    """The world's ranks laid out as ``shape`` on named axes (row-major), with
    one process group for this rank's slice along each axis of more than one
    rank. ``device``: where this rank's tensors live."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], coords: Sequence[int],
                 groups: dict, device: torch.device):
        self.shape, self.axis_names = tuple(shape), tuple(axis_names)
        self.coords, self.groups, self.device = tuple(coords), groups, device

    def size(self, axis: str = "data") -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str = "data") -> int:
        """This rank's position along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str = "data"):
        """The process group of this rank's slice along ``axis``; None on a one-rank axis."""
        return self.groups[axis]


def make_mesh(n: int | None = None, axis_names: Sequence[str] = ("data",), shape: Sequence[int] | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """A mesh over all ``n`` ranks of the world (default: its size; with no
    process group, one rank that creates nothing and launches nothing).
    ``shape`` lays them out, e.g. ``(dp, tp)`` on ``("data", "model")``;
    default ``(n, 1, ...)``. Every rank must call it alike: each axis slice
    of more than one rank becomes a ``dist.new_group``. ``device`` defaults to
    this rank's card under NCCL, else the CPU."""
    world = world_size()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"a mesh spans the whole world: {n} ranks asked, the world has {world}")
    shape = tuple(shape) if shape is not None else (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not lay out {n} ranks on axes {tuple(axis_names)}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(n).reshape(shape)
    groups: dict = {}
    for a, name in enumerate(axis_names):
        groups[name] = None
        if shape[a] == 1:
            continue
        if shape[a] == n:
            groups[name] = dist.group.WORLD
            continue
        for ranks in np.moveaxis(grid, a, -1).reshape(-1, shape[a]).tolist():
            group = dist.new_group(ranks)  # every rank creates every group, in one order
            if rank in ranks:
                groups[name] = group
    if device is None:
        nccl = dist.is_initialized() and dist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    coords = [int(c) for c in np.unravel_index(rank, shape)]
    return Mesh(shape, axis_names, coords, groups, torch.device(device))


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: dim 0 split over ``axis``, or replicated (None)."""

    mesh: Mesh
    axis: str | None


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """The batch dimension split over the data axis."""
    return Sharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """Place every tensor (or array) of a batch tree on the mesh's device. At
    one rank on ``axis`` that is the whole batch; above, ``batch`` is this
    process's shard of the global batch, under the module's contract (equal
    shapes, padded to the global time length, in rank order)."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(batch).to(mesh.device)
    if isinstance(batch, tuple):
        items = [shard_batch(x, mesh, axis) for x in batch]
        return type(batch)(*items) if hasattr(batch, "_fields") else tuple(items)
    if isinstance(batch, list):
        return [shard_batch(x, mesh, axis) for x in batch]
    return batch


def _group(mesh: Mesh | None, axis: str):
    return None if mesh is None else mesh.group(axis)


class _AllReduceSum(torch.autograd.Function):
    """A sum over a group whose backward is the same sum of the gradients
    (what ``torch.distributed.nn.functional.all_reduce`` computes; torch
    2.13 deprecates that one): each rank backpropagates its share of a loss
    that is the sum of the ranks' shares."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def psum(x: torch.Tensor, mesh: Mesh | None, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``; differentiable (the
    gradient is all-reduced back). The identity on a one-rank axis."""
    group = _group(mesh, axis)
    return x if group is None else _AllReduceSum.apply(x, group)


@torch.no_grad()
def pmax(x: torch.Tensor, mesh: Mesh | None, axis: str = "data") -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axis``, without a gradient."""
    group = _group(mesh, axis)
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather_rows(x: torch.Tensor, mesh: Mesh | None, axis: str = "data") -> torch.Tensor:
    """The ranks' equal-shaped ``x`` along ``axis`` concatenated on dim 0, in
    rank order; differentiable. Built on an all-reduce of zero-padded rows
    (exact: each row is added to zeros), which gloo also serves for CUDA
    tensors."""
    group = _group(mesh, axis)
    if group is None:
        return x
    i = mesh.index(axis)
    parts = [x if j == i else torch.zeros_like(x) for j in range(mesh.size(axis))]
    return _AllReduceSum.apply(torch.cat(parts), group)


def all_gather_objects(obj: Any, mesh: Mesh | None, axis: str = "data") -> list:
    """The ranks' picklable ``obj`` along ``axis``, in rank order."""
    group = _group(mesh, axis)
    if group is None:
        return [obj]
    out: list = [None] * mesh.size(axis)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather_concat(rows, mesh: Mesh | None, axis: str = "data"):
    """The ranks' per-row results (a list, or a numpy array on dim 0) along
    ``axis`` concatenated in rank order; ``rows`` itself on a one-rank axis."""
    parts = all_gather_objects(rows, mesh, axis)
    if len(parts) == 1:
        return rows
    return np.concatenate(parts) if isinstance(rows, np.ndarray) else [r for part in parts for r in part]


@torch.no_grad()
def psum_grads(grads: dict, mesh: Mesh | None, axis: str = "data") -> dict:
    """A dict of tensors summed over ``axis`` in one all-reduce of their
    concatenation."""
    group = _group(mesh, axis)
    if group is None or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    dist.all_reduce(flat, group=group)
    out, start = {}, 0
    for k, g in grads.items():
        out[k] = flat[start:start + g.numel()].view_as(g)
        start += g.numel()
    return out


def psum_terms(terms: Sequence[torch.Tensor], mesh: Mesh | None, axis: str = "data") -> tuple:
    """Scalar loss terms, each this rank's share of the global batch's,
    summed over ``axis`` in one all-reduce; detached."""
    terms = tuple(t.detach() for t in terms)
    if _group(mesh, axis) is None:
        return terms
    return tuple(psum(torch.stack(terms), mesh, axis).unbind())


def data_parallel_grads(loss: torch.Tensor, terms: Sequence[torch.Tensor], params: dict,
                        mesh: Mesh | None, axis: str = "data") -> tuple[dict, tuple]:
    """The data-parallel contract of a training micro-batch, as JAX's jit over
    a batch sharded on ``axis`` computes it. ``loss`` and ``terms`` are this
    rank's shares of the global batch's (each mean's numerator over the
    global count). -> (d loss / d ``params`` summed over the ranks in one
    all-reduce, zeros for a parameter the loss does not reach; the terms
    summed over the ranks by :func:`psum_terms`): every rank holds the global
    batch's gradients and terms, so the clip, the finite guard and the step
    are the same on every rank."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
    return psum_grads(grads, mesh, axis), psum_terms(terms, mesh, axis)


def local_rows(tree: Any, mesh: Mesh | None, axis: str = "data", blocks: int = 1) -> Any:
    """This rank's rows of every tensor in ``tree`` (tuples, named tuples,
    None and scalars pass through), whose dim 0 is the global batch: rows
    ``[i * b, (i + 1) * b)`` for rank ``i`` of ``n``, b = rows / n. With
    ``blocks`` > 1, dim 0 is that many global batches one after the other
    (the gender recipe's batch doubled by ``env_corrupt``), and the rank takes
    its rows of each."""
    if mesh is None or mesh.size(axis) == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        n, i = mesh.size(axis), mesh.index(axis)
        if tree.shape[0] % (n * blocks):
            raise ValueError(f"{tree.shape[0]} rows do not split into {blocks} x {n} equal shards")
        rows = tree.reshape(blocks, n, tree.shape[0] // (n * blocks), *tree.shape[1:])[:, i]
        return rows.reshape(-1, *tree.shape[1:])
    if isinstance(tree, tuple):
        items = [local_rows(x, mesh, axis, blocks) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def use_mesh(mesh: Mesh | None, *objects) -> None:
    """Set ``mesh`` on each object that reduces over it (a ``mesh`` attribute:
    ``Fbank``, ``InputNormalizer``, ``BatchNorm``), and on every such submodule
    of a module; None takes a mesh off. A brain calls it in its constructor,
    with or without a mesh, so an object shared through the hparams reduces
    over the mesh of the last brain built on it."""
    for obj in objects:
        found = obj.modules() if isinstance(obj, nn.Module) else [obj]
        for m in found:
            if hasattr(m, "mesh"):
                m.mesh = mesh
