"""The (data, slab) device mesh over torch.distributed (port of
volumetricrenderer_tpu/parallel/mesh.py): image rows shard over "data",
the volume's slices over "slab" (parallel/sweep_sharded.py), and the
differentiable collectives that parallel/ runs over the mesh's groups.

One process drives one device. The mesh is a
torch.distributed.device_mesh.DeviceMesh over the default process group,
which the caller starts first (parallel/bootstrap.initialize_distributed,
or torch.distributed.init_process_group): NCCL for "cuda", gloo for
"cpu". Its two dimensions' process groups carry the explicit collectives
of parallel/; no DTensor computes anything, so the JAX module's
NamedSharding helpers have no counterpart here.

Gradients follow one rule. Inside a sharded computation every rank's
cotangents are its share of the whole (summed over the ranks): an
all-gather's backward is a reduce-scatter, an exchange's the exchange back,
an all-to-all's the inverse all-to-all. At the edges, an input the caller
holds alike on several ranks (`replicated`) sums its cotangents over them,
so each rank gets the whole gradient; an output that several ranks hold
alike (`replicas`) scales its cotangent by 1 / their number, so a loss that
each of them computes on it counts once.

On a gloo group (the CPU backend) CUDA tensors are exchanged through host
copies that these functions make; NCCL takes them as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["DATA_AXIS", "SLAB_AXIS", "BACKENDS", "make_mesh", "mesh_ranks",
           "all_gather", "gather_replicated", "exchange", "all_to_all",
           "replicated", "replicas"]

DATA_AXIS = "data"
SLAB_AXIS = "slab"
# The process group's backend each device type needs.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(data: Optional[int] = None, slab: int = 1,
              device: str = "cuda") -> DeviceMesh:
    """A (data, slab) mesh over the world of the default process group;
    `data` defaults to world // slab. Rank r sits at (r // slab, r %
    slab): the slab ranks of one data row are consecutive. Raises
    ValueError when data * slab is not the world size or the group's
    backend is not the one `device` needs (NCCL for "cuda", gloo only for
    "cpu"), RuntimeError when no process group is running."""
    if device not in BACKENDS:
        raise ValueError(f"make_mesh: device must be one of "
                         f"{sorted(BACKENDS)}, got {device!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call parallel.bootstrap."
            "initialize_distributed or torch.distributed.init_process_group "
            "first")
    world = dist.get_world_size()
    if data is None:
        data = world // slab
    if data * slab != world:
        raise ValueError(f"mesh {data}x{slab} != {world} processes")
    backend = dist.get_backend()
    if backend != BACKENDS[device]:
        raise ValueError(f"make_mesh: a {device!r} mesh needs the "
                         f"{BACKENDS[device]} backend, the process group "
                         f"runs {backend}")
    return init_device_mesh(device, (data, slab),
                            mesh_dim_names=(DATA_AXIS, SLAB_AXIS))


def mesh_ranks(mesh: DeviceMesh):
    """(n_data, data rank, n_slab, slab rank) of this process."""
    return (mesh.size(0), mesh.get_local_rank(DATA_AXIS), mesh.size(1),
            mesh.get_local_rank(SLAB_AXIS))



def _staged(group) -> bool:
    """Whether CUDA tensors go through host copies on this group."""
    return dist.get_backend(group) == "gloo"


def _comm(x, group):
    """x as the group's backend takes it: contiguous, on the host for gloo."""
    x = x.contiguous()
    return x.cpu() if x.is_cuda and _staged(group) else x


def _gather(x, group):
    """The group's x concatenated along dim 0, in group rank order."""
    n = dist.get_world_size(group)
    y = _comm(x, group)
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, 0).to(x.device)


def _reduce_scatter(x, group):
    """The group's sum of x, chunk `group rank` of it along dim 0."""
    n = dist.get_world_size(group)
    y = _comm(x, group)
    out = torch.empty_like(y.chunk(n, 0)[0])
    dist.reduce_scatter(out, [c.contiguous() for c in y.chunk(n, 0)],
                        group=group)
    return out.to(x.device)


def _all_reduce(x, group):
    y = _comm(x, group).clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def _swap(x, peer, group):
    """Send x to the group rank `peer` and receive its tensor of x's shape."""
    y = _comm(x, group)
    got = torch.empty_like(y)
    g_peer = dist.get_global_rank(group, peer)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, g_peer, group),
            dist.P2POp(dist.irecv, got, g_peer, group)]):
        work.wait()
    return got.to(x.device)


def _a2a(x, group, split_dim, cat_dim):
    """Chunk j of x along split_dim goes to group rank j; the chunks
    received, in group rank order, are concatenated along cat_dim."""
    n = dist.get_world_size(group)
    y = _comm(x, group)
    send = [c.contiguous() for c in y.chunk(n, split_dim)]
    recv = [torch.empty_like(send[0]) for _ in range(n)]
    dist.all_to_all(recv, send, group=group)
    return torch.cat(recv, cat_dim).to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter(ct, ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, ct):
        i = dist.get_rank(ctx.group)
        return ct[i * ctx.n:(i + 1) * ctx.n], None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, peer, group):
        ctx.peer, ctx.group = peer, group
        return _swap(x, peer, group)

    @staticmethod
    def backward(ctx, ct):
        # The pairing is its own inverse: the cotangent of what came from
        # the peer goes back to it.
        return _swap(ct, ctx.peer, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.args = (group, split_dim, cat_dim)
        return _a2a(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, ct):
        group, split_dim, cat_dim = ctx.args
        return _a2a(ct, group, cat_dim, split_dim), None, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _Replicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None


def all_gather(x, group):
    """The group's x concatenated along dim 0 in group rank order, on
    every rank; backward: the reduce-scatter of the cotangents."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group)


def gather_replicated(x, group):
    """all_gather for a result that every rank of the group then uses
    alike (and so receives the same cotangent for): the backward keeps
    this rank's chunk of it, with no communication."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherReplicated.apply(x, group)


def exchange(x, peer, group):
    """Swap x with the group rank `peer` (which swaps with this one);
    backward: the same swap of the cotangents."""
    return _Exchange.apply(x, peer, group)


def all_to_all(x, group, split_dim, cat_dim):
    """Chunk j of x along split_dim to group rank j, the chunks received
    concatenated along cat_dim; backward: the inverse all-to-all."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, cat_dim)


def replicated(x, group):
    """x, which the caller holds alike on every rank of the group: the
    identity forward, the sum of the ranks' cotangents backward."""
    if dist.get_world_size(group) == 1:
        return x
    return _Replicated.apply(x, group)


def replicas(x, n):
    """x, held alike by n ranks: the identity forward, the cotangent over
    n backward."""
    return x if n == 1 else _Replicas.apply(x, n)
