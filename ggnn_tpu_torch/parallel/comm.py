"""The collectives of the parallel layer, over ``torch.distributed`` process
groups: what the reference takes from ``jax.lax`` inside ``shard_map``.

Gradient convention (one for the whole layer): a loss that every rank of a
group holds a replica of is seeded with 1/P on each rank; :func:`psum`'s
backward is an all-reduce (sum) of the cotangents; every replicated
parameter's gradient is then all-reduced (sum) over the group
(:func:`allreduce_grads`).  A cotangent that reaches a psum'd value from
all P replicas is then summed to the true one, and a parameter used after
a psum (whose gradient each replica computes whole, times 1/P) sums to its
true gradient as well.

- :func:`all_to_all`: equal ``[P, H, D]`` chunks; its backward is the
  reverse all-to-all (the same exchange of the cotangents);
- :func:`all_gather`: tiled on the leading axis; its backward is a
  reduce-scatter (sum);
- :func:`psum`: all-reduce (sum), backward all-reduce (sum);
- :func:`pmax` / :func:`pmin`: forward only, on values that take no
  gradient (the reference stops the gradient before them);
- :func:`allreduce_grads`: the sum of the replicated parameters'
  gradients.

The transport is the group's backend, never a fallback: ``nccl`` gets the
device tensors; ``gloo`` with CUDA tensors gets them staged through pinned
host buffers explicitly (gloo moves host memory), and with CPU tensors the
tensors themselves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(group, x) -> bool:
    """True where the collective runs on a host copy of CUDA ``x``."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _to_host(x):
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def _run(group, fn, out_shape, x):
    """``fn(out, inp)`` on ``x`` (contiguous), on the group's transport;
    returns ``out`` on ``x``'s device."""
    x = x.contiguous()
    if _staged(group, x):
        out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
        fn(out, _to_host(x))
        return out.to(x.device)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    fn(out, x)
    return out


def _all_to_all(group, x):
    return _run(group, lambda o, i: dist.all_to_all_single(o, i, group=group),
                x.shape, x)


_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_gather(group, x):
    P = dist.get_world_size(group)
    return _run(group, lambda o, i: _gather_into(o, i, group=group),
                (P * x.shape[0], *x.shape[1:]), x)


def _reduce_scatter_sum(group, x):
    P = dist.get_world_size(group)
    return _run(group, lambda o, i: _reduce_scatter(o, i, group=group),
                (x.shape[0] // P, *x.shape[1:]), x)


def _all_reduce(group, x, op=dist.ReduceOp.SUM):
    """A new tensor holding the all-reduce of ``x`` (``x`` untouched)."""
    x = x.contiguous()
    if _staged(group, x):
        buf = _to_host(x)
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(x.device)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(group, x)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.group, g), None


class AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(group, x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_sum(ctx.group, g), None


class PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(group, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.group, g), None


def all_to_all(x, group):
    """x [P, H, …]: chunk j goes to rank j; returns [P, H, …] whose chunk j
    came from rank j (the reference's ``all_to_all(split_axis=0,
    concat_axis=0, tiled=False)``)."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all needs [P, …] chunks, got {x.shape} for "
                         f"P = {dist.get_world_size(group)}")
    return AllToAll.apply(x, group)


def all_gather(x, group):
    """[n, …] on each rank → [P·n, …], rank r's rows at r·n (tiled)."""
    return AllGather.apply(x, group)


def psum(x, group):
    """The sum of ``x`` over the group's ranks."""
    return PSum.apply(x, group)


def pmax(x, group):
    """The elementwise max over the group; forward only."""
    if x.requires_grad:
        raise ValueError("pmax takes no gradient: detach its input (the "
                         "reference stops the gradient before it)")
    return _all_reduce(group, x, dist.ReduceOp.MAX)


def pmin(x, group):
    """The elementwise min over the group; forward only."""
    if x.requires_grad:
        raise ValueError("pmin takes no gradient: detach its input")
    return _all_reduce(group, x, dist.ReduceOp.MIN)


def allreduce_grads(params, group) -> None:
    """Sum the ``.grad`` of every parameter in ``params`` over the group, in
    place (one flattened all-reduce per dtype).  Every rank passes the same
    parameters, in the same order."""
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        flat = _all_reduce(group, flat)
        off = 0
        for p in ps:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).clone()
            off += n
