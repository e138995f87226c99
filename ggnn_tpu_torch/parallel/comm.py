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

- :func:`all_to_all_start` / :func:`finish`: equal ``[P, H, D]`` chunks,
  issued asynchronously so that work queued between the two runs while the
  exchange is in flight; the backward is the reverse all-to-all (the same
  exchange of the cotangents), asynchronous too (below);
  :func:`all_to_all` is the two back to back;
- :func:`all_gather_start` / :func:`finish`: tiled on the leading axis;
  the backward is a reduce-scatter (sum); :func:`all_gather` back to back;
- :func:`psum`: all-reduce (sum), backward all-reduce (sum);
- :func:`pmax` / :func:`pmin`: forward only, on values that take no
  gradient (the reference stops the gradient before them);
- :func:`allreduce_grads`: the sum of the replicated parameters'
  gradients.

The transport is the group's backend, never a fallback: ``nccl`` gets the
device tensors; ``gloo`` with CUDA tensors gets them staged through pinned
host buffers explicitly (gloo moves host memory), and with CPU tensors the
tensors themselves.  The asynchronous forms: on ``nccl`` the collective
runs with ``async_op=True`` on NCCL's stream, which waits only for the work
queued before it (the send rows' gather), and :func:`finish` makes the
current stream wait for it (the host does not); on ``gloo`` with CUDA
tensors the send rows are copied into a pinned buffer without blocking,
the host waits for that copy's event alone (queued before the local work,
so the card has only the gather and the copy left), the collective runs
with ``async_op=True`` on gloo's threads, and :func:`finish` waits for it
and copies the received rows back without blocking; on ``gloo`` with CPU
tensors ``async_op=True``.  Any other pairing raises.

The backward mirrors the forward.  A collective that records a gradient
(grad mode on, the sent tensor requiring one) is two autograd nodes: one
recorded at the issue, on the sent tensor, and the finish's, which takes
the first's output (an empty token) as its input.  The finish's backward
issues the reverse collective through the same transports without waiting
for it; the issue's node waits and returns the sent tensor's cotangent.
The engine runs the ready node of the highest sequence number first, so
the backward of the work recorded between the issue and the finish (the
local work queued while the exchange was in flight) runs while the
reverse collective is in flight, as XLA may schedule the reference's
transposed collectives.  ``spans`` names the reverse exchange (its issue
to its wait's return) and its wait alone in a
:mod:`~ggnn_tpu_torch.profiling` trace.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ggnn_tpu_torch import profiling


def _staged(group, x) -> bool:
    """True where the collective runs on a host copy of CUDA ``x``."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _to_host(x):
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


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


class Pending:
    """A collective in flight (:func:`all_to_all_start`,
    :func:`all_gather_start`); :func:`finish` waits for it once.
    ``reverse`` is its backward's :class:`_Reverse` where it records a
    gradient (``token`` then the issue node's output), else None."""

    def __init__(self, kind, x, group, work, out, keep):
        self.kind, self.x, self.group = kind, x, group
        self._work, self._out, self._keep = work, out, keep
        self.token = self.reverse = None

    def _wait(self):
        if self._work is None:
            raise RuntimeError(f"this {self.kind} was finished already")
        self._work.wait()
        out = self._out
        if out.device != self.x.device:     # gloo staged: back to the card
            out = out.to(self.x.device, non_blocking=True)
        self._work = self._out = self._keep = None
        return out


def _start(kind, group, fn, out_shape, x) -> Pending:
    """``fn(out, inp)`` (a collective with ``async_op=True``) issued on the
    group's transport; see the module's docstring."""
    backend = dist.get_backend(group)
    src = x.detach().contiguous()
    keep = src
    if backend == dist.Backend.NCCL and src.is_cuda:
        out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    elif backend == dist.Backend.GLOO and src.is_cuda:
        keep = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        keep.copy_(src, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(src.device))
        copied.synchronize()
        out = torch.empty(out_shape, dtype=src.dtype, pin_memory=True)
    elif backend == dist.Backend.GLOO and src.device.type == "cpu":
        out = torch.empty(out_shape, dtype=src.dtype)
    else:
        raise ValueError(f"no asynchronous {kind} on backend {backend!r} "
                         f"for {src.device.type} tensors")
    work = fn(out, keep)
    return Pending(kind, x, group, work, out, keep)


def _backward(kind, group, g) -> Pending:
    """The reverse of a ``kind`` collective on the cotangent ``g``, issued
    through :func:`_start` (not waited on): the reverse all-to-all, or the
    all_gather's reduce-scatter (sum)."""
    if kind == "all_to_all":
        return _start(kind, group, lambda o, i: dist.all_to_all_single(
            o, i, group=group, async_op=True), g.shape, g)
    P = dist.get_world_size(group)
    return _start("reduce_scatter", group, lambda o, i: _reduce_scatter(
        o, i, group=group, async_op=True),
        (g.shape[0] // P, *g.shape[1:]), g)


class _Reverse:
    """A collective's reverse between its two nodes: issued by
    :class:`_Finish`'s backward, waited on by :class:`_Issue`'s, inside
    the spans ``spans`` = (issue to wait's return, the wait alone) or
    None."""

    def __init__(self, kind, group, spans):
        self.kind, self.group, self.spans = kind, group, spans
        self._pending = self._span = None

    def issue(self, g):
        if self.spans is not None:
            self._span = profiling.annotate(self.spans[0])
            self._span.__enter__()
        self._pending = _backward(self.kind, self.group, g)

    def wait(self):
        pending, span = self._pending, self._span
        self._pending = self._span = None
        if span is None:
            return pending._wait()
        with profiling.annotate(self.spans[1]):
            out = pending._wait()
        span.__exit__(None, None, None)
        return out


class _Issue(torch.autograd.Function):
    """Recorded on the sent ``x`` when a collective is issued; returns an
    empty token for :class:`_Finish`.  The backward waits for the reverse
    collective that :class:`_Finish`'s backward issued and returns x's
    cotangent."""

    @staticmethod
    def forward(ctx, x, reverse):
        ctx.reverse = reverse
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        return ctx.reverse.wait(), None


class _Finish(torch.autograd.Function):
    """The received tensor of a :class:`Pending` as a function of its
    issue's token: the backward issues the reverse all-to-all, or the
    all_gather's reduce-scatter (sum), and does not wait for it."""

    @staticmethod
    def forward(ctx, token, pending):
        ctx.reverse = pending.reverse
        return pending._wait()

    @staticmethod
    def backward(ctx, g):
        ctx.reverse.issue(g)
        return g.new_empty(0), None


def _record(pending, spans=None) -> Pending:
    """Record the issue node of ``pending`` where it takes a gradient."""
    if torch.is_grad_enabled() and pending.x.requires_grad:
        pending.reverse = _Reverse(pending.kind, pending.group, spans)
        pending.token = _Issue.apply(pending.x, pending.reverse)
    return pending


def all_to_all_start(x, group, spans=None) -> Pending:
    """Issue the all-to-all of x [P, H, …] (chunk j goes to rank j);
    :func:`finish` returns [P, H, …] whose chunk j came from rank j (the
    reference's ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``).
    ``x`` must not change before :func:`finish`.  ``spans``: the names of
    the backward's reverse exchange and of its wait (module docstring)."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all needs [P, …] chunks, got {x.shape} for "
                         f"P = {dist.get_world_size(group)}")
    return _record(_start("all_to_all", group,
                          lambda o, i: dist.all_to_all_single(
                              o, i, group=group, async_op=True),
                          x.shape, x), spans)


def all_gather_start(x, group) -> Pending:
    """Issue the all_gather of x [n, …]; :func:`finish` returns [P·n, …],
    rank r's rows at r·n (tiled)."""
    P = dist.get_world_size(group)
    return _record(_start("all_gather", group,
                          lambda o, i: _gather_into(o, i, group=group,
                                                    async_op=True),
                          (P * x.shape[0], *x.shape[1:]), x))


def finish(pending: Pending):
    """Wait for a collective issued by :func:`all_to_all_start` or
    :func:`all_gather_start`; returns what it received, on the sent
    tensor's device, differentiable with respect to the sent tensor where
    the issue recorded a gradient."""
    if pending.token is None:
        return pending._wait()
    return _Finish.apply(pending.token, pending)


class PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(group, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.group, g), None


def all_to_all(x, group):
    """:func:`all_to_all_start` and :func:`finish` back to back."""
    return finish(all_to_all_start(x, group))


def all_gather(x, group):
    """[n, …] on each rank → [P·n, …], rank r's rows at r·n (tiled):
    :func:`all_gather_start` and :func:`finish` back to back."""
    return finish(all_gather_start(x, group))


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
