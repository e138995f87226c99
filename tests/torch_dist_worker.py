"""Rank worker of the port's sharded CPU tests (not a test module).

A job is a list of cases (``cases.pkl`` in a job directory, written by the
test process with :class:`RankJob`).  Each rank is one process of a gloo
world on the CPU, joined through the environment a launcher such as
``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) by ``ggnn_tpu_torch.parallel.multihost.
initialize_multihost``; it runs every case on its mesh and writes what it
computed to ``<case>.<rank>.npz``.  One spawn per test module runs all of
its cases.  It imports the port, never ``jax`` or ``ggnn_tpu``.

    python tests/torch_dist_worker.py <job_dir>      (with the env above)
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(t):
    import torch
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _params(case, device="cpu"):
    """The case's parameters as trainable tensors."""
    from ggnn_tpu_torch.models.init import params_from_numpy
    from ggnn_tpu_torch.train.loop import param_leaves
    params = params_from_numpy(case["params"], device)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def _cfg(case):
    from ggnn_tpu_torch.models.config import ModelConfig
    return ModelConfig(**case["cfg"])


def _parts(case):
    """The case's partition (and its split and stacked kernel layouts)."""
    from ggnn_tpu_torch.parallel.partition import (
        build_halo_scatter_layouts, build_halo_window_layouts,
        partition_batch, split_local_remote)
    parts = partition_batch(case["batch"], case["P"], **case.get("part", {}))
    lay = case.get("layout")
    if lay is None:
        return parts, None
    lay = dict(lay)
    kind = lay.pop("kind")
    if kind == "scatter":
        return parts, build_halo_scatter_layouts(parts, **lay)
    split_local_remote(parts)
    return parts, build_halo_window_layouts(parts, **lay)


def run_propagate(case, mesh):
    """h_local of ``sharded_propagate`` (the host partition, or with
    ``local`` the rank's LocalParts and layout)."""
    import torch
    from ggnn_tpu_torch.parallel import sharded_propagate
    from ggnn_tpu_torch.parallel.partition import (local_halo_layout,
                                                   split_local_remote)
    prop = _params(case)["prop"]
    parts, lay = _parts(case)
    if case.get("local"):
        split_local_remote(parts)
        idx = mesh.axis("graph").index
        parts = parts.local(idx, mesh.device)
        lay = None if lay is None else local_halo_layout(lay, idx,
                                                         mesh.device)
    with torch.no_grad():
        h = sharded_propagate(prop, _cfg(case), mesh, parts,
                              strategy=case["strategy"], halo_layouts=lay,
                              scatter_tile_e=case.get("scatter_tile_e", 512))
    return {"h": _np(h)}


def _grads(params):
    return {f"g/{k}": _np(v.grad) for k, v in _flat(params).items()
            if v.grad is not None}


def _values(params, tag="p"):
    return {f"{tag}/{k}": _np(v) for k, v in _flat(params).items()}


def run_train(case, mesh):
    """One ``make_sharded_train_step`` (Adam): loss, the summed gradients,
    the updated parameters."""
    from ggnn_tpu_torch.parallel import make_sharded_train_step
    from ggnn_tpu_torch.train.loop import make_optimizer
    prop = _params(case)["prop"]
    opt = make_optimizer(prop, case["lr"])
    parts, lay = _parts(case)
    step = make_sharded_train_step(
        _cfg(case), mesh, opt, strategy=case["strategy"],
        halo_meta=None if lay is None else lay[1])
    loss = step(prop, parts, None if lay is None else lay[0])
    return {"loss": _np(loss), **_grads(prop), **_values(prop)}


def _targets(case):
    import torch
    return {k: torch.as_tensor(v) for k, v in case["targets"].items()}


def run_task(case, mesh):
    """``make_sharded_task_train_step`` for ``steps`` Adam steps: each
    step's metrics, the first step's gradients, the final parameters."""
    import numpy as np
    from ggnn_tpu_torch.parallel import make_sharded_task_train_step
    from ggnn_tpu_torch.train.loop import make_optimizer
    params = _params(case)
    opt = make_optimizer(params, case["lr"])
    parts, lay = _parts(case)
    step = make_sharded_task_train_step(
        _cfg(case), mesh, opt, case["n_graphs"], strategy=case["strategy"],
        halo_meta=None if lay is None else lay[1])
    targets, out, metrics = _targets(case), {}, []
    for i in range(case.get("steps", 1)):
        m = step(params, parts, targets, None if lay is None else lay[0])
        metrics.append([float(m[k]) for k in ("loss_sum", "correct",
                                              "count")])
        if i == 0:
            out.update(_grads(params))
    return {"metrics": np.asarray(metrics), **out, **_values(params)}


def run_eval(case, mesh):
    import numpy as np
    from ggnn_tpu_torch.parallel import make_sharded_eval_step
    parts, lay = _parts(case)
    step = make_sharded_eval_step(_cfg(case), mesh, case["n_graphs"],
                                  strategy=case["strategy"],
                                  halo_meta=None if lay is None else lay[1])
    m = step(_params(case), parts, _targets(case),
             None if lay is None else lay[0])
    return {"metrics": np.asarray([float(m[k]) for k in
                                   ("loss_sum", "correct", "count")])}


def run_ddp(case, mesh):
    """One data-parallel step (``parallel/train.py``) over the mesh."""
    import numpy as np
    from ggnn_tpu_torch.parallel.train import (make_gspmd_train_step,
                                               shard_batch_arrays)
    from ggnn_tpu_torch.train.loop import make_optimizer
    params = _params(case)
    opt = make_optimizer(params, case["lr"])
    step = make_gspmd_train_step(_cfg(case), case["n_graphs"], opt, mesh)
    m = step(params, shard_batch_arrays(case["batch"], mesh))
    return {"metrics": np.asarray([float(m[k]) for k in
                                   ("loss_sum", "correct", "count")]),
            **_grads(params), **_values(params)}


def run_example(case, mesh):
    """``examples/torch_distributed_production.py``'s stages on this rank
    (its own mesh over the whole world): each train iteration's loss, the
    first iteration's gradients, the trained weights and the q8-served
    h."""
    import importlib.util
    import numpy as np
    path = os.path.join(ROOT, "examples", "torch_distributed_production.py")
    spec = importlib.util.spec_from_file_location("dist_example", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    quiet = lambda *a, **k: None    # noqa: E731
    state = ex.setup(device=mesh.device, params=case["params"], log=quiet,
                     **case["example"])
    ex.train(state, 1, quiet)
    grads = _grads(state["prop"])
    ex.train(state, case["train_iters"] - 1, quiet)
    h = ex.serve(state, quiet)
    return {"losses": np.asarray(state["losses"]), "h": _np(h), **grads,
            **_values(state["prop"])}


def _serial_propagate(prop, cfg, lp, layout, axis):
    """The serial composition of a halo_overlap (``layout`` None) or
    unfused halo_window step: the synchronous all-to-all, then the local
    and remote aggregations, summed local first."""
    import torch
    from ggnn_tpu_torch.models.ggnn import fuse_gru, gru_update, init_state
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops.segment import typed_aggregate
    from ggnn_tpu_torch.ops.segment_rows import gather_rows
    from ggnn_tpu_torch.ops.window_step import aggregate_window
    from ggnn_tpu_torch.parallel import comm
    if lp.hot_size:
        raise AssertionError("the serial composition takes no hot set")
    cdt, n = torch_dtype(cfg.compute_dtype), lp.n_local

    def typed(pool, e):
        return typed_aggregate(pool, e["src"], e["dst"], e["type"],
                               e["mask"], prop["msg_w"], prop["msg_b"],
                               strategy=cfg.agg_strategy)[:n]

    h = init_state(lp.annotations, cfg.state_dim)
    for _ in range(cfg.n_steps):
        hc = h.to(cdt)
        send = gather_rows(hc, lp.send_idx.reshape(-1).long())
        recv = comm.all_to_all(send.reshape(axis.size, lp.halo_size, -1),
                               axis.group)
        pool = torch.cat([recv.reshape(-1, hc.shape[-1]), hc])
        if layout is None:
            a_loc = typed(hc, lp.local_edges)
        else:
            a_loc = aggregate_window(hc, layout, prop["msg_w"].to(cdt),
                                     prop["msg_b"].to(cdt))[:n]
        a = a_loc + typed(pool, lp.remote_edges)
        h = gru_update(prop["gru"], h, a, fuse_gru(prop["gru"]))
    return h


def run_overlap(case, mesh):
    """``sharded_propagate`` (halo_overlap, or unfused halo_window) with
    the ``time.time()`` stamps of its spans (enter, exit) and of each
    all-to-all's issue, the issue held back ``hold_s`` on graph index 1;
    beside it :func:`_serial_propagate` of the same rows."""
    import contextlib
    import time
    import numpy as np
    import torch
    from ggnn_tpu_torch import profiling
    from ggnn_tpu_torch.parallel import comm, sharded_propagate
    from ggnn_tpu_torch.parallel.partition import (local_halo_layout,
                                                   split_local_remote)
    prop = _params(case)["prop"]
    parts, lay = _parts(case)
    split_local_remote(parts)
    axis = mesh.axis("graph")
    lp = parts.local(axis.index, mesh.device)
    layout = None if lay is None else local_halo_layout(lay, axis.index,
                                                        mesh.device)
    stamps = {"halo/exchange": [], "halo/local": [], "halo/wait": [],
              "halo/remote": [], "issue": []}
    annotate, start = profiling.annotate, comm.all_to_all_start

    @contextlib.contextmanager
    def stamped(name):
        t0 = time.time()
        yield
        stamps[name].append((t0, time.time()))

    def held_start(x, group, **kw):
        if axis.index == 1:
            time.sleep(case["hold_s"])
        t = time.time()
        stamps["issue"].append((t, t))
        return start(x, group, **kw)

    # the ranks set out together: the hold alone separates them
    torch.distributed.barrier(group=axis.group)
    profiling.annotate, comm.all_to_all_start = stamped, held_start
    try:
        with torch.no_grad():
            h = sharded_propagate(prop, _cfg(case), mesh, lp,
                                  strategy=case["strategy"],
                                  halo_layouts=layout)
    finally:
        profiling.annotate, comm.all_to_all_start = annotate, start
    with torch.no_grad():
        serial = _serial_propagate(prop, _cfg(case), lp, layout, axis)
    return {"h": _np(h), "serial": _np(serial),
            **{f"t/{k}": np.asarray(v, np.float64).reshape(-1, 2)
               for k, v in stamps.items()}}


class _Waited:
    """A reverse collective waited on at its issue (the synchronous
    order)."""

    def __init__(self, out):
        self.out = out

    def _wait(self):
        return self.out


def _seq():
    """The sequence number of a node recorded now on this thread (the
    autograd engine runs the ready node of the highest number first)."""
    import torch
    with torch.enable_grad():
        return torch.zeros((), requires_grad=True).neg().grad_fn._sequence_nr()


def _hook_windows(root, windows, log):
    """On every node of the graph under ``root`` whose sequence number lies
    inside ``windows[k]`` = (lo, hi), a pre-hook and a hook that append
    ``time.time()`` to ``log[k][0]`` (its backward begins) and
    ``log[k][1]`` (it ends)."""
    import time
    seen, stack = {}, [root]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        n = node._sequence_nr()
        for k, (lo, hi) in enumerate(windows):
            if lo < n < hi:
                node.register_prehook(
                    lambda g, k=k: log[k][0].append(time.time()))
                node.register_hook(
                    lambda gi, go, k=k: log[k][1].append(time.time()))
        stack.extend(f for f, _ in node.next_functions)


def run_bwd_overlap(case, mesh):
    """One ``make_sharded_train_step`` (Adam) with graph index 1 holding
    each reverse all-to-all back ``hold_s``: the ``time.time()`` stamps of
    each reverse collective's issue and wait (``t/rev``: time, kind — 0 the
    all-to-all, 1 another — and 0 issue, 1 wait), of the spans
    ``halo/bwd_exchange`` and ``halo/bwd_wait``, and, per step, the first
    begin and last end of the backward of the nodes recorded inside the
    step's ``halo/local`` span (``t/local``, forward order); then the same
    step from the same parameters with each reverse collective waited on
    at its issue (``sync/``).  The gradients and updated parameters of
    both."""
    import contextlib
    import time
    import numpy as np
    import torch
    from ggnn_tpu_torch import profiling
    from ggnn_tpu_torch.parallel import comm, halo, make_sharded_train_step
    from ggnn_tpu_torch.train.loop import make_optimizer
    parts, lay = _parts(case)
    axis = mesh.axis("graph")
    own = (profiling.annotate, comm._backward, halo._sum_grads_and_step)
    windows, local, rev = [], [], []
    stamps = {"halo/bwd_exchange": [], "halo/bwd_wait": []}

    @contextlib.contextmanager
    def stamped(name):
        lo = _seq() if name == "halo/local" else None
        t0 = time.time()
        yield
        if name in stamps:
            stamps[name].append((t0, time.time()))
        if lo is not None:
            windows.append((lo, _seq()))

    def held(kind, group, g):
        a2a = kind == "all_to_all"
        if a2a and axis.index == 1:
            time.sleep(case["hold_s"])
        rev.append((time.time(), 1 - a2a, 0))
        out = own[1](kind, group, g)
        if hasattr(out, "_wait"):
            wait = out._wait

            def stamped_wait():
                rev.append((time.time(), 1 - a2a, 1))
                return wait()
            out._wait = stamped_wait
        return out

    def hooked(params, loss, optimizer, axis_):
        local.extend(([], []) for _ in windows)
        _hook_windows(loss.grad_fn, windows, local)
        return own[2](params, loss, optimizer, axis_)

    def waited(kind, group, g):
        out = own[1](kind, group, g)
        # a reverse that returns its result was waited on at its issue
        return _Waited(out._wait()) if hasattr(out, "_wait") else out

    def step():
        prop = _params(case)["prop"]
        opt = make_optimizer(prop, case["lr"])
        train = make_sharded_train_step(
            _cfg(case), mesh, opt, strategy=case["strategy"],
            halo_meta=None if lay is None else lay[1])
        loss = train(prop, parts, None if lay is None else lay[0])
        return {"loss": _np(loss), **_grads(prop), **_values(prop)}

    # the ranks set out together: the hold alone separates them
    torch.distributed.barrier(group=axis.group)
    profiling.annotate, comm._backward, halo._sum_grads_and_step = \
        stamped, held, hooked
    try:
        out = step()
    finally:
        profiling.annotate, comm._backward, halo._sum_grads_and_step = own
    comm._backward = waited
    try:
        sync = step()
    finally:
        comm._backward = own[1]
    span = [[min(b, default=np.nan), max(e, default=np.nan)]
            for b, e in local]
    return {**out, **{f"sync/{k}": v for k, v in sync.items()},
            "t/local": np.asarray(span, np.float64).reshape(-1, 2),
            "t/rev": np.asarray(rev, np.float64).reshape(-1, 3),
            **{f"t/{k}": np.asarray(v, np.float64).reshape(-1, 2)
               for k, v in stamps.items()}}


RUNNERS = {"propagate": run_propagate, "train": run_train, "task": run_task,
           "eval": run_eval, "ddp": run_ddp, "example": run_example,
           "overlap": run_overlap, "bwd_overlap": run_bwd_overlap}


def mesh_key(case):
    """(n_graph, n_data) of a case's mesh: the sharded cases put P ranks on
    the graph axis of a grid that fills the world (P = 2 on a world of 4:
    two data replicas); the data-parallel step runs on P ranks of the data
    axis."""
    return (1, case["P"]) if case["kind"] == "ddp" else (case["P"], None)


def main(job_dir: str) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from ggnn_tpu_torch.parallel import make_mesh
    from ggnn_tpu_torch.parallel.multihost import (initialize_multihost,
                                                   is_primary)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    # the rendezvous from the environment alone
    if not initialize_multihost(init_timeout_s=120, backend="gloo",
                                device="cpu"):
        raise AssertionError("initialize_multihost did not join the world")
    if dist.get_world_size() != world or is_primary() != (rank == 0):
        raise AssertionError("the world does not match the environment")
    with open(os.path.join(job_dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    meshes = {}
    for case in cases:           # every rank makes every group, in order
        n_graph, n_data = mesh_key(case)
        key = (n_graph, n_data or world // n_graph)
        if key not in meshes:
            meshes[key] = make_mesh(n_graph=key[0], n_data=key[1],
                                    device="cpu")
        case["_mesh"] = key
    for case in cases:
        mesh = meshes[case.pop("_mesh")]
        if mesh is None:
            continue
        out = RUNNERS[case["kind"]](case, mesh)
        np.savez(os.path.join(job_dir, f"{case['name']}.{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


class RankJob:
    """``world`` gloo ranks running ``cases`` (a list of dicts with a
    unique ``name``, ``kind``, ``P`` and the runner's inputs) in
    ``job_dir``; started at once, joined (with ``timeout`` seconds) at the
    first :meth:`result`."""

    def __init__(self, cases, world: int, job_dir, timeout: float = 600):
        self.dir, self.world, self.timeout = str(job_dir), world, timeout
        with open(os.path.join(self.dir, "cases.pkl"), "wb") as f:
            pickle.dump(cases, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.procs, self.logs = [], []
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank),
                       OMP_NUM_THREADS="1")
            log = open(os.path.join(self.dir, f"rank{rank}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), self.dir],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        self.rcs = None

    def wait(self):
        if self.rcs is not None:
            return self.rcs
        try:
            for p in self.procs:
                p.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        self.rcs = [p.returncode for p in self.procs]
        return self.rcs

    def log(self, rank: int) -> str:
        with open(os.path.join(self.dir, f"rank{rank}.log")) as f:
            return f.read()

    def result(self, name: str, rank: int = 0) -> dict:
        """What ``rank`` wrote for case ``name``; raises with the ranks'
        logs where a rank failed."""
        import numpy as np
        rcs = self.wait()
        path = os.path.join(self.dir, f"{name}.{rank}.npz")
        if any(rc != 0 for rc in rcs) or not os.path.exists(path):
            logs = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                             f"{self.log(r)[-3000:]}"
                             for r, rc in enumerate(rcs))
            raise AssertionError(f"rank job failed ({name}):\n{logs}")
        with np.load(path) as f:
            return dict(f)


if __name__ == "__main__":
    try:
        main(sys.argv[1])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        # a failed rank ends at once: the others then fail in their next
        # collective instead of waiting for it
        os._exit(1)
