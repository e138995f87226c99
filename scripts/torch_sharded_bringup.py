"""The short first call on the card after the parallel layer
(``ggnn_tpu_torch/parallel``) changes.

    python3 scripts/torch_sharded_bringup.py [--parent DIR]

Imports ``chip_smoke.py`` and runs its sharded phases: ``setup()`` (the
kernels' build), the GGS-NN cell's batch and typed pack (``ggsnn_batch``),
then ``sharded_phases``: the single-device references on the card, two
ranks on cuda:0 over gloo (``[sharded serve]`` with ``[overlap]``,
``[sharded train]``, ``[sharded ggsnn]``, ``[ddp]``, each against the
single-device path), ``[sharded nccl]`` (a world of one rank on NCCL) and
``[scaling]`` (``bench_scaling_gpu.py`` through torchrun); then
``[dryrun]`` (the entry forward, ``dryrun_multichip(2)`` and ``(3)``, and
node_select on a batch with an empty slot).  Prints each phase's time, the
launches of the sharded paths, then the card's nvidia-smi line.

With ``--parent DIR`` (an unpacked tree of an earlier commit, e.g. ``git
archive HEAD | tar -x -C .chip_scratch/parent``) the two ranks also run
``[overlap a/b]`` after the other rank phases: DIR's
``parallel/halo.py`` with DIR's ``parallel/comm.py`` (loaded beside this
tree's package, everything else shared) and this tree's, in turns in each
rank (parent, change, change, parent, AB_ROUNDS times), on the
halo_overlap forward of the uniform headline and the unfused halo_window
forward of the community one, then on one node_select train step (as
``[sharded train]``) through halo_overlap and halo_onehot (the uniform
headline) and fused halo_window (the community one, on-demand), each
timed by CUDA events; each forward's h and each step's loss and gradient
leaves bit-equal between the two.  Then, for the three train steps, the
host time from each reverse all-to-all's issue to its wait's return (the
``halo/bwd_exchange`` span) and of the wait alone (``halo/bwd_wait``),
summed over a step, beside the step's time (no synchronisation added).
"""

import argparse
import functools
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

AB_ROUNDS = 5


def load_parent_halo(parent):
    """DIR's ``parallel/halo.py`` as a module bound to DIR's
    ``parallel/comm.py`` (the rest of the package is this tree's)."""
    import ggnn_tpu_torch.parallel as par

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(parent, "ggnn_tpu_torch", "parallel", rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    own = par.comm
    par.comm = load("parent_comm", "comm.py")
    try:
        return load("parent_halo", "halo.py")
    finally:
        par.comm = own


def rank_ab(parent, mesh, state):
    """[overlap a/b] on this rank (after [sharded serve], whose partitions
    and layouts it reuses)."""
    import dataclasses
    import torch
    import chip_smoke as cs
    from ggnn_tpu_torch.parallel import halo
    from ggnn_tpu_torch.train.loop import param_leaves
    trees = {"parent": load_parent_halo(parent), "change": halo}
    params = cs.sharded_params(cs.sharded_cfg())
    for p in param_leaves(params):
        p.requires_grad_(False)
    lp = state["uniform"][0]
    clp, wl = state["community"]
    wcfg = cs.sharded_cfg(backend="window", fuse_gru=False)
    paths = {"halo_overlap": (cs.sharded_cfg(), lp, None),
             "halo_window unfused": (wcfg, clp, wl[False][0])}
    out = {"ms": {}, "same": {}}
    for tag, (cfg, parts, lay) in paths.items():
        ms = {k: [] for k in trees}
        hs = {}
        for _ in range(AB_ROUNDS):
            for who in ("parent", "change", "change", "parent"):
                def run():
                    with torch.inference_mode():
                        return trees[who].sharded_propagate(
                            params["prop"], cfg, mesh, parts,
                            strategy=tag.split()[0], halo_layouts=lay)
                if who not in hs:
                    run()
                h, t, _ = cs.timed(run)
                hs[who] = h.float().cpu()
                ms[who].append(t)
        out["ms"][tag] = ms
        out["same"][tag] = bool(torch.equal(hs["parent"], hs["change"]))
    for tag, (cfg, parts, lay, meta) in train_paths(state).items():
        ms = {k: [] for k in trees}
        runs = {}
        for _ in range(AB_ROUNDS):
            for who in ("parent", "change", "change", "parent"):
                if who not in runs:
                    train_step(trees[who], mesh, tag, cfg, parts, lay, meta)
                runs[who], t = train_step(trees[who], mesh, tag, cfg, parts,
                                          lay, meta)
                ms[who].append(t)
        out["ms"][f"{tag} train step"] = ms
        out["same"][f"{tag} train step"] = all(
            torch.equal(runs["parent"][k], runs["change"][k])
            for k in runs["change"]) and runs["parent"].keys() == \
            runs["change"].keys()
        del runs
        torch.cuda.empty_cache()
    out["reverse"] = reverse_exchange_share(mesh, state)
    out["launches"] = {}
    return out


def train_paths(state):
    """{tag: (cfg, the rank's parts, layout, halo_meta)} of the train steps
    timed here: halo_overlap and halo_onehot on the uniform headline,
    fused halo_window on-demand on the community one."""
    import chip_smoke as cs
    lp, slay, smeta = state["uniform"]
    clp, wl = state["community"]
    return {"halo_overlap": (cs.sharded_cfg(), lp, None, None),
            "halo_onehot": (cs.sharded_cfg(), lp, slay, smeta),
            "halo_window": (cs.sharded_cfg(backend="window", fuse_gru=True),
                            clp, *wl[True])}


def train_step(tree, mesh, tag, cfg, parts, lay, meta):
    """One node_select task step of ``tree``'s ``halo`` module from fresh
    parameters (as [sharded train]): ({"loss", every gradient leaf}, its
    ms by CUDA events)."""
    import torch
    import chip_smoke as cs
    from ggnn_tpu_torch.train.loop import make_optimizer
    targets = {"n_nodes": torch.tensor([cs.NODES], dtype=torch.int32,
                                       device=mesh.device),
               "node": torch.tensor([cs.node_target()], dtype=torch.int32,
                                    device=mesh.device)}
    params = cs.sharded_params(cfg)
    opt = make_optimizer(params, cs.SHARDED_LR)
    step = tree.make_sharded_task_train_step(cfg, mesh, opt, 1,
                                             strategy=tag, halo_meta=meta)
    m, ms, _ = cs.timed(lambda: step(params, parts, targets, lay))
    out = {"loss": m["loss_sum"].detach().cpu()}
    out.update({k: v.detach().cpu()
                for k, v in cs.flat_grads(params).items()})
    return out, ms


def reverse_exchange_share(mesh, state):
    """{path: (the step's ms, the summed host ms from each reverse
    all-to-all's issue to its wait's return, of the waits alone, their
    count)}: one node_select task step (as [sharded train]) of each of
    :func:`train_paths`, warmed up, then one with the reverse all-to-alls'
    issues (``comm._backward``) and waits stamped on the host, with no
    synchronisation added."""
    import time
    from ggnn_tpu_torch.parallel import comm, halo
    own, spans, out = comm._backward, [], {}

    def stamped(kind, group, x):
        if kind != "all_to_all":
            return own(kind, group, x)
        t0 = time.perf_counter()
        pending = own(kind, group, x)
        wait = pending._wait

        def stamped_wait():
            t1 = time.perf_counter()
            y = wait()
            t2 = time.perf_counter()
            spans.append(((t2 - t0) * 1e3, (t2 - t1) * 1e3))
            return y
        pending._wait = stamped_wait
        return pending

    for tag, (cfg, parts, lay, meta) in train_paths(state).items():
        train_step(halo, mesh, tag, cfg, parts, lay, meta)
        spans.clear()
        comm._backward = stamped
        try:
            _, ms = train_step(halo, mesh, tag, cfg, parts, lay, meta)
        finally:
            comm._backward = own
        out[tag] = (ms, sum(x for x, _ in spans), sum(w for _, w in spans),
                    len(spans))
    return out


def check_ab(results, refs, card):
    for r, res in enumerate(results):
        for tag, ms in res["ms"].items():
            what = "loss and gradients" if "train" in tag else "h"
            print(f"[overlap a/b] rank {r} {tag}: parent "
                  f"{[round(x, 2) for x in ms['parent']]} ms, change "
                  f"{[round(x, 2) for x in ms['change']]} ms (CUDA events, "
                  f"in turns); {what} bit-equal to the parent's: "
                  f"{res['same'][tag]}; card {card}", flush=True)
        for tag, (ms, rev, wait, n) in res["reverse"].items():
            print(f"[overlap a/b] rank {r} {tag} train step: {ms:.2f} ms; "
                  f"its {n} reverse all-to-alls from issue to wait's return "
                  f"{rev:.2f} ms on the host ({rev / ms:.1%} of the step), "
                  f"of which the waits {wait:.2f} ({wait / ms:.1%}); card "
                  f"{card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sharded_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    clock = cs.PhaseClock()
    card, _ = cs.setup()
    clock.mark("setup and build")
    _, batch, lay = cs.ggsnn_batch()
    holder = [batch, lay]
    del batch, lay
    extra = () if args.parent is None else (
        ("[overlap a/b]",
         functools.partial(rank_ab, os.path.abspath(args.parent)),
         check_ab),)
    launched = cs.sharded_phases(holder, clock, extra)
    print(f"launches on the sharded paths "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    cs.dryrun_phase()
    clock.mark("[dryrun]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
