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
forward of the community one, each timed by CUDA events; each
forward's h bit-equal between the two.  Then each rank's share of a
node_select train step (halo_onehot, halo_window) that the backward's
reverse all-to-alls take (synchronous; each timed alone).
"""

import argparse
import functools
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

AB_ROUNDS = 2


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
    out["reverse"] = reverse_exchange_share(mesh, state)
    out["launches"] = {}
    return out


def reverse_exchange_share(mesh, state):
    """{path: (the train step's ms, the ms of its backward's reverse
    all-to-alls)}: one node_select task step (as [sharded train]) through
    halo_onehot and halo_window, warmed up, then one with each reverse
    all-to-all (``comm._backward``, synchronous) timed on the host
    between two device synchronisations."""
    import time
    import torch
    import chip_smoke as cs
    from ggnn_tpu_torch.parallel import comm, make_sharded_task_train_step
    from ggnn_tpu_torch.train.loop import make_optimizer
    lp, slay, smeta = state["uniform"]
    clp, wl = state["community"]
    targets = {"n_nodes": torch.tensor([cs.NODES], dtype=torch.int32,
                                       device=mesh.device),
               "node": torch.tensor([cs.node_target()], dtype=torch.int32,
                                    device=mesh.device)}
    wcfg = cs.sharded_cfg(backend="window", fuse_gru=True)
    own, spent, out = comm._backward, [], {}

    def timed_a2a(kind, group, x):
        if kind != "all_to_all":
            return own(kind, group, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = own(kind, group, x)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return y

    for tag, cfg, parts, lay, meta in (
            ("halo_onehot", cs.sharded_cfg(), lp, slay, smeta),
            ("halo_window", wcfg, clp, *wl[True])):
        params = cs.sharded_params(cfg)
        opt = make_optimizer(params, cs.SHARDED_LR)
        step = make_sharded_task_train_step(
            cfg, mesh, opt, 1, strategy=tag, halo_meta=meta)
        step(params, parts, targets, lay)
        _, plain_ms, _ = cs.timed(lambda: step(params, parts, targets, lay))
        spent.clear()
        comm._backward = timed_a2a
        try:
            _, ms, _ = cs.timed(lambda: step(params, parts, targets, lay))
        finally:
            comm._backward = own
        out[tag] = (plain_ms, ms, sum(spent), len(spent))
        del params, opt, step
        torch.cuda.empty_cache()
    return out


def check_ab(results, refs, card):
    for r, res in enumerate(results):
        for tag, ms in res["ms"].items():
            print(f"[overlap a/b] rank {r} {tag}: parent "
                  f"{[round(x, 2) for x in ms['parent']]} ms, change "
                  f"{[round(x, 2) for x in ms['change']]} ms (CUDA events, "
                  "in turns); h bit-equal to the parent's: "
                  f"{res['same'][tag]}; card {card}", flush=True)
        for tag, (plain, ms, rev, n) in res["reverse"].items():
            print(f"[overlap a/b] rank {r} {tag} train step: {plain:.2f} ms; "
                  f"with its {n} reverse all-to-alls timed alone "
                  f"{ms:.2f} ms, of which they took {rev:.2f} "
                  f"({rev / ms:.1%}); card {card}", flush=True)


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
