"""The short first call on the card for the 1M-node training cells.

    python3 scripts/torch_1m_train_bringup.py

Imports ``chip_smoke.py`` and runs ``setup()`` (the kernels' build), then
for each cell of ``[1m train]`` (1m_train_window, 1m_uniform_train_onehot:
the reference's two single-device 1M-node training configurations, the
headline model, ``remat=True``):

1. the batch and the with_grad layout (host and copy seconds, stats);
2. ``[1m train]``'s own run: 3 Adam steps through ``train_headline``
   (step ms, peak device memory, the launch counts per step), the first
   held to the plain path on the card; the peak device memory of that
   plain path is printed after it;
3. the aggregation's VJP against its plain version
   (``window_vjp_check``);
4. the same cell without remat, in turns with it in one process (remat,
   no remat, no remat, remat; 3 Adam steps each from the seed-0 weights):
   each run's step ms, peak device memory, losses, and how its first-step
   gradients compare with the first remat run's (leaves bit-equal, worst
   relative Frobenius error of the leaves that the model's symmetry does
   not zero); then one remat and one plain run under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``, the ops
   it warns about, and whether those two runs are bit-equal;
5. the host side of a new layout's first step: one step under cProfile on
   a copy of the layout whose index arrays are new tensors (the per-layout
   plans and checks made anew), its 12 costliest functions;
6. (1m_train_window) #14's range check made at every launch (a host
   copy each) in turns with its check made once per layout: step ms.

An out-of-memory error in 2 or 4 is printed as a finding, not raised: this
script measures what the card holds.  Ends with the card's nvidia-smi line.
"""

import argparse
import cProfile
import gc
import io
import os
import pstats
import statistics
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def run_steps(cs, fields, b, lay, steps=3):
    """``steps`` Adam steps of the headline model with config ``fields``
    from the seed-0 weights: (step ms, peak GiB, losses, first-step
    gradients by leaf)."""
    import torch
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step)
    import numpy as np
    arrays = batch_arrays(b, "cuda")
    target = int(np.random.default_rng(0).integers(0, cs.NODES))
    arrays["targets"] = {"node": torch.tensor([target], dtype=torch.int32,
                                              device="cuda")}
    cfg = cs.headline_cfg(compute_dtype="bfloat16", **fields)
    params = cs.fresh_params(cfg)
    step = make_train_step(cfg, 1, make_optimizer(params, 1e-3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, grads = [], [], None
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m = step(params, arrays, lay)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss_sum"] / m["count"]))
        if i == 0:
            grads = {k: p.grad.detach().clone() for k, p in _flatten(params)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return ms, peak, losses, grads


def against(cs, grads, ref):
    """(leaves bit-equal, the worst rel_frobenius over the leaves that the
    model's symmetry does not zero, and that leaf)."""
    import torch
    same = sum(bool(torch.equal(grads[k], ref[k])) for k in grads)
    worst = max((cs.relfro(grads[k], ref[k]), k) for k in grads
                if k not in cs.SYMMETRIC_LEAVES)
    return same, worst


def remat_turns(cs, name, fields, b, lay):
    """The cell with and without remat in turns: remat, no remat, no remat,
    remat; then remat and no remat with deterministic algorithms."""
    import torch
    first = None
    runs = [(r, False) for r in (True, False, False, True)]
    runs += [(True, True), (False, True)]
    det_first = None
    for remat, det in runs:
        f = dict(fields, remat=remat)
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ms, peak, losses, grads = run_steps(cs, f, b, lay)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[1m bringup] {name} remat={remat}: out of memory: "
                  f"{str(e).splitlines()[0]}", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            continue
        finally:
            torch.use_deterministic_algorithms(False)
        if first is None and remat:
            first = (losses, grads)
        tag = f"{name} remat={remat}" + (" deterministic" if det else "")
        line = (f"[1m bringup] {tag}: step ms {[f'{x:.2f}' for x in ms]} "
                f"(median {statistics.median(ms):.2f}); peak device memory "
                f"{peak:.2f} GiB; losses {[f'{x:.6f}' for x in losses]}")
        same, (worst, leaf) = against(cs, grads, first[1])
        line += (f"; against the first remat run: losses bit-equal "
                 f"{losses == first[0]}, first-step gradient leaves "
                 f"bit-equal {same} of {len(grads)}, worst rel_frobenius "
                 f"{worst:.3e} ({leaf})")
        if det:
            ops = sorted({str(w.message).split(" does not have")[0]
                          for w in caught
                          if "deterministic" in str(w.message)})
            line += f"; warned: {ops}"
            if det_first is None:
                det_first = (losses, grads)
            else:
                same, (worst, leaf) = against(cs, grads, det_first[1])
                line += (f"; against the deterministic remat run: losses "
                         f"bit-equal {losses == det_first[0]}, leaves "
                         f"bit-equal {same} of {len(grads)}, worst "
                         f"{worst:.3e} ({leaf})")
        print(line, flush=True)
        del grads
        gc.collect()
        torch.cuda.empty_cache()


def first_step_profile(cs, name, fields, b, lay):
    """One step on a copy of the layout whose arrays but the count stream
    are new tensors, so that every per-layout plan and check is made anew,
    under cProfile: the host functions of a new layout's first step."""
    import torch
    fresh = type(lay)(lay.meta, {k: v if k == "c_stream" else v.clone()
                                 for k, v in lay.arrays.items()},
                      *((lay.stats,) if hasattr(lay, "stats") else ()))
    prof = cProfile.Profile()
    prof.enable()
    ms, _, _, _ = run_steps(cs, fields, b, fresh, steps=1)
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(25)
    print(f"[1m bringup] {name} a new layout's first step: {ms[0]:.2f} ms "
          f"on the card; host functions by cumulative seconds:\n"
          + "\n".join(out.getvalue().splitlines()[:45]), flush=True)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()


def bwd_check_turns(cs, name, fields, b, lay):
    """#14's range check at every launch (a host copy each) in turns with
    the check made once per layout: 3 steps each."""
    from ggnn_tpu_torch.ops import window as W
    keep = W.cached_per_tensor

    def every_launch(t, key, make):
        if isinstance(key[0], str) and key[0].startswith("checks "
                                                         "window_bwd"):
            return make()
        return keep(t, key, make)

    for each in (True, False, False, True):
        W.cached_per_tensor = every_launch if each else keep
        try:
            ms, _, _, _ = run_steps(cs, fields, b, lay)
        finally:
            W.cached_per_tensor = keep
        print(f"[1m bringup] {name} #14's check "
              f"{'at every launch' if each else 'once per layout'}: step ms "
              f"{[f'{x:.2f}' for x in ms]} (median "
              f"{statistics.median(ms):.2f})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    # cuBLAS's deterministic workspace, for the runs under
    # torch.use_deterministic_algorithms (read when its handle is made)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("torch_1m_train_bringup: no CUDA device", file=sys.stderr)
        return 2
    clock = cs.PhaseClock()
    card, params = cs.setup()
    clock.mark("setup and build")
    for name in cs.TRAIN_1M:
        b, lay = cs.build_1m(name)
        fields, per_step = cs.cell_1m(name, lay)
        clock.mark(f"{name} batch and layout")
        try:
            cs.train_headline(b, lay, {name: (fields, per_step)},
                              tag="1m train", f32_check=False)
            print(f"[1m bringup] {name}: peak device memory with the plain "
                  f"path's first step "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
                  flush=True)
        except (torch.cuda.OutOfMemoryError, AssertionError) as e:
            print(f"[1m bringup] {name}: [1m train] failed: "
                  f"{type(e).__name__}: {str(e).splitlines()[0]}",
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        clock.mark(f"{name} [1m train]")
        try:
            torch.cuda.reset_peak_memory_stats()
            cs.window_vjp_check(name, lay, params, {}, prefix="[1m train]")
            print(f"[1m bringup] {name}: peak device memory of the VJP "
                  f"check {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                  f"GiB", flush=True)
        except (torch.cuda.OutOfMemoryError, AssertionError) as e:
            print(f"[1m bringup] {name}: the VJP check failed: "
                  f"{type(e).__name__}: {str(e).splitlines()[0]}",
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        clock.mark(f"{name} VJP check")
        remat_turns(cs, name, fields, b, lay)
        clock.mark(f"{name} remat turns")
        first_step_profile(cs, name, fields, b, lay)
        clock.mark(f"{name} first-step profile")
        if name == "1m_train_window":
            bwd_check_turns(cs, name, fields, b, lay)
            clock.mark(f"{name} #14 check turns")
        del b, lay
        gc.collect()
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
