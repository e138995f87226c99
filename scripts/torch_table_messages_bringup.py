"""The short first check of kernels #10 ``node_table_block_major`` and #16
``packed_messages`` on one NVIDIA GPU (H100), after either changes.

    python3 scripts/torch_table_messages_bringup.py

Builds the port's CUDA library (printing ptxas's registers, shared memory
and spills of every kernel), then runs chip_smoke.py's checks of the two
kernels: #10 at the seams of its persistent schedule (N = 128 and 19,200,
T2 = 1, 3, 16, D = 4..384, bf16 and f32) and at the uniform headline
(262,144 nodes, T2 = 16, D = 128, bf16: checked and timed against its plain
version and cuBLAS's einsum + bias + permute); then the whole ``[pallas
kernels]`` phase (#16 and #17 on their fuzz layouts, #16 at its seams, both
at the uniform headline's 62,516 tiles, timed).  The checks, tolerances,
bounds and timings are chip_smoke.py's own.  Prints the errors and times as
one JSON object and the card's nvidia-smi line last.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def table_headline(log, timings):
    """#10 at the uniform headline's shapes against its plain version (per
    element, twice bit-equal), timed with chip_smoke's time_pairs."""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    cs = chip_smoke
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    N, D, T2 = cs.NODES, cs.DIM, 2 * cs.EDGE_TYPES
    h = (torch.rand(N, D, device=dev, generator=gen) * 2 - 1).bfloat16()
    w = (torch.randn(T2, D, D, device=dev, generator=gen)
         * D ** -0.5).bfloat16()
    b = (torch.randn(T2, D, device=dev, generator=gen) * 0.1).bfloat16()
    tab = TB.node_table_block_major(h, w, b)
    cs.same_twice("node_table_block_major", "headline", tab,
                  TB.node_table_block_major(h, w, b))
    ref = TB.node_table_block_major_reference(h, w, b)
    cs.check("node_table_block_major[headline]", tab, ref, "bound",
             torch.bfloat16, log,
             bound=cs.table_bound(h, w, b, ref, torch.bfloat16))
    del ref
    lib = lambda: (torch.einsum("nd,tdf->ntf", h, w) + b).reshape(
        N // 128, 128, T2, D).transpose(1, 2).reshape(-1, D)
    cs.time_pairs({"node_table_block_major": (
        lambda: TB.node_table_block_major(h, w, b),
        lambda: TB.node_table_block_major_reference(h, w, b), lib,
        cs.roofline(cs.nbytes(h, w, b, tab),
                    [(2 * N * D * T2 * D, cs.BF16_FLOPS)]))}, timings)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_table_messages_bringup: no CUDA device",
              file=sys.stderr)
        return 2
    card, _ = chip_smoke.setup()
    log, timings = {}, {}
    chip_smoke.table_seam_fuzz(log)
    table_headline(log, timings)
    torch.cuda.empty_cache()
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    b = synthetic_batch(chip_smoke.NODES, chip_smoke.EDGES,
                        chip_smoke.EDGE_TYPES,
                        annotation_dim=chip_smoke.ANN, seed=0, node_mult=128)
    chip_smoke.pallas_kernels_phase(b, log, timings)
    print(json.dumps({"max_abs_err": {k: max(v) for k, v in log.items()},
                      "timings": timings}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
