"""Time the int8 GEMM (qmatmul) of one checkout on the card.

    python3 tools/gemm_timing.py [--tree DIR] [--label NAME] [--sweep]

Imports protoquant_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels there, and prints one JSON line: the card, and
the device time per call in ms (``chip_smoke.bench``: a CUDA graph of 20
calls over weight copies larger than the L2) of ``ops.qmatmul`` at every
shape ``chip_smoke.py``'s ``check_qmatmul`` takes (Llama-2-7B's projections
at M = 1, 4, 8, 16, 32, 64, 128 and 256, Gemma-2-9B's at M = 4 and 512,
Mistral-7B's at M = 4, GPT-OSS-20B's at M = 4, its experts at M = 1 and
80), bf16 out, each beside ``torch._int_mm`` (the int32 product alone, M
padded to 32) and the bound. To compare two checkouts, run it on each in
turns (A, B, B, A) within one call on one card:

    python3 tools/gemm_timing.py --tree scratch_tree/parent --label parent

With ``--sweep`` (a checkout that has the decode kernel) it also times,
at M = 1, 2, 4, 8, 16, 32, 48, 64, 80, 96 and 128 and N x K = 4096 x
4096, 11008 x 4096, 32000 x 4096 and the experts' 5760 x 2880 and 2880 x
2880, the tile kernel at its plan and, up to the decode kernel's 64 rows,
the decode kernel at the plan's splits and at every other split count: the
data the routing threshold and the plans are set from.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--label", default="")
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gemm_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # its helpers and shapes, from this checkout

    sys.path.insert(0, os.path.abspath(args.tree))
    from protoquant_tpu_torch import ops

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    times, library, bounds, sweep = {}, {}, {}, {}

    def operands(m, k, n):
        xq, sx = ops.rowquant_ref(torch.randn(m, k, generator=gen, device=dev))
        ws = [torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
              for _ in range(cs.copies_for(n * k))]
        sw = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        return xq, sx, ws, sw

    for m, k, n in cs.qmatmul_shapes():
        label = f"M={m} K={k} N={n}"
        xq, sx, ws, sw = operands(m, k, n)
        times[label] = cs.bench([lambda w=w: ops.qmatmul(xq, w, sx, sw, out_dtype=bf)
                                 for w in ws])
        xpad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
        xpad[:m] = xq
        library[label] = cs.bench([lambda w=w: torch._int_mm(xpad, w.t()) for w in ws])
        bounds[label] = cs.bound_ms(m * k + n * k + 2 * m * n + 4 * (m + n), 2 * m * n * k,
                                    cs.INT8_OPS_PER_S)[0]
        del ws

    if args.sweep:
        Q = importlib.import_module("protoquant_tpu_torch.ops.qmatmul")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for n, k in ((4096, 4096), (11008, 4096), (32000, 4096), (5760, 2880), (2880, 2880)):
            for m in (1, 2, 4, 8, 16, 32, 48, 64, 80, 96, 128):
                xq, sx, ws, sw = operands(m, k, n)
                row = {"plan_splits": Q.qmatmul_decode_plan(m, n, k, sms),
                       "tile": cs.bench([lambda w=w: Q.qmatmul_launch(xq, w, sx, sw, None, bf)
                                         for w in ws])}
                if hasattr(Q, "qmatmul_tile_plan"):
                    row["tile_plan"] = Q.qmatmul_tile_plan(m, n, k, sms)
                steps = -(-k // Q.DECODE_STEP)
                for splits in (1, 2, 4, 8):
                    if splits <= steps and m <= 64:  # the decode kernel takes up to 64 rows
                        row[f"decode_{splits}"] = cs.bench(
                            [lambda w=w: Q.qmatmul_launch(xq, w, sx, sw, None, bf, splits)
                             for w in ws])
                sweep[f"M={m} K={k} N={n}"] = row
                del ws
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(), "ms": times,
            "int_mm_ms": library, "bound_ms": bounds}
    if sweep:
        line["sweep_ms"] = sweep
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
