"""Time the full-causal attention kernels of one checkout on the card.

    python3 tools/attention_timing.py [--tree DIR] [--label NAME]

Imports protoquant_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels there, and prints one JSON line: the card, and
the device time per call in ms (``chip_smoke.bench``: a CUDA graph of 20
calls over input copies larger than the L2) of the cases every version of
the kernels takes: with no attention variant, the int8 decode and prefill at
Llama-2-7B's shapes, the int8 decode at Gemma-2-9B's (Dh 256, S 8192,
lengths 8000), and the K8V4, K4V8 and Int4 decodes at Llama-2-7B's shapes;
then the int8 decode of a Gemma-2 sliding layer (window, scale, softcap:
the variant instance). To compare two checkouts, run it on each in turns
(A, B, B, A) within one call on one card.
"""

import argparse
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attention_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # its helpers, from this checkout

    sys.path.insert(0, os.path.abspath(args.tree))
    from protoquant_tpu_torch import ops

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    decode = [63, 700, 1023, 255]
    lengths = torch.tensor(decode, dtype=torch.int32, device=dev)
    times = {}

    def time_int8(label, B, T, H, KV, S, Dh, lens, **kw):
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = [cs._cache(gen, dev, B, KV, S, Dh)
                  for _ in range(cs.copies_for(B * KV * S * (2 * Dh + 8)))]
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        times[label] = cs.bench([lambda c=c: ops.int8_kv_attention(q, *c, ln, **kw)
                                 for c in caches])

    time_int8("int8 decode 7B", 4, 1, 32, 32, 1024, 128, decode)
    time_int8("int8 prefill 7B T=256 from 256", 1, 256, 32, 32, 1024, 128, [256])
    time_int8("int8 decode gemma2 full-causal lengths 8000", 4, 1, 16, 8, 8192, 256, [8000] * 4)
    time_int8("int8 decode gemma2 sliding lengths 8000", 4, 1, 16, 8, 8192, 256, [8000] * 4,
              window=4096, scale=0.0625, softcap=50.0)
    q = torch.randn(4, 1, 32, 128, generator=gen, device=dev).to(torch.bfloat16)
    caches = [cs._mixed_cache(gen, dev, 4, 32, 1024, 128) for _ in range(cs.copies_for(
        4 * 32 * 1024 * (3 * 128 // 2 + 8)))]
    times["k8v4 decode 7B"] = cs.bench(
        [lambda c=c: ops.mixed_kv_attention(q, *c, lengths) for c in caches])
    for tier, (_, name) in cs.KIVI_KERNELS.items():
        caches = [cs._kivi_cache(gen, dev, tier, 4, 32, 1024, 128)
                  for _ in range(cs.copies_for(4 * 32 * 1024 * 128))]
        if tier == "k4v8":
            caches = [cs._mirror_v(c, lengths + 1) for c in caches]
        fn = getattr(ops, name)
        times[f"{tier} decode 7B"] = cs.bench(
            [lambda c=c, fn=fn: fn(q, *c, lengths, lengths + 1, group=cs.KIVI_G)
             for c in caches])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"label": args.label, "tree": args.tree, "card": smi.stdout.strip(),
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
