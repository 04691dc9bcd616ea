"""Time the attention kernels of one checkout on the card.

    python3 tools/attention_timing.py [--tree DIR] [--label NAME] [--profile] [--only WORD]

Imports protoquant_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels there, and prints one JSON line: the card, and
the device time per call in ms (``chip_smoke.bench``: a CUDA graph of 20
calls over input copies larger than the L2) of the cases every version of
the kernels takes. The int8 attention: decode and prefill at Llama-2-7B's
shapes (lengths 63/700/1023/255; T = 256 from 256 and from 924), decode at Gemma-2-9B's
(Dh 256, S 8192) at lengths 8000, full causal and sliding (window, scale,
softcap), and, as ``chip_smoke.py`` phase 3, the decode of Gemma-2's
sliding and global layers (lengths 63/4500/8191/1000), of Mistral-7B's
ring (4608 columns, and 4640 with 4 StreamingLLM sinks; lengths
63/4607/9000/20000), of BLOOM-560m with ALiBi (S 2048, lengths
63/700/2047/1000) and of GPT-OSS-20B's global and sliding layers (learned
sinks; S 8192, lengths 63/4500/8191/1000), and the 7B decode at B 9 and
32; the prefill chunks of phase 3: Gemma-2's sliding and global layers
(T = 512 from 4500), Mistral-7B's ring (B = 2, T = 512 from 63 and 9000,
without and with 4 sinks), GPT-OSS-20B's sliding and global layers with
learned sinks (T = 512 from 4500) and BLOOM-560m with ALiBi (T = 256 from
700). The K8V4 attention: the 7B decode, prefill (T = 256 from 300) and
decode at B 9 and 32. K4V8 and Int4: the decode and the prefill (T = 256
from 300) at Llama-2-7B's shapes, the decode of a Gemma-2 global layer
(scale, softcap) and of a GPT-OSS-20B global layer (learned sinks), both at
S 8192 and lengths 63/4500/8191/1000, the 7B decode at B 9, 16 and 32
and the GPT-OSS one at B 32 and 64 (the lengths repeated), and the prefill
chunks of phase 3: Gemma-2's sliding and global layers and GPT-OSS-20B's
with learned sinks (T = 512 from 4500), BLOOM-560m with ALiBi (T = 256
from 700). The paged
int8 attention (128-key pages, a shuffled table): the 7B decode at G 1
and 4 and at B 9 and 32, and BLOOM-560m's with ALiBi (S 2048). To compare two
checkouts, run it on each in turns (A, B, B, A) within one call on one
card:

    python3 tools/attention_timing.py --tree scratch_tree/parent --label parent

``--only WORD`` times only the cases whose label holds WORD (``--only
prefill``: the prefill chunks). With ``--profile`` it also prints, for
each decode, the device time of every CUDA kernel one call launches
(``torch.profiler``, ms a launch, the mean of 20 calls on one cache copy,
so L2-warm where the cache fits).
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
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--only", default="")
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
    times, profiles = {}, {}

    def profile_kernels(call, n=20):
        from torch.profiler import ProfilerActivity, profile

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            total = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if e.count and total:
                out[e.key[:80]] = total / e.count / 1000.0
        return out

    def time_int8(label, B, T, H, KV, S, Dh, lens, **kw):
        if args.only not in label:
            return
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = [cs._cache(gen, dev, B, KV, S, Dh)
                  for _ in range(cs.copies_for(B * KV * S * (2 * Dh + 8)))]
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        times[label] = cs.bench([lambda c=c: ops.int8_kv_attention(q, *c, ln, **kw)
                                 for c in caches])
        if args.profile and T == 1:
            profiles[label] = profile_kernels(
                lambda: ops.int8_kv_attention(q, *caches[0], ln, **kw))

    time_int8("int8 decode 7B", 4, 1, 32, 32, 1024, 128, decode)
    time_int8("int8 prefill 7B T=256 from 256", 1, 256, 32, 32, 1024, 128, [256])
    time_int8("int8 decode gemma2 full-causal lengths 8000", 4, 1, 16, 8, 8192, 256, [8000] * 4)
    time_int8("int8 decode gemma2 sliding lengths 8000", 4, 1, 16, 8, 8192, 256, [8000] * 4,
              window=4096, scale=0.0625, softcap=50.0)

    def time_k8v4(label, B, T, lens, **kw):
        if args.only not in label:
            return
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn(B, T, 32, 128, generator=gen, device=dev).to(torch.bfloat16)
        caches = [cs._mixed_cache(gen, dev, B, 32, 1024, 128) for _ in range(cs.copies_for(
            B * 32 * 1024 * (3 * 128 // 2 + 8)))]
        times[label] = cs.bench(
            [lambda c=c: ops.mixed_kv_attention(q, *c, ln, **kw) for c in caches])
        if args.profile and T == 1:
            profiles[label] = profile_kernels(
                lambda: ops.mixed_kv_attention(q, *caches[0], ln, **kw))

    time_k8v4("k8v4 decode 7B", 4, 1, decode)
    time_k8v4("k8v4 prefill 7B T=256 from 300", 1, 256, [300])
    ragged = [63, 4500, 8191, 1000]
    g2 = (4, 1, cs.G2_HEADS, cs.G2_KV, cs.G2_SEQ, cs.G2_HEAD_DIM, ragged)
    time_int8("int8 decode gemma2 sliding", *g2, window=cs.G2_WINDOW, scale=cs.G2_SCALE,
              softcap=cs.G2_SOFTCAP)
    time_int8("int8 decode gemma2 global", *g2, scale=cs.G2_SCALE, softcap=cs.G2_SOFTCAP)
    from protoquant_tpu_torch.models import ring_positions
    from protoquant_tpu_torch.models.llama import alibi_slopes

    ring_ln = torch.tensor(cs.RING_LENGTHS, dtype=torch.int32, device=dev)
    for sinks in (0, 4):
        C = cs.ring_capacity(cs.M7_WINDOW, cs.M7_CHUNK, sinks)
        time_int8(f"int8 decode mistral ring sinks={sinks}", 4, 1, 32, cs.M7_KV, C, 128,
                  cs.RING_LENGTHS, window=cs.M7_WINDOW, sinks=sinks,
                  k_positions=ring_positions(ring_ln + 1, C, sinks))
    time_int8("int8 decode bloom alibi", 4, 1, cs.BL_HEADS, cs.BL_HEADS, cs.BL_SEQ,
              cs.BL_HEAD_DIM, cs.BL_LENGTHS, alibi_slopes=alibi_slopes(cs.BL_HEADS).to(dev))
    # the prefill kernel: chip_smoke.py phase 3's prefill chunks
    time_int8("int8 prefill 7B T=256 from 924", 1, 256, 32, 32, 1024, 128, [924])
    g2_prefill = (1, 512, cs.G2_HEADS, cs.G2_KV, cs.G2_SEQ, cs.G2_HEAD_DIM, [4500])
    time_int8("int8 prefill gemma2 sliding T=512 from 4500", *g2_prefill, window=cs.G2_WINDOW,
              scale=cs.G2_SCALE, softcap=cs.G2_SOFTCAP)
    time_int8("int8 prefill gemma2 global T=512 from 4500", *g2_prefill, scale=cs.G2_SCALE,
              softcap=cs.G2_SOFTCAP)
    prefill_ln = torch.tensor([63, 9000], dtype=torch.int32, device=dev)
    for sinks in (0, 4):
        C = cs.ring_capacity(cs.M7_WINDOW, cs.M7_CHUNK, sinks)
        time_int8(f"int8 prefill mistral ring T=512 B=2 sinks={sinks}", 2, cs.M7_CHUNK, 32,
                  cs.M7_KV, C, 128, [63, 9000], window=cs.M7_WINDOW, sinks=sinks,
                  k_positions=ring_positions(prefill_ln + cs.M7_CHUNK, C, sinks))
    for label, window in (("sliding", cs.GO_WINDOW), ("global", 0)):
        time_int8(f"int8 prefill gpt_oss {label} T=512 from 4500", 1, 512, cs.GO_HEADS,
                  cs.GO_KV, cs.GO_SEQ, cs.GO_HEAD_DIM, [4500], window=window,
                  sink_logits=torch.randn(cs.GO_HEADS, generator=gen, device=dev))
    time_int8("int8 prefill bloom alibi T=256 from 700", 1, 256, cs.BL_HEADS, cs.BL_HEADS,
              cs.BL_SEQ, cs.BL_HEAD_DIM, [700], alibi_slopes=alibi_slopes(cs.BL_HEADS).to(dev))
    time_int8("int8 decode gpt_oss global", 4, 1, cs.GO_HEADS, cs.GO_KV, cs.GO_SEQ,
              cs.GO_HEAD_DIM, ragged,
              sink_logits=torch.randn(cs.GO_HEADS, generator=gen, device=dev))
    time_int8("int8 decode gpt_oss sliding", 4, 1, cs.GO_HEADS, cs.GO_KV, cs.GO_SEQ,
              cs.GO_HEAD_DIM, ragged, window=cs.GO_WINDOW,
              sink_logits=torch.randn(cs.GO_HEADS, generator=gen, device=dev))
    for B in (9, 32):  # B KV at and past twice the SM count
        time_int8(f"int8 decode 7B B={B}", B, 1, 32, 32, 1024, 128, (decode * B)[:B])
        time_k8v4(f"k8v4 decode 7B B={B}", B, 1, (decode * B)[:B])

    def time_paged(label, B, H, KV, Dh, lens, pages=1024 // cs.PAGE, **kw):
        if args.only not in label:
            return
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        P = B * pages + 1
        pt = cs._shuffled_table(gen, B, pages, P, dev)
        pools = [cs._pools(gen, dev, P, KV, cs.PAGE, Dh)
                 for _ in range(cs.copies_for(P * KV * cs.PAGE * (2 * Dh + 8)))]
        q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        times[label] = cs.bench([lambda c=c: ops.paged_int8_attention(q, *c, pt, ln, **kw)
                                 for c in pools])
        if args.profile:
            profiles[label] = profile_kernels(
                lambda: ops.paged_int8_attention(q, *pools[0], pt, ln, **kw))

    time_paged("paged decode 7B G=1", 4, 32, 32, 128, decode)
    time_paged("paged decode 7B G=4", 4, 32, 8, 128, decode)
    time_paged("paged decode bloom alibi", 4, cs.BL_HEADS, cs.BL_HEADS, cs.BL_HEAD_DIM,
               cs.BL_LENGTHS, pages=cs.BL_SEQ // cs.PAGE,
               alibi_slopes=alibi_slopes(cs.BL_HEADS).to(dev))
    for B in (9, 32):
        time_paged(f"paged decode 7B B={B}", B, 32, 32, 128, (decode * B)[:B])

    def time_kivi(label, tier, B, T, H, KV, S, Dh, lens, **kw):
        if args.only not in label:
            return
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        nl = ln + T
        per_copy = B * KV * S * (2 * Dh if tier == "k4v8" else Dh) // 2
        caches = [cs._kivi_cache(gen, dev, tier, B, KV, S, Dh)
                  for _ in range(cs.copies_for(per_copy))]
        if tier == "k4v8":
            caches = [cs._mirror_v(c, nl) for c in caches]
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        fn = getattr(ops, cs.KIVI_KERNELS[tier][1])
        times[label] = cs.bench([lambda c=c: fn(q, *c, ln, nl, group=cs.KIVI_G, **kw)
                                 for c in caches])
        if args.profile and T == 1:
            profiles[label] = profile_kernels(
                lambda: fn(q, *caches[0], ln, nl, group=cs.KIVI_G, **kw))

    for tier in cs.KIVI_KERNELS:
        time_kivi(f"{tier} decode 7B", tier, 4, 1, 32, 32, 1024, 128, decode)
        time_kivi(f"{tier} prefill 7B T=256 from 300", tier, 1, 256, 32, 32, 1024, 128, [300])
        time_kivi(f"{tier} decode gemma2 global", tier, 4, 1, cs.G2_HEADS, cs.G2_KV,
                  cs.G2_SEQ, cs.G2_HEAD_DIM, ragged, scale=cs.G2_SCALE, softcap=cs.G2_SOFTCAP)
        time_kivi(f"{tier} decode gpt_oss global", tier, 4, 1, cs.GO_HEADS, cs.GO_KV,
                  cs.GO_SEQ, cs.GO_HEAD_DIM, ragged,
                  sink_logits=torch.randn(cs.GO_HEADS, generator=gen, device=dev))
        for B in (9, 16, 32):  # B KV at and past twice the SM count
            time_kivi(f"{tier} decode 7B B={B}", tier, B, 1, 32, 32, 1024, 128,
                      (decode * B)[:B])
        for B in (32, 64):
            time_kivi(f"{tier} decode gpt_oss global B={B}", tier, B, 1, cs.GO_HEADS, cs.GO_KV,
                      cs.GO_SEQ, cs.GO_HEAD_DIM, (ragged * B)[:B],
                      sink_logits=torch.randn(cs.GO_HEADS, generator=gen, device=dev))
        g2_kivi = (tier, *g2_prefill)
        time_kivi(f"{tier} prefill gemma2 sliding T=512 from 4500", *g2_kivi,
                  window=cs.G2_WINDOW, scale=cs.G2_SCALE, softcap=cs.G2_SOFTCAP)
        time_kivi(f"{tier} prefill gemma2 global T=512 from 4500", *g2_kivi, scale=cs.G2_SCALE,
                  softcap=cs.G2_SOFTCAP)
        for label, window in (("sliding", cs.GO_WINDOW), ("global", 0)):
            time_kivi(f"{tier} prefill gpt_oss {label} T=512 from 4500", tier, 1, 512,
                      cs.GO_HEADS, cs.GO_KV, cs.GO_SEQ, cs.GO_HEAD_DIM, [4500], window=window,
                      sink_logits=torch.randn(cs.GO_HEADS, generator=gen, device=dev))
        time_kivi(f"{tier} prefill bloom alibi T=256 from 700", tier, 1, 256, cs.BL_HEADS,
                  cs.BL_HEADS, cs.BL_SEQ, cs.BL_HEAD_DIM, [700],
                  alibi_slopes=alibi_slopes(cs.BL_HEADS).to(dev))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(), "ms": times}
    if args.profile:
        line["profile_ms"] = profiles
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
