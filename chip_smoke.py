"""Drive protoquant_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result line):
  1. card     name and power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc build of protoquant_tpu_torch/csrc/*.cu (timed)
  3. kernels  each kernel against its plain PyTorch version at the
              Llama-2-7B shapes of the main paths, timed with CUDA events
              beside its plain version, a library call and its bound; the
              GEMM, rowquant and decode write also at Gemma-2-9B's shapes,
              and the int8, K4V8 and Int4 attentions at Gemma-2-9B's
              shapes with its variants (sliding window 4096, score scale
              256^-0.5, softcap 50: ragged and equal-length decode over
              S = 8192, a prefill chunk of 512 crossing the window), each
              also against its plain version without the window and
              without the softcap (planted faults, which must miss); at
              equal lengths the windowed int8 decode must take at most
              0.65 of the full-causal time (its tiles below the window are
              skipped); the K8V4 attention also with a score scale of 0.1;
              the int8 and K8V4 decodes at Llama-2-7B's shapes (the split
              design) bitwise equal across two calls and against the plain
              split spelling with each row's last live split dropped (a
              planted fault, which must miss); every K4V8 and Int4 prefill
              chunk (Llama-2-7B's 256 from 300, Gemma-2's, GPT-OSS's and
              BLOOM's) through the prefill kernel, also against its
              bf16-lane spelling (kivi_attention_tiles_ref), the 7B one
              also against the spelling with each tail column read one row
              off (a planted fault, which must miss);
              the int8 attention over a ring at Mistral-7B's shapes (window
              4096, 4608 columns, and 4640 with 4 StreamingLLM sinks; decode
              at lengths 63 / 4607 / 9000 / 20000, a prefill chunk of 512),
              against its plain version reading the columns as positions
              and dropping the sinks (planted faults, which must miss); the
              int8, paged, K4V8 and Int4 attentions with ALiBi at
              BLOOM-560m's shapes (16 heads of 64, S = 2048; decode, and a
              prefill chunk of 256 but paged), each against its plain
              version without the slopes (a planted fault); the int8, K4V8
              and Int4 attentions with learned sinks at GPT-OSS-20B's
              shapes (64 heads over 8 KV heads of 64, S = 8192; decode of a
              sliding layer, window 128, and of a global one, a prefill
              chunk of 512 from 4500), each against its plain version
              dropping the sinks and counting the sink as a key of value 1
              (planted faults, which must miss); the int8 global decode
              with sinks timed against the full-causal instance (a reading);
              the GEMM, rowquant and decode write also at GPT-OSS-20B's
              shapes (its experts' products at M = 1); rowquant and
              swiglu_quant also at M = 1 and 1024 (K 11008), at the tp = 2
              shard (5504) and an odd K, each on its row plan's route,
              against the plain split spelling with the slice holding each
              row's maximum dropped (a planted fault, which must differ);
              the GEMM also at
              M = 1, 8, 16, 32 and 64 (the decode kernel's threshold), each
              through the kernel its M routes to, the decode cases against
              the plain split-K spelling with its last K slice dropped (a
              planted fault, which must differ); the weight-only int8 GEMM
              at the 7B shapes and M = 1, 4, 16, 32, 48, 256 and 512, each
              through the kernel its M routes to (the split-K decode kernel
              up to WO_DECODE_MAX_M, the TMA + wgmma tile kernel above; the
              plan printed), bitwise equal across two calls, against the
              plain product with the plan's last K slice dropped (a planted
              fault, which must miss); the paged attention at
              Llama-2-7B's shapes, G = 1 and 4 at B = 4 and G = 1 at B = 9
              and 32 through the split kernel (its plan printed), bitwise
              equal across two calls, against the plain split spelling with
              each row's last live split dropped (a planted fault, which
              must miss), and G = 8 at Dh 256 through the page walk; the
              KIVI updates on both routes, all eight tensors bit for bit:
              decode at the 7B and GPT-OSS shapes (rows flushing, idle, at
              capacity) and an insert-only step at both, prefill chunks of 256
              at 7B (B = 4, from 0 and from 300) and at GPT-OSS's shape
  4. slice    LlamaModel(llama2_7b, "dynamic") at full width and depth,
              random int8 weights from --seed, serving 6 greedy requests
              through Engine(max_batch_size=4, max_seq_len=1024,
              prefill_chunk=256); every kernel must have launched, and
              each decode step must launch exactly the kernels the model
              implies
  5. agree    a 2-layer full-width model on the card, run through the
              kernels and through the plain versions (also on the card),
              same weights and prompt: prefill and decode logits must agree;
              then through the plain versions with each planted fault, which
              must fail the same limits
  6. paged    LlamaModel(llama2_7b, "weight_only") at full width and depth
              served by Engine(kv_layout="paged") with page_size=128 and
              prefix_cache=True: 8 greedy requests sharing a 512-token
              system prompt; every request after the first must adopt its 4
              pages, each decode step must launch exactly 225 / 32 / 32 of
              the weight-only, paged-scatter and paged-attention kernels and
              none of the dense ones (the 225 GEMMs on the decode route),
              each prefill chunk padded past the GEMM's decode threshold
              must take its 225 GEMMs on the tile route and every other
              forward on the decode route, and every page must be free or
              cached after the drain
  7. paged agreement  phase 5 for a 2-layer full-width weight_only model
              over a paged pool of 16-token pages, with a planted fault for
              each new kernel (the GEMM's two routes each: the last K slice
              of its plan dropped); the kernel run's prefill (M = 96) must
              take the GEMM's tile route and its decode steps its decode
              route; its kernels act on the 8 decode positions
              (the two attention faults move only those), so its runs must
              also pass the limit on the decode positions alone
  8. int4     phase 4 for LlamaModel(llama2_7b, "dynamic_int4") (W4A8, the
              two_level formulation, group 128): 129 rowquant, 225 w4a8,
              32 / 32 dense scatter and attention per decode step, no
              qmatmul; then phase 6 for "weight_only_int4" (the split
              formulation): 225 wo4, 32 / 32 paged scatter and attention,
              no rowquant, 3,584 prefix-hit tokens, no leaked page; then
              phase 4 again for "dynamic_int4" with W4A8_FORMULATION=group
              (225 w4a8_group per decode step, every one on its decode
              route; every prefill chunk's on its tile route)
  9. int4 agreement  phases 5 and 7 for 2-layer full-width dynamic_int4
              (dense; also once with the group formulation) and
              weight_only_int4 (paged) models, each with a planted fault for
              its int4 kernel
 10. fused    phase 4 again with FUSED_QUANT=on (same seed, weights,
              prompts and EngineConfig): both norms of every layer through
              rms_norm_quant, the gate through swiglu_quant; each decode
              step must launch exactly 33 rowquant (o_proj, lm_head), 64
              rms_norm_quant, 32 swiglu_quant, 225 qmatmul and 32 / 32
              scatter and attention. Prints its step median and kernel sum
              beside phase 4's, and the share of its tokens equal to phase
              4's (a reading: codes may move by one step)
 11. fused agreement  phase 5 with FUSED_QUANT=on, norm weights drawn from
              [0.5, 1.5], and a planted fault for each producer
 12. k4v8     phase 4 again over Engine(kv_dtype="k4v8") (same seed, weights,
              prompts and EngineConfig; KIVI group 64): per decode step 129
              rowquant, 225 qmatmul, 32 k4v8_decode_update (all on its
              route "decode") and 32 k4v8_attention, none of the int8 cache
              kernels; every step with a prefill chunk 32 k4v8_decode_update
              on its route "prefill"; at least one decode write must cross a
              chunk boundary (a flush); prints and asserts the cache's bytes
              (948 MiB against int8's 1056)
 13. int4 KV  phase 12 with kv_dtype="int4" (kivi4_decode_update,
              int4_kv_attention; 692 MiB)
 14. KIVI agreement  phase 5 over each KIVI cache, f32 and bf16, with a
              382-token prompt in two prefill chunks, the second starting
              63 positions into a chunk and longer than 2G, and a decode
              write that flushes a chunk the later steps read packed; a
              planted fault for each writer and attention, and one of the
              update's prefill route (the tails written before its first
              chunk reads them); judged also on the decode positions
 15. k8v4     phase 4 again over Engine(kv_dtype="k8v4") (int8 K, packed
              int4 V): per decode step 129 rowquant, 225 qmatmul, 32
              kv_mixed_scatter_decode and 32 mixed_kv_attention, none of
              the int8 or KIVI cache kernels; asserts the cache's bytes
              (800 MiB against int8's 1056)
 16. K8V4 agreement  phase 5 over the K8V4 cache, f32 and bf16, with a
              61-token prompt so that the decode writes land in both
              nibble parities; a planted fault for the writer and the
              attention; judged also on the decode positions
 17. gemma2   LlamaModel(gemma2_9b, "dynamic") at full width and all 42
              layers, random int8 weights from --seed, serving 6 greedy
              requests (prompts of 64 to 6000 tokens, three past the window)
              through Engine(max_batch_size=4, max_seq_len=8192,
              prefill_chunk=512) over the int8 cache: each decode step must
              launch exactly 169 rowquant, 295 qmatmul, 42 / 42 scatter and
              attention; asserts the cache's bytes (5460.0 MiB); prints the
              step median, the kernel sum at its shapes and peak memory
 18. gemma2 agreement  phase 5 for a 2-layer Gemma-2-9B at full width
              (layer 0 sliding, layer 1 global) over the int8, K4V8 and
              Int4 caches, f32 and bf16, with a prompt of 6206 tokens
              prefilled in chunks of 1024 (logits kept at every 16th prompt
              position) and judged also on the decode positions; planted
              faults: its attention ignoring the window, and dropping the
              score scale; ignoring the softcap is printed as a reading
              (random weights never reach the cap: phase 3 shows that fault)
 19. mistral ring  LlamaModel(mistral_7b, "dynamic") at full width and all
              32 layers served through Engine(max_batch_size=4,
              max_seq_len=32768, prefill_chunk=512, kv_layout="ring"): 6
              greedy requests, prompts of 64 to 9000 tokens (three past the
              ring's 4608 columns, so it wraps); asserts the cache's bytes
              (1188.0 MiB, where the dense int8 layout takes 8448.0) and
              each decode step's launches: 129 rowquant, 225 qmatmul, no
              decode scatter (the ring writes in plain PyTorch), 32
              int8_kv_attention; prints the step median, the kernel sum
              and peak memory
 20. gemma2 hybrid ring  (run right after phase 17) phase 17's model and
              requests over kv_layout="ring": rings on its 21 sliding layers, dense int8
              caches on its 21 global ones (4265.625 MiB against phase 17's
              5460.0); per decode step 169 rowquant, 295 qmatmul, 21 scatter,
              42 attention; prints the step median and the share of tokens
              equal to phase 17's (a reading)
 21. ring agreement  phase 5 for a 2-layer full-width Mistral-7B (both
              layers on rings of 5120 columns, a 6000-token prompt that
              wraps them) and Gemma-2 hybrid (a 6206-token prompt), f32 and
              bf16, prefilled in chunks of 1024: the ring's kernels against
              the same kernels over the dense windowed int8 cache and
              against the plain versions; planted faults: the columns read
              as positions, the window dropped on the ring
 22. bloom    LlamaModel(bloom_560m, "dynamic") at full width and all 24
              layers, 4 slots, prefill_chunk=256, 32 new tokens, over the
              dense int8 cache (max_seq_len 2048, 408.0 MiB), the paged pool
              (128-token pages, prefix caching, 8 requests sharing a
              512-token system prompt), the K4V8 and Int4 caches (G = 64),
              and the ring with stream_window=512, attention_sinks=4,
              max_seq_len=8192 (800 columns, 159.375 MiB; prompts up to
              6000 tokens, past the 2048 trained positions); each decode
              step must launch 97 rowquant, 145 qmatmul and 24 / 24 of the
              layout's writer and attention (the ring: no writer)
 23. bloom agreement  phase 5 for a 2-layer full-width BLOOM over the int8,
              paged, K4V8, Int4 and ring-with-sinks caches, f32 and bf16;
              planted faults: each attention dropping ALiBi, the ring
              dropping its sinks
 24. gpt_oss  LlamaModel(gpt_oss_20b, "dynamic") at full width and all 24
              layers (32 experts, top 4), random int8 weights and N(0, 1)
              learned sinks from --seed, serving 6 greedy requests (prompts
              of 64 to 6000 tokens, five past the window of 128) through
              Engine(max_batch_size=4, max_seq_len=8192, prefill_chunk=512)
              over the int8 cache (816.0 MiB asserted): each decode step
              must launch exactly 97 rowquant, 1633 qmatmul (4 projections
              and 2 per expert on each layer, lm_head), 24 / 24 scatter and
              attention (with the sinks); prints the step median, the
              kernel sum at its shapes, peak memory and the share of expert
              assignments the capacity dropped
 25. gpt_oss KIVI  phase 24's model over kv_dtype "k4v8" and "int4" (G =
              64, max_seq_len 2048, prefill_chunk 256): 24 of the tier's
              writer and attention per decode step, none of the int8
              cache's; cache bytes asserted
 26. gpt_oss agreement  phase 5 for a 2-layer GPT-OSS-20B at full width
              (layer 0 sliding, layer 1 global), "dynamic" and
              "weight_only_int4" (the wo4 split kernel per expert), over the
              int8, K4V8, Int4 and bf16 caches, f32 and bf16, with a
              1200-token prompt prefilled in chunks (512; 128 for int4) and
              judged also on the decode positions; planted faults: each
              attention dropping its learned sinks, the experts' gate/up
              read de-interleaved. The plain and faulted runs take the
              kernel run's expert choices; one more plain run routes on
              its own, a reading whose first route flips must sit on top-k
              margins within twice the router noise of that forward
 27. ring     the ring reduce-scatter matmul (B19, all ranks one launch on
              the card) at Llama-2-7B's row-parallel shapes (o_proj K = N
              = 4096, down_proj K = 11008, N = 4096), tp = 2 and 4, M = 4
              and 256: equal to its plain version bit for bit with unit and
              with real scales; planted faults in the plain version (a hop
              dropped, the chunk one off, at tp = 4 the ring's order
              reversed) must differ; 1000 back-to-back calls of M from 1 to
              256 (tp 2 and 4 in turn) all equal; each case on the route
              of its M (decode up to 32 rows, prefill above), printed with
              its plan (K splits a cluster, clusters, blocks); timed with
              CUDA events beside its bound (the weight's bytes, every rank
              reading the one card), its plain version and torch._int_mm of
              the unsharded product (a reading)
 28. tp       phase 4's model split over tp = 2 ranks sharing the card
              (threads of this process, make_mesh(devices=["cuda:0"] * 2)),
              collective=True under RING_BACKEND="dma", serving phase 4's
              6 requests through Engine(..., mesh=mesh); each decode step
              must launch 2 x 32 ring kernels (decode route) and per rank
              the rowquant, qmatmul, scatter and attention the model
              implies; the ring's launches by route over every forward's
              token rows asserted; the share of tokens equal to phase 4's
              is a reading
 29. tp agreement  phase 5 for a 2-layer full-width TP model, tp = 2 and 4,
              f32 and bf16, kernels against plain versions on the card;
              planted faults: the ring dropping a hop, adding the chunk
              one off
Timings with ranks sharing one card measure the kernel and its protocol,
not a link between cards.
Each phase prints its seconds, and the run its total.
The line before the last is {"kernels": [...]}, one entry per kernel body
and route (36): "launches" is its count summed over the twenty-one engine runs
(phases 4, 6, 8.1, 8.2, 8.3, 10, 12, 13, 15, 17, 19, 20, the five of 22,
the three of 24-25 and 28), each driven with the counts at 0 and read just
after ("launches_by_path"). A wrapper counts calls: a decode call of the
int8, K8V4, K4V8, Int4 or paged attention is two CUDA launches (the split
kernel and the merge), and its entry names every file it runs under
"sources". Eleven wrappers route between two kernels or launch plans by
shape before launch and count each apart (ops.route_counts): rowquant and
swiglu_quant ("rowquant_cluster", a row over a thread block cluster where
rows are few; "rowquant", a block a row: one kernel, two plans; the same
for swiglu_quant), qmatmul ("qmatmul_decode", the
split-K kernel at M <= DECODE_MAX_M: every decode step; "qmatmul", the TMA
and wgmma tile kernel: prefill chunks, the MoE experts at prefill),
weight_only_matmul ("weight_only_matmul_decode", the split-K kernel at M <=
WO_DECODE_MAX_M: every decode step; "weight_only_matmul", the TMA and wgmma
tile kernel: prefill chunks longer than that), the int4 GEMMs wo4_split,
w4a8_two_level and w4a8_group in the same two ways ("wo4_split_decode",
"wo4_split", ...; w4a8_group's decode kernel keeps every group's int32 sum
for one f32 chain over all of K, its tile kernel one K split: both bit for
bit),
paged_int8_attention ("paged_int8_attention_split", every call whose rows
fit a split block; "paged_int8_attention", the page
walk, for the rest: G 8 at Dh 256, on no engine path), the two KIVI
updates, one kernel on two routes by the new rows a slot
("k4v8_decode_update", a decode step's write; "k4v8_decode_update_prefill",
a prefill chunk's; the same for kivi4_decode_update), and the int8,
K8V4, K4V8 and Int4 attentions ("int8_kv_attention", ..., the split
decode: every call whose rows fit a split block; "int8_kv_attention_prefill",
..., the prefill kernel on bf16 tensor cores: every prefill chunk, dense,
ring and the paged cache's gathered window, and the KIVI decodes the split
does not take); every served path must have launched the decode kernel of
each routed wrapper it calls and the prefill kernel of each dense and KIVI
attention, and each case of phase 3 the kernel its label names.
wo4_legacy and dequant are on no engine path either
(a caller reaches wo4_legacy through the formulation argument of
weight_only_int4_matmul, and dequant as ops.dequant; QTensor.dequantize
stays on core.numerics, as in the JAX package), so their counts there are
0. The last line is {"ok": true, "device": {...}}.

Tolerances. rowquant codes and scales, qmatmul outputs (f32 and bf16), both
decode scatters and both W4A8 bodies (two_level, group) must equal their
plain versions exactly, and so must dequant, both KIVI decode writers
(all eight cache tensors) and the K8V4 writer (all four). The fused producers are held
to what the JAX package demands of its Pallas kernels against the module
composition: codes equal or one step apart (they sum and compute the
activation in other orders, and a code moves where a value sits on a
rounding boundary) in under FLIP_SHARE of the elements, scales within
SCALE_RTOL; their "max_abs_err" is in code steps; swiglu_quant's phase-3
cases are also held bit for bit, as no code or scale moved there before
the register-resident design either. Attention, dense, paged,
KIVI and K8V4 (bf16 q and output, f32
arithmetic inside), is held to ATTN_TOL times the largest output: both
round their f32 result to bf16 once, after summing in different orders;
the int8 and K8V4 prefill kernel also rounds p * vs to bf16 before its
product with V, as the TPU kernel's bf16 lanes do (at most 2^-9 of each
term; tests/test_torch_attn_prefill.py).
The weight-only products, int8 and int4 (split, legacy), are held to
``ops.weight_only_tolerance`` / ``ops.weight_only_int4_tolerance``: every
product is the same in the two versions, which differ only by the order of
their f32 sums (each within K * 2**-24 * sum_k |x * w| of the exact sum),
then one ulp of the output type. The
model agreement runs the same model twice, through the kernels and through
the plain versions, so only the summation orders differ; but each dynamic
linear turns any difference in its input into int8 codes that move by one
step where a value sits on a rounding boundary, and at random weights those
steps compound over the 2 layers into logit differences of about one
percent. The limits (AGREE_REL on the relative L2 error, AGREE_ARGMAX on
the share of equal argmaxes over all positions) sit above that;
planted_faults() stand in for a wrong kernel, and the run fails if one of
them passes the limits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
L2_BYTES = 50 * 2**20
ATTN_TOL = 2.0**-7
AGREE_REL, AGREE_ARGMAX = 3e-2, 0.9

HIDDEN, INTER, VOCAB, HEADS, HEAD_DIM, LAYERS = 4096, 11008, 32000, 32, 128, 32
# Gemma-2-9B (ModelConfig.gemma2_9b): 16 query heads over 8 KV heads of 256,
# a window of 4096 on every other layer, scores scaled by 256^-0.5 and
# capped at 50; the phase-17 engine holds 8192 positions
G2_HIDDEN, G2_INTER, G2_VOCAB, G2_HEADS, G2_KV, G2_HEAD_DIM, G2_LAYERS = (
    3584, 14336, 256000, 16, 8, 256, 42)
G2_SEQ, G2_WINDOW, G2_SCALE, G2_SOFTCAP = 8192, 4096, 256.0**-0.5, 50.0
# the windowed int8 decode at equal lengths 8000 reads 4096 of 8001 keys: at
# most this share of the full-causal time, or its tiles are not skipped
WINDOW_TIME_SHARE = 0.65
# Mistral-7B (ModelConfig.mistral_7b): 32 query heads over 8 KV heads of
# 128, a window of 4096 on every layer; its ring behind a prefill chunk of
# 512 holds 4608 columns (4640 with 4 StreamingLLM sinks). Decode lengths:
# two rows inside the ring, two wrapped (9000, 20000).
M7_KV, M7_INTER, M7_WINDOW, M7_CHUNK = 8, 14336, 4096, 512
RING_LENGTHS = [63, 4607, 9000, 20000]
# BLOOM-560m (ModelConfig.bloom_560m): 16 heads of 64 (no GQA), ALiBi; the
# phase-22 dense caches hold 2048 positions
BL_HEADS, BL_HEAD_DIM, BL_SEQ, BL_LENGTHS = 16, 64, 2048, [63, 700, 2047, 1000]
# In the sinks cases of phase 3 the sink columns' key scales are this many
# times the others', so that the sinks draw attention, as StreamingLLM's
# do, and a kernel that drops them shows
SINK_SCALE = 10.0
# GPT-OSS-20B (ModelConfig.gpt_oss_20b): 64 query heads over 8 KV heads of
# 64 (group 8), learned attention sinks, a window of 128 on every other
# layer, 32 experts (top 4) of width 2880; the phase-24 engine holds 8192
# positions. At a decode step of 4 slots each expert holds 1 token
# (capacity ceil(4 * 4 / 32 * 1.25)), so its products run at M = 1.
GO_HIDDEN, GO_INTER, GO_VOCAB, GO_HEADS, GO_KV, GO_HEAD_DIM, GO_LAYERS, GO_EXPERTS = (
    2880, 2880, 201088, 64, 8, 64, 24, 32)
GO_SEQ, GO_WINDOW = 8192, 128
# A 512-token prefill chunk gives each expert ceil(4 * 512 / 32 * 1.25) = 80
# tokens: the experts' products at prefill run at M = 80.
GO_PREFILL_M = 80


def log(msg: str) -> None:
    print(msg, flush=True)


def bench(calls, iters: int = 20) -> float:
    """Device time per call, in ms: ``iters`` calls cycling through
    ``calls`` (closures over separate input copies, so large inputs come
    from device memory and not from L2, as they do on the main path) are
    captured in one CUDA graph after a warm-up, and one replay is timed
    with CUDA events. The graph keeps the host's launch overhead out of the
    number, so a kernel shorter than its Python wrapper is not timed as
    the wrapper."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bench_synced(calls, iters: int = 5) -> float:
    """Time per call, in ms, of ``iters`` eager calls cycling through
    ``calls`` that may wait on the card themselves (a boolean mask's
    nonzero), so no CUDA graph can hold them: CUDA events around the calls,
    the host's time between them included."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    """Input copies to cycle through so that one pass exceeds 3x the L2."""
    return max(1, min(16, math.ceil(3 * L2_BYTES / max(nbytes, 1))))


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: kernels ----------------------------------------------------------


# phase 3's rowquant cases (M, K), bf16: Llama-2-7B's activation widths at
# M = 4 and 256, Gemma-2-9B's other two (3584, 14336; its o_proj input is
# 4096 wide) at M = 4, GPT-OSS-20B's 2880 at M = 4 and at M = 32 (a decode
# step's expert slots, one per expert); then the 7B down input at M = 1 and
# 1024, its tp = 2 shard (5504) and an odd K (every other row starts off a
# 16-byte boundary)
ROWQUANT_CASES = ((4, HIDDEN), (4, INTER), (256, HIDDEN), (256, INTER), (4, G2_HIDDEN),
                  (4, G2_INTER), (4, GO_HIDDEN), (GO_EXPERTS, GO_HIDDEN), (1, INTER),
                  (1024, INTER), (4, INTER // 2), (4, HIDDEN - 1))
# phase 3's swiglu_quant cases (M, I, act), bf16 gate and up, bf16 cast:
# Llama-2-7B's MLP at M = 4 and 256, SiLU and the tanh GELU; then SiLU at
# M = 1 and 1024, the tp = 2 shard and an odd I
SWIGLU_CASES = tuple((m, INTER, act) for act in ("silu", "gelu") for m in (4, 256)) + (
    (1, INTER, "silu"), (1024, INTER, "silu"), (4, INTER // 2, "silu"),
    (4, INTER - 1, "silu"))
# the wrappers whose two routes (ops.ROUTED) are the row plan's: "<name>"
# (a block a row) and "<name>_cluster" (a row over a cluster)
ROW_ROUTED = ("rowquant", "swiglu_quant")


def row_plan_of(m: int, k: int):
    """The row plan a bf16 [m, k] call takes (ops.rowquant.rowquant_plan)."""
    from protoquant_tpu_torch.ops.rowquant import rowquant_plan

    return rowquant_plan(m, k, 2)


def dropped_maximum(h, plan):
    """A planted fault of the row kernels: their plain split spelling
    (ops.rowquant_parts_ref) of the producer's output ``h`` with the slice
    that holds each row's maximum left out of the maximum."""
    from protoquant_tpu_torch.ops.rowquant import part_maxima, quantize_parts, row_slices

    slices = row_slices(h.shape[-1], plan.blocks, h.element_size())
    maxima = part_maxima(h, slices)
    maxima.scatter_(-1, maxima.argmax(-1, keepdim=True), 0.0)
    return quantize_parts(h, maxima, slices)


def check_rowquant(ops, gen, dev):
    """ROWQUANT_CASES, each on its plan's route, bit for bit; each also
    against the plain split spelling with the slice holding each row's
    maximum dropped (a planted fault, which must differ)."""
    # the first graph of a cluster launch after the build reads 3-5x slow,
    # once: each route's graph is replayed once untimed first
    for k in (HIDDEN, INTER):
        x = torch.zeros(4, k, dtype=torch.bfloat16, device=dev)
        bench([lambda x=x: ops.rowquant(x)])
    cases = []
    for m, k in ROWQUANT_CASES:
        xs = [torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(copies_for(m * k * 2))]
        plan = row_plan_of(m, k)
        before = ops.rowquant.routes[plan.route]
        xq, sx = ops.rowquant(xs[0])
        rq, rs = ops.rowquant_ref(xs[0])
        torch.cuda.synchronize()
        if ops.rowquant.routes[plan.route] != before + 1:
            raise AssertionError(f"rowquant M={m} K={k}: not on route {plan.route}")
        if not (torch.equal(xq, rq) and torch.equal(sx, rs)):
            raise AssertionError(f"rowquant M={m} K={k}: codes or scales differ")
        bq, bs = dropped_maximum(xs[0], plan)
        faults = {"slice maximum dropped": int((bq != xq).sum() + (bs != sx).sum())}
        if not all(faults.values()):
            raise AssertionError(f"rowquant M={m} K={k}: the check passes a fault {faults}")
        b, kind = bound_ms(m * k * 3 + 4 * m, 0, INT8_OPS_PER_S)
        cases.append({
            "shape": f"M={m} K={k} bf16", "max_abs_err": 0.0, "route": plan.route,
            "plan": plan._asdict(), "faults_differing_elements": faults,
            "ms": bench([lambda x=x: ops.rowquant(x) for x in xs]),
            "plain_ms": bench([lambda x=x: ops.rowquant_ref(x) for x in xs]),
            "bound_ms": b, "bound_by": kind, "library_ms": None})
    return cases


# Gemma-2-9B's projections (K, N): q, k and v, o, gate and up, down, lm_head
G2_LINEAR_SHAPES = ((G2_HIDDEN, G2_HEADS * G2_HEAD_DIM), (G2_HIDDEN, G2_KV * G2_HEAD_DIM),
                    (G2_HEADS * G2_HEAD_DIM, G2_HIDDEN), (G2_HIDDEN, G2_INTER),
                    (G2_INTER, G2_HIDDEN), (G2_HIDDEN, G2_VOCAB))
# Mistral-7B's projections that Llama-2-7B lacks: k and v, gate and up, down
M7_LINEAR_SHAPES = ((HIDDEN, M7_KV * HEAD_DIM), (HIDDEN, M7_INTER), (M7_INTER, HIDDEN))
# GPT-OSS-20B's projections: q, k and v, o, lm_head (at M = 4); an expert's
# gate_up and down (at M = 1)
GO_LINEAR_SHAPES = ((GO_HIDDEN, GO_HEADS * GO_HEAD_DIM), (GO_HIDDEN, GO_KV * GO_HEAD_DIM),
                    (GO_HEADS * GO_HEAD_DIM, GO_HIDDEN), (GO_HIDDEN, GO_VOCAB))
GO_EXPERT_SHAPES = ((GO_HIDDEN, 2 * GO_INTER), (GO_INTER, GO_HIDDEN))


def qmatmul_shapes(decode_max_m: int = 64) -> list:
    """(M, K, N) of the GEMM cases: Llama-2-7B's projections at M = 4 and
    256, Gemma-2-9B's, the three other Mistral-7B ones and GPT-OSS-20B's at
    M = 4, GPT-OSS-20B's expert products at M = 1, the 7B gate/up at M = 1,
    8, 16, 32, ``decode_max_m`` (the decode kernel's threshold) and 64; then the
    prefill products the tile kernel takes beyond the 7B ones at M = 256:
    GPT-OSS-20B's experts at M = 80 (``GO_PREFILL_M``), Gemma-2-9B's
    gate/up and down at M = 512 and the 7B gate/up at M = 128."""
    shapes = [(m, k, n) for m in (4, 256)
              for k, n in ((HIDDEN, HIDDEN), (HIDDEN, INTER), (INTER, HIDDEN), (HIDDEN, VOCAB))]
    return (shapes + [(4, k, n) for k, n in G2_LINEAR_SHAPES + M7_LINEAR_SHAPES
                      + GO_LINEAR_SHAPES]
            + [(1, k, n) for k, n in GO_EXPERT_SHAPES]
            + [(m, HIDDEN, INTER) for m in dict.fromkeys((1, 8, 16, 32, decode_max_m, 64))]
            + [(GO_PREFILL_M, k, n) for k, n in GO_EXPERT_SHAPES]
            + [(512, G2_HIDDEN, G2_INTER), (512, G2_INTER, G2_HIDDEN), (128, HIDDEN, INTER)])


def check_qmatmul(ops, gen, dev, route):
    """The GEMM cases (``qmatmul_shapes``) that ``route`` takes: "decode"
    (M <= DECODE_MAX_M, csrc/qmatmul_decode.cu) or "tile" (larger M,
    csrc/qmatmul.cu, whose plan each case prints); each call must have gone
    through that kernel, bit for bit with the plain version. Each case also
    holds a planted fault, which must differ: the decode cases the plain
    split spelling with its last K slice dropped, the tile cases the plain
    product with the last 128-byte K step of xq zeroed."""
    from protoquant_tpu_torch.ops.qmatmul import (DECODE_MAX_M, TILE_STEP, k_slices,
                                                  qmatmul_decode_plan, qmatmul_tile_plan)

    cases = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, k, n in qmatmul_shapes(DECODE_MAX_M):
        splits = qmatmul_decode_plan(m, n, k, sms)
        if (splits is None) != (route == "tile"):
            continue
        plan = qmatmul_tile_plan(m, n, k, sms) if splits is None else None
        xq, sx = ops.rowquant_ref(torch.randn(m, k, generator=gen, device=dev))
        ws = [torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies_for(n * k))]
        sw = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        for out in (torch.float32, torch.bfloat16):
            before = ops.qmatmul.routes[route]
            y = ops.qmatmul(xq, ws[0], sx, sw, out_dtype=out)
            ref = ops.qmatmul_ref(xq, ws[0], sx, sw, out_dtype=out)
            torch.cuda.synchronize()
            if ops.qmatmul.routes[route] != before + 1:
                raise AssertionError(f"qmatmul M={m} K={k} N={n}: not the {route} kernel")
            if not torch.equal(y, ref):
                err = (y.float() - ref.float()).abs().max().item()
                raise AssertionError(f"qmatmul M={m} K={k} N={n} {out}: "
                                     f"max abs err {err}")
            del ref
        # a planted fault: the decode kernel's last K slice dropped, or the
        # tile kernel's last 128-byte K step
        k0, k1 = (k_slices(k, splits)[-1] if splits is not None
                  else (TILE_STEP * ((k - 1) // TILE_STEP), k))
        dropped = xq.clone()
        dropped[:, k0:k1] = 0
        fault = "last K slice dropped" if splits is not None else "last K step zeroed"
        bad = ops.qmatmul_splitk_ref(dropped, ws[0], sx, sw, out_dtype=torch.bfloat16,
                                     k_splits=splits or 1)
        faults = {fault: int((bad != y).sum().item())}
        if faults[fault] == 0:
            raise AssertionError(f"qmatmul M={m} K={k} N={n}: the check passes a fault "
                                 f"({fault})")
        del y, bad
        b, kind = bound_ms(m * k + n * k + 2 * m * n + 4 * (m + n),
                           2 * m * n * k, INT8_OPS_PER_S)
        # library yardstick: the int32 GEMM alone (cuBLASLt), M padded
        # to the 32 rows it accepts; no epilogue
        xpad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
        xpad[:m] = xq
        bf = torch.bfloat16
        cases.append({
            "shape": f"M={m} K={k} N={n} bf16 out", "max_abs_err": 0.0,
            "k_splits": splits if plan is None else plan[1], "faults_differing_elements": faults,
            **({"plan": {"tile_rows": plan[0], "k_splits": plan[1]}} if plan else {}),
            "ms": bench([lambda w=w: ops.qmatmul(xq, w, sx, sw, out_dtype=bf) for w in ws]),
            "plain_ms": bench([lambda w=w: ops.qmatmul_ref(xq, w, sx, sw, out_dtype=bf)
                               for w in ws], iters=5),
            "bound_ms": b, "bound_by": kind,
            "library_ms": bench([lambda w=w: torch._int_mm(xpad, w.t()) for w in ws])})
        del ws
    return cases


def _cache(gen, dev, B, KV, S, Dh):
    kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=gen, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, KV, S, Dh), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = (torch.rand(B, KV, S, generator=gen, device=dev) + 0.5) * 0.02
    vs = (torch.rand(B, KV, S, generator=gen, device=dev) + 0.5) * 0.02
    return kq, ks, vq, vs


def check_scatter(ops, gen, dev):
    """The decode write at Llama-2-7B's cache shape, then Gemma-2-9B's and
    GPT-OSS-20B's."""
    cases = []
    for KV, S, Dh in ((HEADS, 1024, HEAD_DIM), (G2_KV, G2_SEQ, G2_HEAD_DIM),
                      (GO_KV, GO_SEQ, GO_HEAD_DIM)):
        B = 4
        lengths = torch.tensor([5, S, 0, S - 1], dtype=torch.int32, device=dev)  # row 1 full
        k8 = torch.randint(-127, 128, (B, KV, 1, Dh), generator=gen, device=dev,
                           dtype=torch.int8)
        v8 = torch.randint_like(k8, -127, 128)
        ksn = torch.rand(B, KV, 1, generator=gen, device=dev)
        vsn = torch.rand(B, KV, 1, generator=gen, device=dev)
        base = _cache(gen, dev, B, KV, S, Dh)
        a = [t.clone() for t in base]
        b = [t.clone() for t in base]
        ops.kv_scatter_decode(*a, lengths, k8, ksn, v8, vsn)
        ops.kv_scatter_decode_ref(*b, lengths, k8, ksn, v8, vsn)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("kv_scatter_decode differs from its plain version")
        if not torch.equal(a[0][1], base[0][1]):
            raise AssertionError("kv_scatter_decode wrote into a slot at capacity")
        moved = B * KV * (2 * Dh + 8)
        bnd, kind = bound_ms(2 * moved + 4 * B, 0, INT8_OPS_PER_S)
        cases.append({
            "shape": f"B={B} KV={KV} S={S} Dh={Dh}", "max_abs_err": 0.0,
            "ms": bench([lambda: ops.kv_scatter_decode(*a, lengths, k8, ksn, v8, vsn)]),
            "plain_ms": bench([lambda: ops.kv_scatter_decode_ref(*b, lengths, k8, ksn, v8,
                                                                 vsn)]),
            "bound_ms": bnd, "bound_by": kind, "library_ms": None})
        del base, a, b
    return cases


# The wrappers that route between the split decode and the prefill kernel by
# the split plan (ops.ROUTED): phase 3's cases name the route they take
DENSE_ATTENTIONS = ("int8_kv_attention", "mixed_kv_attention")
# the attentions whose calls take the split decode or the prefill kernel
ROUTED_ATTENTIONS = DENSE_ATTENTIONS + ("k4v8_attention", "int4_kv_attention")


def routed_call(ops, name, label, call):
    """call() once; an int8, K8V4, K4V8 or Int4 attention must launch the
    kernel its case's label names: "prefill" the prefill kernel, any other
    the split decode."""
    if name not in ROUTED_ATTENTIONS:
        return call()
    route = "prefill" if "prefill" in label else "split"
    before = getattr(ops, name).routes[route]
    out = call()
    if getattr(ops, name).routes[route] != before + 1:
        raise AssertionError(f"{name} {label}: not the {route} kernel")
    return out


def check_attention(ops, gen, dev):
    """The int8 attention against its plain version within ATTN_TOL at
    Llama-2-7B's shapes: decode at lengths 63 / 700 / 1023 / 255 (the split
    design) and two prefill chunks of 256 (the prefill kernel). Two calls
    on the same inputs must give the same bits. Planted fault in the decode
    case: the plain split spelling with each row's last live split dropped
    must miss the tolerance. Library: SDPA over the cache dequantized to
    bf16."""
    import torch.nn.functional as F

    S, KV, H, Dh = 1024, HEADS, HEADS, HEAD_DIM
    cases = []
    # the last case is a padded prefill chunk that reaches past S: its rows
    # past S - lens - 1 see all S keys (the kernel clamps the walk at S)
    for label, B, T, lens in (("decode", 4, 1, [63, 700, 1023, 255]),
                              ("prefill", 1, 256, [256]),
                              ("prefill", 1, 256, [S - 100])):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = [_cache(gen, dev, B, KV, S, Dh)
                  for _ in range(copies_for(B * KV * S * (2 * Dh + 8)))]
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        out = routed_call(ops, "int8_kv_attention", label,
                          lambda: ops.int8_kv_attention(q, *caches[0], lengths))
        ref = ops.int8_kv_attention_ref(q, *caches[0], lengths)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"attention {label}: max abs err {err} > {tol}")
        if not torch.equal(ops.int8_kv_attention(q, *caches[0], lengths), out):
            raise AssertionError(f"attention {label}: two calls on the same inputs differ")
        margins = {}
        if label == "decode":
            margins = _margins("int8_kv_attention", label, out, tol, {
                "last live split dropped": dense_split_dropped(q, caches[0], lengths)})
        # valid keys per (b, t): min(S, len + t + 1)
        t_idx = torch.arange(T, device=dev)
        valid = (lengths.long()[:, None] + t_idx[None, :] + 1).clamp_max(S)
        ctx = (lengths.long() + T).clamp_max(S)  # keys read per (b, kv head)
        nbytes = (KV * ctx.sum().item() * (2 * Dh + 8)
                  + 2 * q.numel() * 2 + 4 * B)
        flops = 4 * Dh * H * valid.sum().item()
        bnd, kind = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        # library yardstick: SDPA over a dequantized bf16 copy of the cache
        pos = torch.arange(S, device=dev)
        mask = (pos[None, None, :] <= (lengths.long()[:, None] + t_idx)[:, :, None])[:, None]
        deq = [((kq.float() * ks[..., None]).to(torch.bfloat16),
                (vq.float() * vs[..., None]).to(torch.bfloat16))
               for kq, ks, vq, vs in caches[:copies_for(B * KV * S * Dh * 4)]]
        qh = q.transpose(1, 2)
        cases.append({
            "shape": f"{label} B={B} T={T} H={H} S={S} lengths={lens}",
            "max_abs_err": err, "fault_margins": margins,
            "ms": bench([lambda c=c: ops.int8_kv_attention(q, *c, lengths) for c in caches]),
            "plain_ms": bench([lambda c=c: ops.int8_kv_attention_ref(q, *c, lengths)
                               for c in caches], iters=5),
            "bound_ms": bnd, "bound_by": kind,
            "library_ms": bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask) for k, v in deq])})
        del caches, deq
    return cases


LINEAR_SHAPES = ((HIDDEN, HIDDEN), (HIDDEN, INTER), (INTER, HIDDEN), (HIDDEN, VOCAB))  # (K, N)


# the weight-only int8 GEMM cases' token rows: decode steps (1, 4, 16: the
# decode kernel up to WO_DECODE_MAX_M) and prefill chunks (the tile kernel
# above it)
WO_MS = (1, 4, 16, 32, 48, 256, 512)


def _wo_route(m, n, k, dev):
    """(route, plan, the plan's last K slice) of a weight-only case: the
    decode kernel up to WO_DECODE_MAX_M at wo_decode_plan's K splits, the
    tile kernel above at wo_tile_plan's (tokens a tile, K splits)."""
    from protoquant_tpu_torch.ops.qmatmul import _sm_count, k_slices
    from protoquant_tpu_torch.ops.wo_matmul import (WO_DECODE_MAX_M, WO_DECODE_STEP,
                                                    WO_TILE_STEP, wo_decode_held,
                                                    wo_decode_plan, wo_tile_plan)

    if m <= WO_DECODE_MAX_M:
        splits = wo_decode_plan(m, n, k, wo_decode_held(dev, m))
        return "decode", splits, k_slices(k, splits, WO_DECODE_STEP)[-1]
    plan = wo_tile_plan(m, n, k, _sm_count(dev))
    return "tile", plan, k_slices(k, plan[1], WO_TILE_STEP)[-1]


def check_weight_only(ops, gen, dev):
    """The weight-only int8 GEMM against its plain version, within
    ``ops.weight_only_tolerance``, at the 7B shapes and each M of ``WO_MS``,
    through the route its wrapper names for M (the decode kernel or the
    tile kernel, at its plan), bitwise equal across two calls. Each case
    holds a planted fault, which must miss: the plain product with the
    plan's last K slice dropped. Library yardstick: ``torch.matmul`` over a
    bf16 copy of W made beforehand."""
    bf = torch.bfloat16
    cases = []
    for m in WO_MS:
        for k, n in LINEAR_SHAPES:
            x = torch.randn(m, k, generator=gen, device=dev).to(bf)
            ws = [torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(copies_for(n * k))]
            sw = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
            route, plan, (k0, k1) = _wo_route(m, n, k, dev)
            err = 0.0
            for out in (torch.float32, bf):
                before = ops.weight_only_matmul.routes[route]
                y = ops.weight_only_matmul(x, ws[0], sw, out_dtype=out)
                again = ops.weight_only_matmul(x, ws[0], sw, out_dtype=out)
                ref = ops.weight_only_matmul_ref(x, ws[0], sw, out_dtype=out)
                torch.cuda.synchronize()
                if ops.weight_only_matmul.routes[route] != before + 2:
                    raise AssertionError(f"weight_only_matmul M={m} K={k} N={n}: not the "
                                         f"{route} kernel")
                if not torch.equal(y, again):
                    raise AssertionError(f"weight_only_matmul M={m} K={k} N={n} {out}: two "
                                         "calls differ")
                diff = (y.float() - ref.float()).abs()
                tol = ops.weight_only_tolerance(x, ws[0], sw, ref)
                if not bool((diff <= tol).all()):
                    raise AssertionError(f"weight_only_matmul M={m} K={k} N={n} {out}: "
                                         f"max excess {(diff - tol).max().item()}")
                err = max(err, diff.max().item())
            # a planted fault: the plan's last K slice dropped
            dropped = x.clone()
            dropped[:, k0:k1] = 0
            bad = ops.weight_only_matmul_ref(dropped, ws[0], sw, out_dtype=bf)
            keys = _gemm_case_keys(route, plan, {"last K slice dropped": int(
                ((bad.float() - y.float()).abs() > tol).sum())})
            del y, again, ref, bad, dropped
            b, kind = bound_ms(m * k * 2 + n * k + 4 * n + 2 * m * n, 2 * m * n * k,
                               BF16_FLOPS_PER_S)
            # library yardstick: a bf16 GEMM over a bf16 copy of W made
            # beforehand (cuBLAS); the port never calls it
            wb = [w.to(bf) for w in ws[:copies_for(2 * n * k)]]
            cases.append({
                "shape": f"M={m} K={k} N={n} bf16 out", "max_abs_err": err, **keys,
                "ms": bench([lambda w=w: ops.weight_only_matmul(x, w, sw, out_dtype=bf)
                             for w in ws]),
                "plain_ms": bench([lambda w=w: ops.weight_only_matmul_ref(x, w, sw, out_dtype=bf)
                                   for w in ws], iters=5),
                "bound_ms": b, "bound_by": kind,
                "library_ms": bench([lambda w=w: torch.matmul(x, w.t()) for w in wb])})
            del ws, wb
    return cases


GROUP4 = 128  # int4 group of every Llama-2-7B projection (pick_int4_group)
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
# the int4 GEMM cases' token rows: decode steps (1, 4, 16: the decode kernel
# of a routed body) and prefill chunks (48, 256, 512: the tile kernel)
INT4_MS = (1, 4, 16, 48, 256, 512)
# the int4 bodies that route by M (ops.ROUTED), by formulation
ROUTED_INT4 = {"split": "wo4_split", "two_level": "w4a8_two_level", "group": "w4a8_group"}
# the GEMM wrappers whose entries name their tile kernel, the decode kernel's
# under name + "_decode"
ROUTED_GEMMS = ("weight_only_matmul", *ROUTED_INT4.values())


def _int4_weights(gen, dev, n, k, copies):
    """``copies`` random packed int4 weights [N, K/2] (every code in [-8, 7])
    with group scales [N, K/128]."""
    return [(torch.randint(-128, 128, (n, k // 2), generator=gen, device=dev, dtype=torch.int8),
             torch.rand(n, k // GROUP4, generator=gen, device=dev) * 2e-3 + 1e-4)
            for _ in range(copies)]


def _int4_route(ops, formulation, m, n, k, dev):
    """(the wrapper, the route it must take, its plan) of an int4 case: a
    routed body takes the decode kernel up to its threshold (split
    SPLIT_DECODE_MAX_M rows, two_level INT4_DECODE_MAX_M, group
    GROUP_DECODE_MAX_M), at ``int4_decode_plan``'s K splits (group:
    ``group_decode_plan``'s, whose group sums fit a block), and the tile
    kernel above, at ``int4_tile_plan``'s (tokens a tile, K splits); the
    other bodies have one kernel (None)."""
    import importlib

    from protoquant_tpu_torch.ops.qmatmul import _sm_count
    from protoquant_tpu_torch.ops.wo4_matmul import (INT4_DECODE_MAX_M, SPLIT_DECODE_MAX_M,
                                                     int4_decode_held, int4_decode_plan,
                                                     int4_tile_plan)

    if formulation not in ROUTED_INT4:
        return None, None, None
    name = ROUTED_INT4[formulation]
    A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
    top = {"split": SPLIT_DECODE_MAX_M, "two_level": INT4_DECODE_MAX_M,
           "group": A.GROUP_DECODE_MAX_M}[formulation]
    plan = None
    if m <= top:
        plan = (A.group_decode_plan(m, n, k, GROUP4, A.group_decode_held(dev, m, k, GROUP4))
                if formulation == "group" else
                int4_decode_plan(m, n, k, GROUP4, int4_decode_held(f"pq_{name}_decode", dev, m,
                                                                   GROUP4)))
    if plan is None:
        return (getattr(ops, name), "tile",
                int4_tile_plan(m, n, k, GROUP4, _sm_count(dev), formulation))
    return getattr(ops, name), "decode", plan


def _gemm_case_keys(route, plan, faults) -> dict:
    """The keys a weight-only or int4 GEMM case adds to its entry: its route
    and plan (a routed body: the decode kernel's K splits, or the tile
    kernel's tokens a tile and K splits), K splits, the elements each
    planted fault moves (none: the check passes it, an error)."""
    missed = [name for name, count in faults.items() if count == 0]
    if missed:
        raise AssertionError(f"a GEMM check passes a fault {missed}")
    tokens, splits = plan if route == "tile" else (None, plan or 1)
    keys = {"k_splits": splits, "faults_differing_elements": faults}
    if route is not None:
        keys["plan"] = {"route": route, "k_splits": splits,
                        **({"tokens": tokens} if tokens else {})}
    return keys


def _last_group_zeroed(packed):
    """The planted fault of the int4 cases: the weight's last group of
    codes set to 0 (its g / 2 packed bytes)."""
    dropped = packed.clone()
    dropped[:, -GROUP4 // 2:] = 0
    return dropped


def check_wo4(ops, gen, dev, formulation):
    """The wo4 body against its plain version, within
    ``ops.weight_only_int4_tolerance``, at each M of ``INT4_MS``; the split
    body through the route its wrapper names for M (the decode kernel or
    the tile kernel, at its plan). Each case holds a planted fault, which
    must differ: the plain product with the weight's last group zeroed.
    Library yardstick: ``torch.matmul`` over a dequantized copy of W made
    beforehand (bf16 for split, whose x is bf16; f32 for legacy, the same
    function)."""
    from protoquant_tpu_torch.core import numerics

    bf = torch.bfloat16
    split = formulation == "split"
    lib_dtype = bf if split else torch.float32
    cases = []
    for m in INT4_MS:
        for k, n in LINEAR_SHAPES:
            wbytes = n * k // 2 + 4 * n * (k // GROUP4)
            ws = _int4_weights(gen, dev, n, k, copies_for(wbytes))
            x = torch.randn(m, k, generator=gen, device=dev)
            x = x.to(bf) if split else x
            wrapper, route, plan = _int4_route(ops, formulation, m, n, k, dev)
            err = 0.0
            for out in (torch.float32, bf):
                before = dict(wrapper.routes) if wrapper else None
                y = ops.weight_only_int4_matmul(x, *ws[0], GROUP4, None, out, formulation)
                ref = ops.weight_only_int4_matmul_ref(x, *ws[0], GROUP4, None, out, formulation)
                torch.cuda.synchronize()
                if wrapper and wrapper.routes[route] != before[route] + 1:
                    raise AssertionError(f"wo4 {formulation} M={m} K={k} N={n}: not the "
                                         f"{route} kernel")
                diff = (y.float() - ref.float()).abs()
                tol = ops.weight_only_int4_tolerance(x, *ws[0], GROUP4, ref, formulation)
                if not bool((diff <= tol).all()):
                    raise AssertionError(f"wo4 {formulation} M={m} K={k} N={n} {out}: "
                                         f"max excess {(diff - tol).max().item()}")
                err = max(err, diff.max().item())
            bad = ops.weight_only_int4_matmul_ref(x, _last_group_zeroed(ws[0][0]), ws[0][1],
                                                  GROUP4, None, bf, formulation)
            keys = _gemm_case_keys(route, plan, {"last group zeroed": int((bad != y).sum())})
            del y, ref, bad
            b, kind = bound_ms(x.numel() * x.element_size() + wbytes + 2 * m * n,
                               2 * m * n * k, BF16_FLOPS_PER_S if split else F32_FLOPS_PER_S)
            wd = [numerics.dequantize_int4(p, sc, GROUP4).to(lib_dtype)
                  for p, sc in ws[:copies_for(n * k * (2 if split else 4))]]
            cases.append({
                "shape": f"M={m} K={k} N={n} bf16 out", "max_abs_err": err, **keys,
                "ms": bench([lambda w=w: ops.weight_only_int4_matmul(
                    x, *w, GROUP4, None, bf, formulation) for w in ws]),
                "plain_ms": bench([lambda w=w: ops.weight_only_int4_matmul_ref(
                    x, *w, GROUP4, None, bf, formulation) for w in ws], iters=5),
                "bound_ms": b, "bound_by": kind,
                "library_ms": bench([lambda w=w: torch.matmul(x, w.t()) for w in wd])})
            del ws, wd
    return cases


def _last_k_slice_dropped(ops, xq, sx, w, k, k_splits):
    """The planted fault of the group decode cases: the decode kernel's
    spelling (``w4a8_group_splitk_ref``) at its plan's K splits with the
    last split's K slice dropped (its packed bytes zeroed: its group sums
    0)."""
    import importlib

    W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
    k0, _ = W.int4_k_slices(k, GROUP4, k_splits)[-1]
    dropped = w[0].clone()
    dropped[:, k0 // 2:] = 0
    return ops.w4a8_group_splitk_ref(xq, sx, dropped, w[1], GROUP4, None, torch.bfloat16,
                                     k_splits)


def check_w4a8(ops, gen, dev, formulation):
    """The w4a8 body against its plain version, exactly (``torch.equal``), at
    each M of ``INT4_MS``, through the route its wrapper names for M (the
    decode kernel or the tile kernel, at its plan). Each case holds a planted
    fault, which must differ: the plain product with the weight's last
    group zeroed; and each group decode case a second: its spelling with
    the plan's last K slice dropped. Library yardstick for two_level:
    ``torch._int_mm`` (M padded to 32 rows) over the int8 requantized copy
    of W made beforehand, with the same epilogue, the same function; group
    has none (no one PyTorch call scales per group)."""
    from protoquant_tpu_torch.core import numerics

    bf = torch.bfloat16
    two_level = formulation == "two_level"
    cases = []
    for m in INT4_MS:
        for k, n in LINEAR_SHAPES:
            wbytes = n * k // 2 + 4 * n * (k // GROUP4) + (4 * n if two_level else 0)
            ws = _int4_weights(gen, dev, n, k, copies_for(wbytes))
            tls = [ops.two_level_scales(sc) if two_level else None for _, sc in ws]
            xq, sx = ops.rowquant_ref(torch.randn(m, k, generator=gen, device=dev))
            wrapper, route, plan = _int4_route(ops, formulation, m, n, k, dev)
            for out in (torch.float32, bf):
                before = dict(wrapper.routes) if wrapper else None
                y = ops.w4a8_matmul(xq, sx, *ws[0], GROUP4, None, out, formulation, tls[0])
                ref = ops.w4a8_matmul_ref(xq, sx, *ws[0], GROUP4, None, out, formulation, tls[0])
                torch.cuda.synchronize()
                if wrapper and wrapper.routes[route] != before[route] + 1:
                    raise AssertionError(f"w4a8 {formulation} M={m} K={k} N={n}: not the "
                                         f"{route} kernel")
                if not torch.equal(y, ref):
                    err = (y.float() - ref.float()).abs().max().item()
                    raise AssertionError(f"w4a8 {formulation} M={m} K={k} N={n} {out}: "
                                         f"max abs err {err}")
            bad = ops.w4a8_matmul_ref(xq, sx, _last_group_zeroed(ws[0][0]), ws[0][1], GROUP4,
                                      None, bf, formulation, tls[0])
            faults = {"last group zeroed": int((bad != y).sum())}
            if formulation == "group" and route == "decode":
                bad = _last_k_slice_dropped(ops, xq, sx, ws[0], k, plan)
                faults["last K slice dropped"] = int((bad != y).sum())
            keys = _gemm_case_keys(route, plan, faults)
            del y, ref, bad
            b, kind = bound_ms(m * k + 4 * m + wbytes + 2 * m * n, 2 * m * n * k,
                               INT8_OPS_PER_S)
            library = None
            if two_level:
                xpad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
                xpad[:m] = xq
                sx16 = (sx * 0.0625)[:, None]
                w8s = []
                for (p, _), (r16, scol) in list(zip(ws, tls))[:copies_for(n * k)]:
                    q = numerics.unpack_int4(p, GROUP4).float().reshape(n, -1, GROUP4)
                    w8s.append((torch.round(q * r16[:, :, None]).reshape(n, k).to(torch.int8),
                                scol))
                library = bench([lambda w8=w8, scol=scol: ((torch._int_mm(xpad, w8.t())[:m].float()
                                                            * sx16) * scol).to(bf)
                                 for w8, scol in w8s])
                del w8s
            cases.append({
                "shape": f"M={m} K={k} N={n} bf16 out", "max_abs_err": 0.0, **keys,
                "ms": bench([lambda w=w, tl=tl: ops.w4a8_matmul(
                    xq, sx, *w, GROUP4, None, bf, formulation, tl) for w, tl in zip(ws, tls)]),
                "plain_ms": bench([lambda w=w, tl=tl: ops.w4a8_matmul_ref(
                    xq, sx, *w, GROUP4, None, bf, formulation, tl) for w, tl in zip(ws, tls)],
                    iters=5),
                "bound_ms": b, "bound_by": kind, "library_ms": library})
            del ws, tls
    return cases


NORM_EPS = 1e-5  # Llama-2-7B's rms_norm_eps
# Fused producers against their plain versions: codes equal or one step
# apart in under this share of the elements, scales within this rtol (what
# the JAX package demands of its Pallas kernels).
FLIP_SHARE = {"rms_norm_quant": 1e-3, "swiglu_quant": 0.05}
SCALE_RTOL = {"rms_norm_quant": 1e-6, "swiglu_quant": 1e-2}


def _fused_readings(name: str, label: str, got, ref) -> dict:
    """Codes and scales of a fused producer against its plain version:
    raises past the limits, else returns the readings (max_abs_err in code
    steps)."""
    (q, s), (rq, rs) = got, ref
    torch.cuda.synchronize()
    dq = (q.int() - rq.int()).abs()
    flips = (dq != 0).float().mean().item()
    rel = ((s - rs).abs() / rs.abs()).max().item()
    if dq.max().item() > 1 or flips >= FLIP_SHARE[name] or rel > SCALE_RTOL[name]:
        raise AssertionError(f"{name} {label}: codes differ by up to {dq.max().item()} "
                             f"in a share {flips} (limit {FLIP_SHARE[name]}), scales by "
                             f"rtol {rel} (limit {SCALE_RTOL[name]})")
    return {"max_abs_err": float(dq.max().item()), "flip_share": flips,
            "scale_max_rel_err": rel}


def check_rms_norm_quant(ops, gen, dev):
    """The fused norm at the decode and prefill shapes of Llama-2-7B (bf16
    in, bf16 cast), and once in f32. The weight is drawn from [0.5, 1.5]: a
    kernel reading the wrong weight would pass unseen with weights of 1.
    Library: none (no one PyTorch call norms and quantizes)."""
    cases = []
    for m, dtype in ((4, torch.bfloat16), (256, torch.bfloat16), (4, torch.float32)):
        k = HIDDEN
        size = torch.finfo(dtype).bits // 8
        xs = [(torch.randn(m, k, generator=gen, device=dev) * 2).to(dtype)
              for _ in range(copies_for(m * k * size))]
        w = torch.rand(k, generator=gen, device=dev) + 0.5
        kw = {"eps": NORM_EPS, "cast_dtype": dtype}
        label = f"M={m} K={k} {str(dtype).replace('torch.', '')}"
        read = _fused_readings("rms_norm_quant", label, ops.rms_norm_quant(xs[0], w, **kw),
                               ops.rms_norm_quant_ref(xs[0], w, **kw))
        b, kind = bound_ms(m * k * size + 4 * k + m * k + 4 * m, 0, INT8_OPS_PER_S)
        cases.append({
            "shape": label.replace("bfloat16", "bf16").replace("float32", "f32"), **read,
            "ms": bench([lambda x=x: ops.rms_norm_quant(x, w, **kw) for x in xs]),
            "plain_ms": bench([lambda x=x: ops.rms_norm_quant_ref(x, w, **kw) for x in xs]),
            "bound_ms": b, "bound_by": kind, "library_ms": None})
    return cases


def check_swiglu_quant(ops, gen, dev):
    """SWIGLU_CASES, each on its plan's route, bit for bit (the JAX limits
    of FLIP_SHARE and SCALE_RTOL are the producers' contract; at these
    cases no code or scale moved before this design either); each also
    against the plain split spelling with the slice holding each row's
    maximum dropped (a planted fault, which the limits must refuse).
    Library: none."""
    from protoquant_tpu_torch.ops.fused_quant import swiglu

    bf = torch.bfloat16
    cases = []
    for m, k, act in SWIGLU_CASES:
        pairs = [tuple((torch.randn(m, k, generator=gen, device=dev) * 2).to(bf)
                       for _ in range(2)) for _ in range(copies_for(4 * m * k))]
        label = f"M={m} I={k} {act}"
        plan = row_plan_of(m, k)
        before = ops.swiglu_quant.routes[plan.route]
        got = ops.swiglu_quant(*pairs[0], act=act)
        if ops.swiglu_quant.routes[plan.route] != before + 1:
            raise AssertionError(f"swiglu_quant {label}: not on route {plan.route}")
        read = _fused_readings("swiglu_quant", label, got,
                               ops.swiglu_quant_ref(*pairs[0], act=act))
        # the kernel before the register-resident design read no code and no
        # scale off the plain version at any of these cases
        # (tools/rowquant_timing.py's A/B): none may move here either
        if read["flip_share"] or read["scale_max_rel_err"]:
            raise AssertionError(f"swiglu_quant {label}: {read} off the plain version")
        try:
            _fused_readings("swiglu_quant", label, got,
                            dropped_maximum(swiglu(*pairs[0], act), plan))
        except AssertionError:
            pass
        else:
            raise AssertionError(f"swiglu_quant {label}: the limits pass a dropped slice "
                                 "maximum")
        b, kind = bound_ms(4 * m * k + m * k + 4 * m, 0, INT8_OPS_PER_S)
        cases.append({
            "shape": label, **read, "route": plan.route, "plan": plan._asdict(),
            "ms": bench([lambda p=p: ops.swiglu_quant(*p, act=act) for p in pairs]),
            "plain_ms": bench([lambda p=p: ops.swiglu_quant_ref(*p, act=act)
                               for p in pairs]),
            "bound_ms": b, "bound_by": kind, "library_ms": None})
    return cases


def check_dequant(ops, gen, dev):
    """dequant of a [4096, 11008] int8 matrix, scale per column (axis 0) or
    per row (axis 1), to f32 and bf16: exact. Library, f32 out only: ``q *
    s`` with type promotion, the same function."""
    m, n = HIDDEN, INTER
    q = torch.randint(-127, 128, (m, n), generator=gen, device=dev, dtype=torch.int8)
    cases = []
    for axis in (0, 1):
        s = torch.rand(n if axis == 0 else m, generator=gen, device=dev) * 0.05 + 1e-3
        sb = s[None, :] if axis == 0 else s[:, None]
        for out in (torch.float32, torch.bfloat16):
            y = ops.dequant(q, s, axis, out)
            ref = ops.dequant_ref(q, s, axis, out)
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                err = (y.float() - ref.float()).abs().max().item()
                raise AssertionError(f"dequant axis={axis} {out}: max abs err {err}")
            del y, ref
            size = torch.finfo(out).bits // 8
            b, kind = bound_ms(m * n * (1 + size) + 4 * s.numel(), 0, INT8_OPS_PER_S)
            cases.append({
                "shape": f"axis={axis} {'f32' if size == 4 else 'bf16'} out M={m} N={n}",
                "max_abs_err": 0.0,
                "ms": bench([lambda: ops.dequant(q, s, axis, out)], iters=10),
                "plain_ms": bench([lambda: ops.dequant_ref(q, s, axis, out)], iters=5),
                "bound_ms": b, "bound_by": kind,
                "library_ms": bench([lambda: q * sb], iters=10)
                if out == torch.float32 else None})
    return cases


PAGE = 128


def _pools(gen, dev, P, KV, ps, Dh):
    kq = torch.randint(-127, 128, (P, KV, ps, Dh), generator=gen, device=dev,
                       dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = (torch.rand(P, KV, 1, ps, generator=gen, device=dev) + 0.5) * 0.02
    vs = (torch.rand(P, KV, 1, ps, generator=gen, device=dev) + 0.5) * 0.02
    return kq, ks, vq, vs


def _shuffled_table(gen, B, max_pages, num_pages, dev):
    """[B, max_pages] int32 of distinct, shuffled page ids below the trash
    page num_pages - 1."""
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)
    return perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)


def check_paged_scatter(ops, gen, dev):
    B, KV, Dh, max_pages = 4, HEADS, HEAD_DIM, 1024 // PAGE
    P = B * max_pages + 1
    pt = _shuffled_table(gen, B, max_pages, P, dev)
    pt[1] = -1  # unmapped
    # row 1 unmapped and row 2 past the window: both to the trash page, at
    # offsets 44 and 3
    lengths = torch.tensor([5, 300, max_pages * PAGE + 3, 700], dtype=torch.int32, device=dev)
    k8 = torch.randint(-127, 128, (B, KV, 1, Dh), generator=gen, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint_like(k8, -127, 128)
    ksn = torch.rand(B, KV, 1, generator=gen, device=dev)
    vsn = torch.rand(B, KV, 1, generator=gen, device=dev)
    base = _pools(gen, dev, P, KV, PAGE, Dh)
    a = [t.clone() for t in base]
    b = [t.clone() for t in base]
    ops.paged_kv_scatter_decode(*a, pt, lengths, k8, ksn, v8, vsn)
    ops.paged_kv_scatter_decode_ref(*b, pt, lengths, k8, ksn, v8, vsn)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("paged_kv_scatter_decode differs from its plain version")
    if not (torch.equal(a[0][P - 1, :, 44], k8[1, :, 0])
            and torch.equal(a[0][P - 1, :, 3], k8[2, :, 0])):
        raise AssertionError("paged_kv_scatter_decode: unmapped / past-window rows "
                             "missed the trash page")
    moved = B * KV * (2 * Dh + 8)
    bnd, kind = bound_ms(2 * moved + 4 * B + 4 * B * max_pages, 0, INT8_OPS_PER_S)
    return [{
        "shape": f"B={B} KV={KV} ps={PAGE} Dh={Dh} P={P} lengths={lengths.tolist()}",
        "max_abs_err": 0.0,
        "ms": bench([lambda: ops.paged_kv_scatter_decode(*a, pt, lengths, k8, ksn, v8, vsn)]),
        "plain_ms": bench([lambda: ops.paged_kv_scatter_decode_ref(
            *b, pt, lengths, k8, ksn, v8, vsn)]),
        "bound_ms": bnd, "bound_by": kind, "library_ms": None}]


def paged_split_dropped(q, pools, pt, lengths, alibi_slopes=None):
    """A planted fault: the plain split spelling of the paged attention
    (``paged_attention_partials_ref``, merged) with each row's last live
    split dropped, as a kernel that lost a split would compute."""
    from protoquant_tpu_torch.ops.attention import merge_partials_ref
    from protoquant_tpu_torch.ops.paged_attention import (SPLIT_SPAN,
                                                          paged_attention_partials_ref)

    acc, m, l = paged_attention_partials_ref(q, *pools, pt, lengths, span=SPLIT_SPAN,
                                             alibi_slopes=alibi_slopes)
    return merge_partials_ref(acc, m, _last_live_dropped(l), q.shape[2], dtype=q.dtype)


def check_paged_attention(ops, gen, dev, route="split"):
    """The paged decode at Llama-2-7B's shapes (128-key pages, 1024
    positions, a shuffled table): for ``route`` "split" G = 1 and 4 at B = 4
    (lengths 63 / 700 / 1023 / 255) and G = 1 at B = 9 and 32, each through
    the split kernel (the plan reported), within ATTN_TOL, with each row's
    last live split dropped as a planted fault; for "walk" G = 8 at Dh 256,
    which the split plan refuses (csrc/paged_attention.cu). Library: SDPA
    over each row's gathered, dequantized bf16 window."""
    import torch.nn.functional as F

    from protoquant_tpu_torch.ops.paged_attention import gather_window, paged_split_plan

    max_pages = 1024 // PAGE
    lens = [63, 700, 1023, 255]
    shapes = ([(4, 1, HEAD_DIM), (4, 4, HEAD_DIM), (9, 1, HEAD_DIM), (32, 1, HEAD_DIM)]
              if route == "split" else [(4, 8, 256)])
    cases = []
    for B, group, Dh in shapes:
        P = B * max_pages + 1
        lb = (lens * B)[:B] if B > 4 else lens
        lengths = torch.tensor(lb, dtype=torch.int32, device=dev)
        KV = HEADS // group if Dh == HEAD_DIM else 8
        H = KV * group
        plan = paged_split_plan(H, KV, max_pages, PAGE, Dh)
        if (plan is None) != (route == "walk"):
            raise AssertionError(f"paged attention B={B} G={group} Dh={Dh}: plan {plan}")
        pt = _shuffled_table(gen, B, max_pages, P, dev)
        pools = [_pools(gen, dev, P, KV, PAGE, Dh)
                 for _ in range(copies_for(P * KV * PAGE * (2 * Dh + 8)))]
        q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        before = ops.paged_int8_attention.routes[route]
        out = ops.paged_int8_attention(q, *pools[0], pt, lengths)
        ref = ops.paged_int8_attention_ref(q, *pools[0], pt, lengths)
        torch.cuda.synchronize()
        if ops.paged_int8_attention.routes[route] != before + 1:
            raise AssertionError(f"paged attention B={B} G={group}: not the {route} kernel")
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"paged attention G={group}: max abs err {err} > {tol}")
        label = f"decode B={B} H={H} KV={KV} G={group} Dh={Dh}"
        margins = (_margins("paged_int8_attention", label, out, tol, {
            "last live split dropped": paged_split_dropped(q, pools[0], pt, lengths)})
                   if route == "split" else {})
        again = ops.paged_int8_attention(q, *pools[0], pt, lengths)
        torch.cuda.synchronize()
        if not torch.equal(again, out):
            raise AssertionError(f"paged attention {label}: two calls differ")
        keys = (lengths.long() + 1).sum().item()  # keys each (b, kv head) reads
        nbytes = KV * keys * (2 * Dh + 8) + 2 * q.numel() * 2 + 4 * B * (1 + max_pages)
        bnd, kind = bound_ms(nbytes, 4 * Dh * H * keys, BF16_FLOPS_PER_S)
        # library yardstick: SDPA over each row's gathered, dequantized bf16
        # window
        pos = torch.arange(max_pages * PAGE, device=dev)
        mask = (pos[None, :] <= lengths.long()[:, None])[:, None, None, :]
        deq = []
        for kq, ks, vq, vs in pools[:copies_for(B * KV * max_pages * PAGE * Dh * 4)]:
            gk, gks, gv, gvs = gather_window(kq, ks, vq, vs, pt)
            deq.append(((gk.float() * gks[..., None]).to(torch.bfloat16),
                        (gv.float() * gvs[..., None]).to(torch.bfloat16)))
        qh = q.transpose(1, 2)
        cases.append({
            "shape": f"{label} ps={PAGE} lengths={lb}", "max_abs_err": err,
            "plan": ({"route": "split", "span": plan[0], "n_split": plan[1]} if plan
                     else {"route": "walk"}),
            **({"fault_margins": margins} if margins else {}),
            "ms": bench([lambda c=c: ops.paged_int8_attention(q, *c, pt, lengths)
                         for c in pools]),
            "plain_ms": bench([lambda c=c: ops.paged_int8_attention_ref(q, *c, pt, lengths)
                               for c in pools], iters=5),
            "bound_ms": bnd, "bound_by": kind,
            "library_ms": bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, enable_gqa=group > 1) for k, v in deq])})
        del pools, deq
    return cases


KIVI_G = 64  # the KIVI chunk (INT4_KV_GROUP) at the 7B slice
# kv_dtype -> (decode writer, attention) kernel bodies of the tier
KIVI_KERNELS = {"k4v8": ("k4v8_decode_update", "k4v8_attention"),
                "int4": ("kivi4_decode_update", "int4_kv_attention")}
# the KIVI updates: one kernel, counted by route ("decode" at T = 1,
# "prefill" above; ops.ROUTED)
KIVI_WRITERS = tuple(w for w, _ in KIVI_KERNELS.values())


def _kivi_cache(gen, dev, tier, B, KV, S, Dh, G=KIVI_G):
    """Random KIVI cache tensors (kq, kchs, vq, vs, ktail, kts, vtail, vts):
    every packed byte and tail code drawn, scales positive."""
    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def sc(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) + 0.5) * 0.02

    v = (i8(B, KV, S // 2, Dh), sc(B, KV, 2, S // 2)) if tier == "int4" else (
        i8(B, KV, S, Dh).clamp_(-127, 127), sc(B, KV, S))
    return [i8(B, KV, S // 2, Dh), sc(B, KV, S // G, Dh), *v,
            i8(B, KV, 2 * G, Dh).clamp_(-127, 127), sc(B, KV, 2 * G),
            i8(B, KV, 2 * G, Dh).clamp_(-127, 127), sc(B, KV, 2 * G)]


def _mirror_v(cache, new_lengths, G=KIVI_G):
    """K4V8: the V tail rows of positions [F, F + 2G) below S (F the
    frontier of ``new_lengths``) copied from vq/vs, as the cache's writes
    keep its mirror; the kernel reads V there, the plain version from vq."""
    vq, vs, vt, vts = cache[2], cache[3], cache[6], cache[7]
    B, S = vq.shape[0], vq.shape[2]
    F = (new_lengths.long().clamp(0, S) // G) * G
    pos = F[:, None] + torch.arange(2 * G, device=vq.device)
    keep, p = pos < S, pos.clamp_max(S - 1)
    b, rows = torch.arange(B, device=vq.device)[:, None], pos % (2 * G)
    vt[b, :, rows] = torch.where(keep[..., None, None], vq[b, :, p], vt[b, :, rows])
    vts[b, :, rows] = torch.where(keep[..., None], vs[b, :, p], vts[b, :, rows])
    return cache


def kivi_update_bytes(tier, lens, advs, T, KV, S, Dh, G=KIVI_G) -> int:
    """Least bytes of one KIVI update: lengths and adv; per (b, kv head) the
    new rows read once; the tail rows written (decode: the one row below S;
    prefill: the latest min(T, 2G), past S too) and K4V8's V rows below S;
    per flushed chunk and side (K, and V for Int4) the old tail rows it
    reads (decode: G - 1; prefill's first chunk: those below L), the packed
    rows and the scales it writes."""
    row, sides = Dh + 4, 2 if tier == "int4" else 1
    total = 8 * len(lens) + len(lens) * KV * 2 * T * row
    for ln, ad in zip(lens, advs):
        L = max(ln, 0)
        if T == 1:
            writes = (2 if tier == "int4" else 3) if L < S else 0
            nf = int((L // G + 1) * G <= min(max(ln + ad, 0), S))
            old = G - 1
        else:
            writes = 2 * min(T, 2 * G) + (0 if tier == "int4" else max(0, min(T, S - L)))
            nf = max(0, min(min(L + ad, S) // G - L // G, (G - 1 + T) // G))
            old = L - L // G * G
        total += KV * row * writes
        if nf:
            total += KV * sides * old * row
        total += nf * KV * (sides * G // 2 * Dh + 4 * Dh + (4 * G if sides == 2 else 0))
    return total


# phase 3's KIVI update cases: (label, KV, S, Dh, T, lengths, adv, rows
# that must flush); decode at 7B first (the kernels line's row), then the
# prefill route's chunks of 256 (the 7B engine's and GPT-OSS's prefill_chunk)
KIVI_UPDATE_CASES = (
    ("decode", HEADS, 1024, HEAD_DIM, 1, [62, 63, 64, 1023, 1024, 127], [1, 1, 1, 1, 1, 0],
     [False, True, False, True, False, False]),
    ("decode", GO_KV, 2048, GO_HEAD_DIM, 1, [63, 2047, 2048, 1000], [1, 1, 1, 1],
     [True, True, False, False]),
    ("decode insert-only", HEADS, 1024, HEAD_DIM, 1, [62, 700, 1022, 254], [1, 1, 1, 1],
     [False] * 4),
    ("decode insert-only", GO_KV, 2048, GO_HEAD_DIM, 1, [62, 700, 1022, 254], [1, 1, 1, 1],
     [False] * 4),
    ("prefill", HEADS, 1024, HEAD_DIM, 256, [0] * 4, [256] * 4, [True] * 4),
    ("prefill", HEADS, 1024, HEAD_DIM, 256, [300] * 4, [256] * 4, [True] * 4),
    ("prefill", GO_KV, 2048, GO_HEAD_DIM, 256, [0, 300, 1900, 1000], [256, 256, 256, 100],
     [True, True, True, True]))


def check_kivi_update(ops, gen, dev, tier):
    """The tier's update against its plain version, all eight tensors
    exact, on both routes. Decode (T = 1) at Llama-2-7B's cache shape (S =
    1024) and GPT-OSS-20B's (B = 4, KV = 8, Dh = 64, S = 2048 as in phase
    25): rows that flush no chunk, rows that flush chunk 0 and the last
    chunk, a row at capacity (nothing written) and, at 7B, a row with adv =
    0 (inserts, never flushes); an insert-only step (no row flushes) at
    both shapes.
    Prefill (T = 256, a chunk of the engine's): at 7B, B = 4, from length 0
    and from 300 (whose first chunk reads old tail rows that its later new
    rows land on), and at GPT-OSS's shape, a row past S and a padded one.
    Each case on its route (``ops.route_counts``). Library: none."""
    name = KIVI_KERNELS[tier][0]
    writer, plain = getattr(ops, name), getattr(ops, name + "_ref")
    G = KIVI_G
    cases = []
    for label, KV, S, Dh, T, lens, advs, want in KIVI_UPDATE_CASES:
        B = len(lens)
        route = "decode" if T == 1 else "prefill"
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        adv = torch.tensor(advs, dtype=torch.int32, device=dev)
        # the new rows as the cache hands them over: [B, T, KV, ...] seen as
        # [B, KV, T, ...]
        k8 = torch.randint(-127, 128, (B, T, KV, Dh), generator=gen, device=dev,
                           dtype=torch.int8)
        v8 = torch.randint_like(k8, -127, 128)
        ksn = torch.rand(B, T, KV, generator=gen, device=dev) * 0.02 + 1e-3
        vsn = torch.rand(B, T, KV, generator=gen, device=dev) * 0.02 + 1e-3
        new = (lengths, *(t.transpose(1, 2) for t in (k8, ksn, v8, vsn)))
        base = _kivi_cache(gen, dev, tier, B, KV, S, Dh)
        a = [t.clone() for t in base]
        b = [t.clone() for t in base]
        before = ops.route_counts()[f"{name}_{route}"]
        writer(*a, *new, group=G, adv=adv)
        if ops.route_counts()[f"{name}_{route}"] != before + 1:
            raise AssertionError(f"{name} {label}: not on route {route}")
        plain(*b, *new, group=G, adv=adv)
        torch.cuda.synchronize()
        names = ("kq", "kchs", "vq", "vs", "ktail", "kts", "vtail", "vts")
        bad = [n for n, x, y in zip(names, a, b) if not torch.equal(x, y)]
        if bad:
            raise AssertionError(f"{name} {label} differs from its plain version "
                                 f"in {bad} at KV={KV} S={S} Dh={Dh} T={T}")
        flushed = [bool((a[0][r] != base[0][r]).any() or (a[1][r] != base[1][r]).any())
                   for r in range(B)]
        if flushed != want:
            raise AssertionError(f"{name} {label}: rows flushed {flushed}, want {want} "
                                 f"at S={S}")
        if S in lens and T == 1:
            full = lens.index(S)
            if not all(torch.equal(x[full], y[full]) for x, y in zip(a, base)):
                raise AssertionError(f"{name} wrote into a slot at capacity")
        bnd, kind = bound_ms(kivi_update_bytes(tier, lens, advs, T, KV, S, Dh), 0,
                             INT8_OPS_PER_S)
        cases.append({
            "shape": f"{label} B={B} KV={KV} S={S} Dh={Dh} G={G} T={T} lengths={lens} "
                     f"adv={advs}",
            "route": route, "max_abs_err": 0.0,
            "ms": bench([lambda: writer(*a, *new, group=G, adv=adv)]),
            # the prefill route's plain version synchronises (boolean masks)
            "plain_ms": (bench if T == 1 else bench_synced)(
                [lambda: plain(*b, *new, group=G, adv=adv)], iters=5),
            "bound_ms": bnd, "bound_by": kind, "library_ms": None})
        del base, a, b
    return cases


def kivi_attention_bytes(tier, lengths, new_lengths, B, KV, T, H, Dh, G=KIVI_G, S=1024,
                         window=0):
    """Least bytes of one KIVI attention call: per (b, kv head) the packed
    keys below the frontier that the step's rows see (K nibbles and the
    chunk scales they touch, V int8 or nibbles with their scales), the live
    tail rows they see (positions from the frontier to the last query's),
    q and out in bf16. With a window, only keys inside some row's window."""
    total = 2 * 2 * B * T * H * Dh + 8 * B
    v_row = Dh + 4 if tier == "k4v8" else Dh // 2 + 4
    for ln, nl in zip(lengths, new_lengths):
        front = (min(nl, S) // G) * G
        lo, hi = max(0, ln - window + 1) if window else 0, min(S, ln + T)
        top = min(front, hi)  # packed keys seen: [lo, top)
        packed = max(0, top - lo)
        chunks = -(-top // G) - lo // G if packed else 0
        live = max(0, hi - max(front, lo))
        total += KV * (packed * (Dh // 2 + v_row) + chunks * 4 * Dh + live * 2 * (Dh + 4))
    return total


def split_dropped(q, cache, lengths, new_lengths, tier):
    """A planted fault: the plain split formulation
    (``kivi_attention_partials_ref``, merged) with each row's last live
    packed split dropped, as a kernel that lost a split would compute."""
    from protoquant_tpu_torch.ops.attention import (kivi_attention_partials_ref, kivi_split_plan,
                                                    merge_partials_ref)

    B, T, H, Dh = q.shape
    KV, S = cache[0].shape[1], 2 * cache[0].shape[2]
    span, _ = kivi_split_plan(T, H, KV, S, Dh, KIVI_G)
    acc, m, l = kivi_attention_partials_ref(q, *cache, lengths, new_lengths, group=KIVI_G,
                                            v4=tier == "int4", span=span)
    l_drop = torch.cat([_last_live_dropped(l[:, :, :-1]), l[:, :, -1:]], dim=2)
    return merge_partials_ref(acc, m, l_drop, q.shape[2], dtype=q.dtype)


def _last_live_dropped(l):
    """The denominators l [B, KV, n_split, R] with each row's last live split
    emptied (l = 0: the merge then reads nothing of it)."""
    idx = torch.arange(l.shape[2], device=l.device)[None, None, :, None]
    last = torch.where(l > 0, idx, -1).amax(dim=2, keepdim=True)
    return torch.where(idx == last, 0.0, l)


def dense_split_dropped(q, cache, lengths, v4=False, **variants):
    """A planted fault: the plain split spelling of the int8 (or, with
    ``v4``, K8V4) attention (``dense_attention_partials_ref``, merged) with
    each row's last live split dropped, as a kernel that lost a split would
    compute."""
    from protoquant_tpu_torch.ops.attention import (attn_split_plan,
                                                    dense_attention_partials_ref,
                                                    merge_partials_ref)

    B, T, H, Dh = q.shape
    KV, S = cache[0].shape[1], cache[0].shape[2]
    span, _ = attn_split_plan(T, H, KV, S, Dh)
    sink = variants.pop("sink_logits", None)
    acc, m, l = dense_attention_partials_ref(q, *cache, lengths, v4=v4, span=span, **variants)
    return merge_partials_ref(acc, m, _last_live_dropped(l), H, sink, dtype=q.dtype)


# the KIVI prefill kernel against its bf16-lane spelling
# (kivi_attention_tiles_ref): the two differ by f32 sums in another order and
# the bf16 output's last bit (2^-7 of it); mass: sum_c |p v| / l, the plain
# version over |v|
TILES_ULP, TILES_SHARE = 2.0**-7, 2.0**-16


def kivi_tiles_check(name, label, tier, q, cache, lengths, new_lengths, out, **kw):
    """The KIVI prefill kernel's output ``out`` against its bf16-lane
    spelling: returns the largest error over the tolerance TILES_ULP
    |spelling| + TILES_SHARE mass + 1e-6, which must be at most 1."""
    from protoquant_tpu_torch.ops.attention import (int8_kv_attention_ref, kivi_attention_tiles_ref,
                                                    kivi_dequant_k, kivi_dequant_v4)

    G = kw["group"]
    tiles = kivi_attention_tiles_ref(q, *cache, lengths, new_lengths, v4=tier == "int4",
                                     **kw).float()
    kq, kchs, vq, vs, kt, kts, vt, vts = cache
    k = kivi_dequant_k(kq, kchs, kt, kts, new_lengths, G)
    v = (kivi_dequant_v4(vq, vs, vt, vts, new_lengths, G) if tier == "int4"
         else vq.float() * vs[..., None])
    ones = torch.ones(k.shape[:3], device=k.device)
    variants = {key: val for key, val in kw.items() if key != "group"}
    mass = int8_kv_attention_ref(q.float(), k, ones, v.abs(), ones, lengths, **variants)
    del k, v
    tight = TILES_ULP * tiles.abs() + TILES_SHARE * mass + 1e-6
    over = ((out.float() - tiles).abs() / tight).max().item()
    if not over <= 1.0:
        raise AssertionError(f"{name} {label}: {over} times the tolerance from its bf16-lane "
                             "spelling")
    return over


def kivi_prefill_fault(tier, q, cache, lengths, new_lengths, **kw):
    """A planted fault on the KIVI prefill route, spelled by
    kivi_attention_tiles_ref: every tail column read one row off (K, V and
    their scales of its position's neighbour). (A K-side fault of the packed
    tiles, the next chunk's scale row, moves these nearly flat softmaxes of
    random q by less than ATTN_TOL; tests/test_torch_kivi_prefill.py holds it
    at a tighter tolerance.)"""
    from protoquant_tpu_torch.ops.attention import kivi_attention_tiles_ref

    roll = lambda x: torch.roll(x, -1, dims=2)
    kq, kchs, vq, vs, kt, kts, vt, vts = cache
    return {"tail position one off": kivi_attention_tiles_ref(
        q, kq, kchs, vq, vs, roll(kt), roll(kts), roll(vt), roll(vts), lengths, new_lengths,
        v4=tier == "int4", **kw)}


def check_kivi_attention(ops, gen, dev, tier):
    """The tier's attention against its plain version within ATTN_TOL:
    decode at lengths 63 / 700 / 1023 / 255 (63's step completes chunk 0),
    a prefill chunk of 256 from 300 (crossing chunk boundaries 320 to 512),
    and decode at lengths 255 / 256 / 511 / 1023, on and beside the split
    design's boundaries (128 keys a split at Dh 128). Two calls on the same inputs
    must give the same bits. Planted fault in the split case: the plain
    split formulation with each row's last live packed split dropped must
    miss the tolerance; in the prefill case (the prefill kernel, held also
    to its bf16-lane spelling by kivi_tiles_check) kivi_prefill_fault's.
    Library: SDPA over the cache dequantized to bf16 (the plain version's
    f32 dequant, rounded)."""
    import torch.nn.functional as F

    from protoquant_tpu_torch.ops.attention import kivi_dequant_k, kivi_dequant_v4

    name = KIVI_KERNELS[tier][1]
    attn, plain = getattr(ops, name), getattr(ops, name + "_ref")
    S, KV, H, Dh, G = 1024, HEADS, HEADS, HEAD_DIM, KIVI_G
    cases = []
    for label, B, T, lens in (("decode", 4, 1, [63, 700, 1023, 255]),
                              ("prefill", 1, 256, [300]),
                              ("decode split boundaries", 4, 1, [255, 256, 511, 1023])):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        new_lengths = lengths + T
        per_copy = B * KV * S * (2 * Dh if tier == "k4v8" else Dh) // 2
        caches = [_kivi_cache(gen, dev, tier, B, KV, S, Dh) for _ in range(copies_for(per_copy))]
        if tier == "k4v8":
            caches = [_mirror_v(c, new_lengths) for c in caches]
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        kw = {"group": G}
        out = routed_call(ops, name, label, lambda: attn(q, *caches[0], lengths, new_lengths,
                                                         **kw))
        ref = plain(q, *caches[0], lengths, new_lengths, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
        if not torch.equal(attn(q, *caches[0], lengths, new_lengths, **kw), out):
            raise AssertionError(f"{name} {label}: two calls on the same inputs differ")
        margins, tiles = {}, None
        if label.startswith("decode split"):
            margins = _margins(name, label, out, tol, {"last live packed split dropped":
                               split_dropped(q, caches[0], lengths, new_lengths, tier)})
        if label == "prefill":
            tiles = kivi_tiles_check(name, label, tier, q, caches[0], lengths, new_lengths, out,
                                     **kw)
            margins = _margins(name, label, out, tol, kivi_prefill_fault(
                tier, q, caches[0], lengths, new_lengths, **kw))
        t_idx = torch.arange(T, device=dev)
        valid = (lengths.long()[:, None] + t_idx[None, :] + 1).clamp_max(S)
        nbytes = kivi_attention_bytes(tier, lens, new_lengths.tolist(), B, KV, T, H, Dh)
        bnd, kind = bound_ms(nbytes, 4 * Dh * H * valid.sum().item(), BF16_FLOPS_PER_S)
        pos = torch.arange(S, device=dev)
        mask = (pos[None, None, :] <= (lengths.long()[:, None] + t_idx)[:, :, None])[:, None]
        deq = []
        for kq, kchs, vq, vs, kt, kts, vt, vts in caches[:copies_for(B * KV * S * Dh * 4)]:
            k = kivi_dequant_k(kq, kchs, kt, kts, new_lengths, G)
            v = (vq.float() * vs[..., None] if tier == "k4v8"
                 else kivi_dequant_v4(vq, vs, vt, vts, new_lengths, G))
            deq.append((k.to(torch.bfloat16), v.to(torch.bfloat16)))
        qh = q.transpose(1, 2)
        cases.append({
            "shape": f"{label} B={B} T={T} H={H} S={S} G={G} lengths={lens}",
            "max_abs_err": err, "fault_margins": margins, "tiles_err_over_tol": tiles,
            "ms": bench([lambda c=c: attn(q, *c, lengths, new_lengths, **kw) for c in caches]),
            "plain_ms": bench([lambda c=c: plain(q, *c, lengths, new_lengths, **kw)
                               for c in caches], iters=5),
            "bound_ms": bnd, "bound_by": kind,
            "library_ms": bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask) for k, v in deq])})
        del caches, deq
    d = cases[0]
    log(f"kernel {name}: 7B decode {d['ms']:.4f} ms against SDPA's {d['library_ms']:.4f} ms "
        f"on the dequantized bf16 cache ({d['ms'] / d['library_ms']:.4f} of it, a reading)")
    return cases


def _mixed_cache(gen, dev, B, KV, S, Dh):
    """Random K8V4 cache tensors (kq, ks, vq, vs): int8 K, every packed V
    byte drawn, scales positive."""
    kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=gen, device=dev, dtype=torch.int8)
    vq = torch.randint(-128, 128, (B, KV, S // 2, Dh), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = (torch.rand(B, KV, S, generator=gen, device=dev) + 0.5) * 0.02
    vs = (torch.rand(B, KV, 2, S // 2, generator=gen, device=dev) + 0.5) * 0.02
    return kq, ks, vq, vs


def check_mixed_scatter(ops, gen, dev):
    """The K8V4 decode writer against its plain version, all four tensors
    exact: rows at 63, 1023 and 255 (high nibbles), 700 (low) and 1024 (at
    capacity: nothing written). Library: none."""
    B, KV, S, Dh = 5, HEADS, 1024, HEAD_DIM
    lens = [63, 700, 1023, 255, S]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    k8 = torch.randint(-127, 128, (B, KV, 1, Dh), generator=gen, device=dev, dtype=torch.int8)
    v4 = torch.randint(-7, 8, (B, KV, 1, Dh), generator=gen, device=dev, dtype=torch.int8)
    ksn = torch.rand(B, KV, 1, generator=gen, device=dev)
    vsn = torch.rand(B, KV, 1, generator=gen, device=dev)
    base = _mixed_cache(gen, dev, B, KV, S, Dh)
    a = [t.clone() for t in base]
    b = [t.clone() for t in base]
    new = (lengths, k8, ksn, v4, vsn)
    ops.kv_mixed_scatter_decode(*a, *new)
    ops.kv_mixed_scatter_decode_ref(*b, *new)
    torch.cuda.synchronize()
    bad = [n for n, x, y in zip(("kq", "ks", "vq", "vs"), a, b) if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"kv_mixed_scatter_decode differs from its plain version in {bad}")
    if not all(torch.equal(x[4], y[4]) for x, y in zip(a, base)):
        raise AssertionError("kv_mixed_scatter_decode wrote into a slot at capacity")
    # bytes: the new rows and lengths in; per row below S, K row and scale
    # written, the V byte row read and written, the V scale written
    live = sum(ln < S for ln in lens)
    nbytes = 4 * B + B * KV * (2 * Dh + 8) + live * KV * (3 * Dh + 8)
    bnd, kind = bound_ms(nbytes, 0, INT8_OPS_PER_S)
    return [{
        "shape": f"B={B} KV={KV} S={S} Dh={Dh} lengths={lens}", "max_abs_err": 0.0,
        "ms": bench([lambda: ops.kv_mixed_scatter_decode(*a, *new)]),
        "plain_ms": bench([lambda: ops.kv_mixed_scatter_decode_ref(*b, *new)]),
        "bound_ms": bnd, "bound_by": kind, "library_ms": None}]


def mixed_attention_bytes(lengths, B, KV, T, H, Dh, S=1024):
    """Least bytes of one K8V4 attention call: per (b, kv head) the keys
    the step reads (int8 K and its scale, the packed V byte rows and the V
    scales), q and out in bf16, the lengths."""
    total = 2 * 2 * B * T * H * Dh + 4 * B
    for ln in lengths:
        ctx = min(S, ln + T)
        total += KV * (ctx * (Dh + 8) + -(-ctx // 2) * Dh)
    return total


def check_mixed_attention(ops, gen, dev):
    """The K8V4 attention against its plain version within ATTN_TOL: decode
    at lengths 63 / 700 / 1023 / 255 and a prefill chunk of 256 from 300,
    then the decode again with a score scale of 0.1 (its only variant).
    Two calls on the same inputs must give the same bits. Planted faults,
    which must miss: in the decode cases the plain split spelling with each
    row's last live split dropped, in the scaled one the plain version
    without its scale. Library: SDPA over the cache dequantized to bf16 (V
    unpacked)."""
    import torch.nn.functional as F

    from protoquant_tpu_torch.ops.attention import unpack_v4

    S, KV, H, Dh = 1024, HEADS, HEADS, HEAD_DIM
    cases = []
    for label, B, T, lens, scale in (("decode", 4, 1, [63, 700, 1023, 255], 0.0),
                                     ("prefill", 1, 256, [300], 0.0),
                                     ("decode scale=0.1", 4, 1, [63, 700, 1023, 255], 0.1)):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = [_mixed_cache(gen, dev, B, KV, S, Dh)
                  for _ in range(copies_for(B * KV * S * (3 * Dh // 2 + 8)))]
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        kw = {"scale": scale}
        out = routed_call(ops, "mixed_kv_attention", label,
                          lambda: ops.mixed_kv_attention(q, *caches[0], lengths, **kw))
        ref = ops.mixed_kv_attention_ref(q, *caches[0], lengths, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"mixed_kv_attention {label}: max abs err {err} > {tol}")
        if not torch.equal(ops.mixed_kv_attention(q, *caches[0], lengths, **kw), out):
            raise AssertionError(f"mixed_kv_attention {label}: two calls on the same inputs "
                                 "differ")
        faults = {}
        if scale:  # planted fault: the plain version without the scale must miss
            faults["scale ignored"] = ops.mixed_kv_attention_ref(q, *caches[0], lengths)
        if label.startswith("decode"):
            faults["last live split dropped"] = dense_split_dropped(q, caches[0], lengths,
                                                                    v4=True, **kw)
        faults = _margins("mixed_kv_attention", label, out, tol, faults)
        t_idx = torch.arange(T, device=dev)
        valid = (lengths.long()[:, None] + t_idx[None, :] + 1).clamp_max(S)
        bnd, kind = bound_ms(mixed_attention_bytes(lens, B, KV, T, H, Dh),
                             4 * Dh * H * valid.sum().item(), BF16_FLOPS_PER_S)
        pos = torch.arange(S, device=dev)
        mask = (pos[None, None, :] <= (lengths.long()[:, None] + t_idx)[:, :, None])[:, None]
        deq = []
        for kq, ks, vq, vs in caches[:copies_for(B * KV * S * Dh * 4)]:
            nib, vsc = unpack_v4(vq, vs)
            deq.append(((kq.float() * ks[..., None]).to(torch.bfloat16),
                        (nib.float() * vsc[..., None]).to(torch.bfloat16)))
        qh = q.transpose(1, 2)
        cases.append({
            "shape": f"{label} B={B} T={T} H={H} S={S} lengths={lens}",
            "max_abs_err": err, **({"fault_margins": faults} if faults else {}),
            "ms": bench([lambda c=c: ops.mixed_kv_attention(q, *c, lengths, **kw)
                         for c in caches]),
            "plain_ms": bench([lambda c=c: ops.mixed_kv_attention_ref(q, *c, lengths, **kw)
                               for c in caches], iters=5),
            "bound_ms": bnd, "bound_by": kind,
            "library_ms": bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, scale=scale or None) for k, v in deq])})
        del caches, deq
    return cases


def gemma2_attention_cases():
    """(label, B, T, lengths, variants) of the attention checks at Gemma-2-9B's
    shapes: ragged decode of a sliding layer (window, scale, softcap) and of
    a global one (scale, softcap); decode at equal lengths with and without
    the window (scale alone, so that SDPA computes the same function); and
    a prefill chunk of a sliding layer whose rows' windows start in 16
    different tiles."""
    sliding = {"window": G2_WINDOW, "scale": G2_SCALE, "softcap": G2_SOFTCAP}
    ragged, equal = [63, 4500, G2_SEQ - 1, 1000], [G2_SEQ - 192] * 4
    return (("gemma2 decode sliding", 4, 1, ragged, sliding),
            ("gemma2 decode global", 4, 1, ragged, {"scale": G2_SCALE, "softcap": G2_SOFTCAP}),
            ("gemma2 decode window", 4, 1, equal, {"window": G2_WINDOW, "scale": G2_SCALE}),
            ("gemma2 decode full", 4, 1, equal, {"scale": G2_SCALE}),
            ("gemma2 prefill sliding", 1, 512, [4500], sliding))


def visible_keys(lens, T, S, window=0):
    """Per (b, t), the number of keys the query row sees; per b, the span
    [lo, hi) of the keys that some row of the step sees."""
    counts, spans = [], []
    for ln in lens:
        for t in range(T):
            p = ln + t
            counts.append(max(0, min(p + 1, S) - (max(0, p - window + 1) if window else 0)))
        spans.append((max(0, ln - window + 1) if window else 0, min(S, ln + T)))
    return counts, spans


# In the softcap cases of phase 3 the largest score is this many times the
# cap: a tenth of the keys or so then sit near the cap, so no single key
# takes all of a row's softmax and a window that admits other keys shows.
CAP_REACH = 8.0


def check_gemma2_attention(ops, gen, dev, kv_dtype):
    """The attention of the ``kv_dtype`` cache with its variants at
    Gemma-2-9B's shapes (S = 8192, KIVI G = 64) against its plain version
    within ATTN_TOL, over gemma2_attention_cases(). In a softcap case q is
    scaled so that the largest score a row sees is CAP_REACH times the cap.
    Planted
    faults: the plain version without the case's window, and without its
    softcap, must both miss the tolerance (the margins are printed; at
    random weights the model's scores stay far below the cap, so phase 18
    cannot show a softcap fault). The bound counts the keys inside the
    rows' windows only. Library: SDPA with the window's mask and ``scale=``
    over the cache dequantized to bf16, none once a softcap is set (no one
    PyTorch call caps scores)."""
    import torch.nn.functional as F

    from protoquant_tpu_torch.ops.attention import kivi_dequant_k, kivi_dequant_v4

    name = CACHE_KERNELS[kv_dtype][1]
    attn, plain = getattr(ops, name), getattr(ops, name + "_ref")
    S, KV, H, Dh, G = G2_SEQ, G2_KV, G2_HEADS, G2_HEAD_DIM, KIVI_G
    cases = []
    for label, B, T, lens, variants in gemma2_attention_cases():
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        new_lengths = lengths + T
        window, softcap = variants.get("window", 0), variants.get("softcap", 0.0)
        if kv_dtype == "int8":
            caches = [_cache(gen, dev, B, KV, S, Dh)
                      for _ in range(copies_for(B * KV * S * (2 * Dh + 8)))]
            extra, kw = (), dict(variants)
        else:
            per_copy = B * KV * S * (2 * Dh if kv_dtype == "k4v8" else Dh) // 2
            caches = [_kivi_cache(gen, dev, kv_dtype, B, KV, S, Dh)
                      for _ in range(copies_for(per_copy))]
            if kv_dtype == "k4v8":
                caches = [_mirror_v(c, new_lengths) for c in caches]
            extra, kw = (new_lengths,), dict(variants, group=G)

        def dequant(c):
            """The cache as f32 K and V [B, KV, S, Dh]."""
            if kv_dtype == "int8":
                kq, ks, vq, vs = c
                return kq.float() * ks[..., None], vq.float() * vs[..., None]
            kq, kchs, vq, vs, kt, kts, vt, vts = c
            v = (vq.float() * vs[..., None] if kv_dtype == "k4v8"
                 else kivi_dequant_v4(vq, vs, vt, vts, new_lengths, G))
            return kivi_dequant_k(kq, kchs, kt, kts, new_lengths, G), v

        qpos = lengths.long()[:, None] + torch.arange(T, device=dev)
        pos = torch.arange(S, device=dev)
        mask = pos <= qpos[..., None]
        if window:
            mask &= pos > qpos[..., None] - window
        mask = mask[:, None]  # [B, 1, T, S]
        sm = variants.get("scale") or Dh**-0.5
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev)
        max_score = None
        if softcap:
            k0 = dequant(caches[0])[0]
            raw = torch.einsum("btkgd,bksd->bkgts", q.reshape(B, T, KV, H // KV, Dh) * sm, k0)
            peak = raw.abs().masked_fill(~mask[:, :, None], 0.0).amax()
            q *= CAP_REACH * softcap / peak
            max_score = CAP_REACH * softcap
            del k0, raw
        q = q.to(torch.bfloat16)
        out = routed_call(ops, name, label, lambda: attn(q, *caches[0], lengths, *extra, **kw))
        ref = plain(q, *caches[0], lengths, *extra, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
        tiles = None
        if kv_dtype in KIVI_KERNELS and "prefill" in label:
            tiles = kivi_tiles_check(name, label, kv_dtype, q, caches[0], lengths, new_lengths,
                                     out, **kw)
        faults = {}
        for fault, key in (("window ignored", "window"), ("softcap ignored", "softcap")):
            if variants.get(key):
                bad = plain(q, *caches[0], lengths, *extra, **dict(kw, **{key: 0}))
                faults[fault] = (out.float() - bad.float()).abs().max().item() / tol
        if any(m <= 1 for m in faults.values()):
            raise AssertionError(f"{name} {label}: the tolerance passes a planted fault "
                                 f"(margins over it {faults})")
        counts, spans = visible_keys(lens, T, S, window)
        if kv_dtype == "int8":
            nbytes = (KV * sum(hi - lo for lo, hi in spans) * (2 * Dh + 8)
                      + 2 * 2 * q.numel() + 4 * B)
        else:
            nbytes = kivi_attention_bytes(kv_dtype, lens, new_lengths.tolist(), B, KV, T, H,
                                          Dh, G, S, window)
        bnd, kind = bound_ms(nbytes, 4 * Dh * H * sum(counts), BF16_FLOPS_PER_S)
        library = None
        if not softcap:
            deq = [tuple(x.to(torch.bfloat16) for x in dequant(c))
                   for c in caches[:copies_for(B * KV * S * Dh * 4)]]
            qh = q.transpose(1, 2)
            library = bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, scale=sm, enable_gqa=True) for k, v in deq])
            del deq
        cases.append({
            "shape": f"{label} B={B} T={T} H={H} KV={KV} Dh={Dh} S={S} lengths={lens} "
                     f"{json.dumps(variants)}",
            "max_abs_err": err, "fault_margins": faults, "max_score": max_score,
            "tiles_err_over_tol": tiles,
            "ms": bench([lambda c=c: attn(q, *c, lengths, *extra, **kw) for c in caches]),
            "plain_ms": bench([lambda c=c: plain(q, *c, lengths, *extra, **kw)
                               for c in caches], iters=5),
            "bound_ms": bnd, "bound_by": kind, "library_ms": library})
        del caches
    by = {c["shape"].split(" B=")[0]: c["ms"] for c in cases}
    ratio = by["gemma2 decode window"] / by["gemma2 decode full"]
    log(f"kernel {name}: decode at equal lengths {G2_SEQ - 192}, window {G2_WINDOW} over full "
        f"causal: {ratio:.4f} of the time")
    if kv_dtype == "int8" and ratio > WINDOW_TIME_SHARE:
        raise AssertionError(f"{name}: windowed decode takes {ratio:.4f} of the full-causal "
                             f"time (> {WINDOW_TIME_SHARE}): the tiles below the window are "
                             "not skipped")
    return cases




def gpt_oss_attention_cases(kv_dtype: str):
    """(label, B, T, lengths, window, sinks?) of the attention checks at
    GPT-OSS-20B's shapes: ragged decode of a sliding layer (window 128) and
    of a global one, a prefill chunk of 512 from 4500 crossing the window,
    all with learned sinks; for the int8 kernel also decode at equal
    lengths of a global layer with sinks and of a full-causal one without,
    to time the instance the global layers take (VAR = 1, which reads the
    sinks) against the one without variants (VAR = 0)."""
    ragged = [63, 4500, GO_SEQ - 1, 1000]
    cases = [("gpt_oss decode sliding", 4, 1, ragged, GO_WINDOW, True),
             ("gpt_oss decode global", 4, 1, ragged, 0, True),
             ("gpt_oss prefill sliding", 1, 512, [4500], GO_WINDOW, True)]
    if kv_dtype == "int8":
        equal = [GO_SEQ - 192] * 4
        cases += [("gpt_oss decode global equal", 4, 1, equal, 0, True),
                  ("gpt_oss decode full equal", 4, 1, equal, 0, False)]
    return cases


def _v_ones(kv_dtype: str, cache):
    """The cache with every value 1 (codes and scales), so that the plain
    attention's output is each row's total probability over the keys."""
    c = list(cache)
    if kv_dtype == "int8":
        c[2], c[3] = torch.ones_like(c[2]), torch.ones_like(c[3])
    else:  # K4V8 reads vq * vs; Int4 its packed nibbles (0x11: 1 and 1) and the tail
        c[2] = torch.full_like(c[2], 1 if kv_dtype == "k4v8" else 0x11)
        c[3], c[6], c[7] = (torch.ones_like(c[3]), torch.ones_like(c[6]),
                            torch.ones_like(c[7]))
    return c


def check_gpt_oss_attention(ops, gen, dev, kv_dtype):
    """The attention of the ``kv_dtype`` cache with learned sinks at
    GPT-OSS-20B's shapes (B = 4, H = 64, KV = 8, Dh = 64, S = 8192, KIVI G =
    64) against its plain version within ATTN_TOL, over
    gpt_oss_attention_cases(). Each head's sink logit is drawn N(0, 1) from
    the run's seed plus ln of the median of the keys the case's rows see, so
    that a sink takes a share of its row's softmax that a kernel dropping it
    would show. Planted faults, which must miss the tolerance: the plain
    version without the sinks, and the sink counted as a key whose value is
    1 in every dim (acc started at 1, not 0). The bound counts the keys
    inside the rows' windows, the sinks' 4 H bytes, q and out. Library:
    none with sinks (no one PyTorch call takes them); SDPA for the
    full-causal case without."""
    import torch.nn.functional as F

    name = CACHE_KERNELS[kv_dtype][1]
    attn, plain = getattr(ops, name), getattr(ops, name + "_ref")
    S, KV, H, Dh, G = GO_SEQ, GO_KV, GO_HEADS, GO_HEAD_DIM, KIVI_G
    cases = []
    for label, B, T, lens, window, with_sinks in gpt_oss_attention_cases(kv_dtype):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        new_lengths = lengths + T
        if kv_dtype == "int8":
            caches = [_cache(gen, dev, B, KV, S, Dh)
                      for _ in range(copies_for(B * KV * S * (2 * Dh + 8)))]
            extra, kw = (), {}
        else:
            per_copy = B * KV * S * (2 * Dh if kv_dtype == "k4v8" else Dh) // 2
            caches = [_kivi_cache(gen, dev, kv_dtype, B, KV, S, Dh)
                      for _ in range(copies_for(per_copy))]
            if kv_dtype == "k4v8":
                caches = [_mirror_v(c, new_lengths) for c in caches]
            extra, kw = (new_lengths,), {"group": G}
        counts, spans = visible_keys(lens, T, S, window)
        kw["window"] = window
        variants = {"window": window}
        if with_sinks:
            offset = math.log(sorted(counts)[len(counts) // 2])
            kw["sink_logits"] = torch.randn(H, generator=gen, device=dev) + offset
            variants["sinks"] = f"N(0, 1) + ln {sorted(counts)[len(counts) // 2]}"
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        out = routed_call(ops, name, label, lambda: attn(q, *caches[0], lengths, *extra, **kw))
        ref = plain(q, *caches[0], lengths, *extra, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
        tiles = None
        if kv_dtype in KIVI_KERNELS and "prefill" in label:
            tiles = kivi_tiles_check(name, label, kv_dtype, q, caches[0], lengths, new_lengths,
                                     out, **kw)
        faults = {}
        if with_sinks:
            dropped = plain(q, *caches[0], lengths, *extra, **dict(kw, sink_logits=None))
            mass = plain(q, *_v_ones(kv_dtype, caches[0]), lengths, *extra, **kw)
            valued = ref.float() + (1.0 - mass.float())  # the sink's share times a value of 1
            faults = {"sinks dropped": (out.float() - dropped.float()).abs().max().item() / tol,
                      "sink counted as a key of value 1":
                          (out.float() - valued).abs().max().item() / tol}
            del dropped, mass, valued
        if any(m <= 1 for m in faults.values()):
            raise AssertionError(f"{name} {label}: the tolerance passes a planted fault "
                                 f"(margins over it {faults})")
        if kv_dtype == "int8":
            nbytes = (KV * sum(hi - lo for lo, hi in spans) * (2 * Dh + 8)
                      + 2 * 2 * q.numel() + 4 * B)
        else:
            nbytes = kivi_attention_bytes(kv_dtype, lens, new_lengths.tolist(), B, KV, T, H,
                                          Dh, G, S, window)
        nbytes += 4 * H if with_sinks else 0
        bnd, kind = bound_ms(nbytes, 4 * Dh * H * sum(counts), BF16_FLOPS_PER_S)
        library = None
        if not with_sinks:
            qpos = lengths.long()[:, None] + torch.arange(T, device=dev)
            mask = (torch.arange(S, device=dev) <= qpos[..., None])[:, None]
            deq = [((c[0].float() * c[1][..., None]).to(torch.bfloat16),
                    (c[2].float() * c[3][..., None]).to(torch.bfloat16))
                   for c in caches[:copies_for(B * KV * S * Dh * 4)]]
            qh = q.transpose(1, 2)
            library = bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, enable_gqa=True) for k, v in deq])
            del deq
        cases.append({
            "shape": f"{label} B={B} T={T} H={H} KV={KV} Dh={Dh} S={S} lengths={lens} "
                     f"{json.dumps(variants)}",
            "max_abs_err": err, "fault_margins": faults, "tiles_err_over_tol": tiles,
            "ms": bench([lambda c=c: attn(q, *c, lengths, *extra, **kw) for c in caches]),
            "plain_ms": bench([lambda c=c: plain(q, *c, lengths, *extra, **kw)
                               for c in caches], iters=5),
            "bound_ms": bnd, "bound_by": kind, "library_ms": library})
        del caches
    if kv_dtype == "int8":
        by = {c["shape"].split(" B=")[0]: c["ms"] for c in cases}
        log(f"kernel {name}: decode at equal lengths {GO_SEQ - 192}, a global layer with "
            f"learned sinks (instance VAR = 1) over full causal without them (VAR = 0): "
            f"{by['gpt_oss decode global equal'] / by['gpt_oss decode full equal']:.4f} of "
            f"the time (a reading)")
    return cases


def ring_capacity(window: int, max_chunk: int, sinks: int = 0) -> int:
    """Columns of a RingInt8KVCache (its init's rounding)."""
    return -(-(sinks + window + max_chunk) // 32) * 32


def _margins(name, label, out, tol, faults):
    """Each planted fault's largest error over ``tol``; every one must miss."""
    got = {f: (out.float() - bad.float()).abs().max().item() / tol for f, bad in faults.items()}
    if any(m <= 1 for m in got.values()):
        raise AssertionError(f"{name} {label}: the tolerance passes a planted fault "
                             f"(margins over it {got})")
    return got


def check_ring_attention(ops, gen, dev):
    """The int8 attention over a ring at Mistral-7B's shapes (B = 4, 32
    heads over 8, Dh = 128, window 4096): decode at lengths 63 / 4607 /
    9000 / 20000 and a prefill chunk of 512 from 63 and 9000, each over the
    ring of 4608 columns (no sinks) and of 4640 (4 sinks). Planted faults:
    the plain version reading the columns as positions, and dropping the
    sinks; both must miss the tolerance. Bound: the bytes of the columns
    some row of the step sees, the positions, q and out. Library: SDPA over
    the ring dequantized to bf16 with a boolean mask from the positions."""
    import torch.nn.functional as F

    from protoquant_tpu_torch.models import ring_positions

    KV, H, Dh, W = M7_KV, HEADS, HEAD_DIM, M7_WINDOW
    cases = []
    for label, B, T, lens in (("ring decode", 4, 1, RING_LENGTHS),
                              ("ring prefill", 2, M7_CHUNK, [63, 9000])):
        for sinks in (0, 4):
            C = ring_capacity(W, M7_CHUNK, sinks)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            k_pos = ring_positions(lengths + T, C, sinks)
            caches = [_cache(gen, dev, B, KV, C, Dh)
                      for _ in range(copies_for(B * KV * C * (2 * Dh + 8)))]
            for c in caches:
                c[1][:, :, :sinks] *= SINK_SCALE
            q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
            kw = dict(window=W, k_positions=k_pos, sinks=sinks)
            out = routed_call(ops, "int8_kv_attention", label,
                              lambda: ops.int8_kv_attention(q, *caches[0], lengths, **kw))
            ref = ops.int8_kv_attention_ref(q, *caches[0], lengths, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = ATTN_TOL * ref.float().abs().max().item()
            name = f"{label}{' sinks' if sinks else ''}"
            if not err <= tol:
                raise AssertionError(f"int8_kv_attention {name}: max abs err {err} > {tol}")
            plain = lambda **wrong: ops.int8_kv_attention_ref(q, *caches[0], lengths,
                                                              **dict(kw, **wrong))
            faults = {"positions read as columns": plain(k_positions=None)}
            if sinks:
                faults["sinks dropped"] = plain(sinks=0)
            margins = _margins("int8_kv_attention", name, out, tol, faults)
            qpos = lengths.long()[:, None] + torch.arange(T, device=dev)
            kp = k_pos.long()[:, None, :]
            vis = ((kp >= 0) & (kp <= qpos[..., None])
                   & ((kp > qpos[..., None] - W) | (kp < sinks)))  # [B, T, C]
            cols = vis.any(1).sum().item()  # columns some row of the step sees
            nbytes = KV * cols * (2 * Dh + 8) + 4 * B * C + 2 * 2 * q.numel() + 4 * B
            bnd, kind = bound_ms(nbytes, 4 * Dh * H * vis.sum().item(), BF16_FLOPS_PER_S)
            deq = [((kq.float() * ks[..., None]).to(torch.bfloat16),
                    (vq.float() * vs[..., None]).to(torch.bfloat16))
                   for kq, ks, vq, vs in caches[:copies_for(B * KV * C * Dh * 4)]]
            qh, mask = q.transpose(1, 2), vis[:, None]
            cases.append({
                "shape": f"{name} B={B} T={T} H={H} KV={KV} Dh={Dh} C={C} window={W} "
                         f"sinks={sinks} lengths={lens}",
                "max_abs_err": err, "fault_margins": margins,
                "ms": bench([lambda c=c: ops.int8_kv_attention(q, *c, lengths, **kw)
                             for c in caches]),
                "plain_ms": bench([lambda c=c: ops.int8_kv_attention_ref(q, *c, lengths, **kw)
                                   for c in caches], iters=5),
                "bound_ms": bnd, "bound_by": kind,
                "library_ms": bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                    qh, k, v, attn_mask=mask, enable_gqa=True) for k, v in deq])})
            del caches, deq
    return cases


# kernel -> the attention of phase 3's ALiBi cases
ALIBI_KERNELS = {"int8": "int8_kv_attention", "paged": "paged_int8_attention",
                 "k4v8": "k4v8_attention", "int4": "int4_kv_attention"}


def check_alibi_attention(ops, gen, dev, kernel):
    """The ``kernel`` attention with ALiBi at BLOOM-560m's shapes (16 heads
    of 64, S = 2048; paged: 128-token pages in a shuffled table; KIVI: G =
    64) against its plain version within ATTN_TOL: decode at lengths 63 /
    700 / 2047 / 1000 and (but paged, decode only) a prefill chunk of 256
    from 700. Planted fault: the plain version without the slopes, which
    must miss. Bound: the visible keys' bytes, q, out and the slopes.
    Library: SDPA with the bias as a bf16 float mask (-inf where masked)
    over the cache dequantized to bf16 (paged: each row's gathered window)."""
    import torch.nn.functional as F

    from protoquant_tpu_torch.models.llama import alibi_slopes
    from protoquant_tpu_torch.ops.attention import kivi_dequant_k, kivi_dequant_v4
    from protoquant_tpu_torch.ops.paged_attention import gather_window

    name = ALIBI_KERNELS[kernel]
    attn, plain = getattr(ops, name), getattr(ops, name + "_ref")
    S, KV, H, Dh, G = BL_SEQ, BL_HEADS, BL_HEADS, BL_HEAD_DIM, KIVI_G
    slopes = alibi_slopes(H).to(dev)
    shapes = [("bloom decode alibi", 4, 1, BL_LENGTHS)]
    if kernel != "paged":
        shapes.append(("bloom prefill alibi", 1, 256, [700]))
    cases = []
    for label, B, T, lens in shapes:
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        new_lengths = lengths + T
        max_pages = S // PAGE
        if kernel == "int8":
            caches = [_cache(gen, dev, B, KV, S, Dh)
                      for _ in range(copies_for(B * KV * S * (2 * Dh + 8)))]
            after = (lengths,)
        elif kernel == "paged":
            P = B * max_pages + 1
            pt = _shuffled_table(gen, B, max_pages, P, dev)
            caches = [_pools(gen, dev, P, KV, PAGE, Dh)
                      for _ in range(copies_for(P * KV * PAGE * (2 * Dh + 8)))]
            after = (pt, lengths)
        else:
            caches = [_kivi_cache(gen, dev, kernel, B, KV, S, Dh)
                      for _ in range(copies_for(B * KV * S * (2 * Dh if kernel == "k4v8"
                                                             else Dh) // 2))]
            if kernel == "k4v8":
                caches = [_mirror_v(c, new_lengths) for c in caches]
            after = (lengths, new_lengths)
        kw = {"group": G} if kernel in KIVI_KERNELS else {}
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(torch.bfloat16)
        call = lambda fn, c, **k: fn(q, *c, *after, **k)
        split_before = ops.route_counts()["paged_int8_attention_split"]
        out = routed_call(ops, name, label,
                          lambda: call(attn, caches[0], alibi_slopes=slopes, **kw))
        ref = call(plain, caches[0], alibi_slopes=slopes, **kw)
        torch.cuda.synchronize()
        if kernel == "paged" and (ops.route_counts()["paged_int8_attention_split"]
                                  != split_before + 1):
            raise AssertionError(f"{name} {label}: not the split kernel")
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
        tiles = None
        if kernel in KIVI_KERNELS and "prefill" in label:
            tiles = kivi_tiles_check(name, label, kernel, q, caches[0], lengths, new_lengths, out,
                                     alibi_slopes=slopes, **kw)
        faults = {"ALiBi dropped": call(plain, caches[0], **kw)}
        if kernel == "paged":
            faults["last live split dropped"] = paged_split_dropped(q, caches[0], pt, lengths,
                                                                    slopes)
        margins = _margins(name, label, out, tol, faults)
        qpos = lengths.long()[:, None] + torch.arange(T, device=dev)
        span = max_pages * PAGE if kernel == "paged" else S
        kpos = torch.arange(span, device=dev)
        valid = kpos <= qpos[..., None]  # [B, T, S]
        if kernel == "int8":
            ctx = (lengths.long() + T).clamp_max(S)
            nbytes = KV * ctx.sum().item() * (2 * Dh + 8) + 2 * 2 * q.numel() + 4 * B + 4 * H
        elif kernel == "paged":
            nbytes = (KV * (lengths.long() + 1).sum().item() * (2 * Dh + 8) + 2 * 2 * q.numel()
                      + 4 * B * (1 + max_pages) + 4 * H)
        else:
            nbytes = kivi_attention_bytes(kernel, lens, new_lengths.tolist(), B, KV, T, H, Dh,
                                          G, S) + 4 * H
        bnd, kind = bound_ms(nbytes, 4 * Dh * H * valid.sum().item(), BF16_FLOPS_PER_S)
        dist = (qpos[..., None] - kpos).float()  # [B, T, S]
        bias = torch.where(valid[:, None], -slopes[None, :, None, None] * dist[:, None],
                           torch.tensor(float("-inf"), device=dev)).to(torch.bfloat16)
        deq = []
        for c in caches[:copies_for(B * KV * span * Dh * 4)]:
            if kernel == "int8":
                kq, ks, vq, vs = c
            elif kernel == "paged":
                kq, ks, vq, vs = gather_window(*c, pt)
            if kernel in ("int8", "paged"):
                k, v = kq.float() * ks[..., None], vq.float() * vs[..., None]
            else:
                kq, kchs, vq, vs, kt, kts, vt, vts = c
                k = kivi_dequant_k(kq, kchs, kt, kts, new_lengths, G)
                v = (vq.float() * vs[..., None] if kernel == "k4v8"
                     else kivi_dequant_v4(vq, vs, vt, vts, new_lengths, G))
            deq.append((k.to(torch.bfloat16), v.to(torch.bfloat16)))
        qh = q.transpose(1, 2)
        cases.append({
            "shape": f"{label} B={B} T={T} H={H} Dh={Dh} S={S}"
                     f"{f' ps={PAGE}' if kernel == 'paged' else ''}"
                     f"{f' G={G}' if kw else ''} lengths={lens}",
            "max_abs_err": err, "fault_margins": margins, "tiles_err_over_tol": tiles,
            "ms": bench([lambda c=c: call(attn, c, alibi_slopes=slopes, **kw) for c in caches]),
            "plain_ms": bench([lambda c=c: call(plain, c, alibi_slopes=slopes, **kw)
                               for c in caches], iters=5),
            "bound_ms": bnd, "bound_by": kind,
            "library_ms": bench([lambda k=k, v=v: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=bias) for k, v in deq])})
        del caches, deq
    return cases


# -- phases 4 to 23: the slices and the agreements ---------------------------


def fused(mode: str) -> bool:
    """Whether ``mode`` takes the producer-fused path as the knobs stand
    (the model's own decision)."""
    from protoquant_tpu_torch.models.llama import producer_fused

    return producer_fused(mode)


# kv_dtype -> (decode writer, attention) kernel bodies of its dense cache
CACHE_KERNELS = {"int8": ("kv_scatter_decode", "int8_kv_attention"),
                 "k8v4": ("kv_mixed_scatter_decode", "mixed_kv_attention"), **KIVI_KERNELS}


def path_kernels(ops, mode: str, kv_dtype: str = "int8") -> tuple:
    """The kernel bodies a decode step of ``mode`` launches: the dense
    cache of ``kv_dtype`` (its writer and attention) for the dynamic modes,
    the paged pool for the weight-only ones (whose prefill chunks also run
    the dense flash kernel); under FUSED_QUANT=on, "dynamic" adds the two
    fused producers."""
    gemm = {"dynamic": "qmatmul", "weight_only": "weight_only_matmul",
            "weight_only_int4": "wo4_split",
            "dynamic_int4": "w4a8_" + ops.resolve_w4a8_formulation()}[mode]
    if mode in ("dynamic", "dynamic_int4"):
        return (("rowquant", gemm, *CACHE_KERNELS[kv_dtype])
                + (("rms_norm_quant", "swiglu_quant") if fused(mode) else ()))
    return (gemm, "paged_kv_scatter_decode", "paged_int8_attention", "int8_kv_attention")


# A path that calls a routed wrapper must have launched the kernel its
# decode steps take, and a dense attention also its prefill kernel: the
# wrapper -> that kernel's route count (ops.ROUTED)
DECODE_ROUTE = {"qmatmul": "qmatmul_decode",
                "paged_int8_attention": "paged_int8_attention_split",
                "qmatmul_reduce_scatter_dma": "qmatmul_reduce_scatter_dma_decode",
                **{name: name + "_split" for name in ROUTED_ATTENTIONS},
                **{name: name + "_decode" for name in ROUTED_GEMMS + KIVI_WRITERS}}
PREFILL_ROUTE = {"qmatmul_reduce_scatter_dma": "qmatmul_reduce_scatter_dma_prefill",
                 **{name: name + "_prefill" for name in ROUTED_ATTENTIONS + KIVI_WRITERS},
                 **{name: name + "_tile" for name in ROUTED_GEMMS}}


def routed(path) -> tuple:
    """``path`` with the decode kernel of each routed wrapper in it and the
    prefill kernel of each dense and KIVI attention, KIVI update and int4
    GEMM (a paged path runs the int8 attention over its gathered window for
    prefill chunks alone)."""
    paged = "paged_int8_attention" in path
    decode = [DECODE_ROUTE[k] for k in path
              if k in DECODE_ROUTE and not (paged and k == "int8_kv_attention")]
    return tuple(path) + tuple(decode) + tuple(PREFILL_ROUTE[k] for k in path
                                               if k in PREFILL_ROUTE)


def path_counts(ops) -> dict:
    """The wrappers' counts and the routed kernels' (ops.route_counts)."""
    return {**ops.launch_counts(), **ops.route_counts()}


def row_route_launches(name: str, widths) -> dict:
    """The launches of ``name`` (rowquant or swiglu_quant) by route
    (ops.ROUTED) for one decode call at each width of ``widths``, as the row
    plan routes them (a decode step's rows, at most 64, all take one
    plan)."""
    counts = {f"{name}_cluster": 0, f"{name}_rows": 0}
    for k in widths:
        counts[f"{name}_{row_plan_of(4, k).route}"] += 1
    return counts


def rowquant_widths(cfg) -> list:
    """The width of each rowquant of one unfused decode step of ``cfg``:
    per layer the input of q/k/v (hidden), of o_proj (heads x head_dim), of
    the MLP or the experts (hidden) and of down_proj or the experts' second
    product (intermediate); then lm_head's (hidden)."""
    L = cfg.num_hidden_layers
    return ([cfg.hidden_size] * (2 * L + 1) + [cfg.num_attention_heads * cfg.head_dim] * L
            + [cfg.intermediate_size] * L)


def decode_step_launches(ops, mode: str, cfg, kv_dtype: str = "int8") -> dict:
    """Exact launches of one decode step of ``cfg``: every kernel body of
    ops.KERNELS, 0 for those off the path, and each route of the row
    kernels. The fused path quantizes only o_proj's and lm_head's inputs by
    rowquant: the norms and the gate emit the rest."""
    layers = cfg.num_hidden_layers
    per_step = dict.fromkeys(ops.KERNELS, 0)
    kernels = path_kernels(ops, mode, kv_dtype)
    if fused(mode):
        per_step.update({"rowquant": layers + 1, "rms_norm_quant": 2 * layers,
                         "swiglu_quant": layers, kernels[1]: 7 * layers + 1,
                         kernels[2]: layers, kernels[3]: layers})
        per_step.update(row_route_launches(
            "rowquant", [cfg.num_attention_heads * cfg.head_dim] * layers + [cfg.hidden_size]))
        per_step.update(row_route_launches("swiglu_quant", [cfg.intermediate_size] * layers))
    elif mode in ("dynamic", "dynamic_int4"):
        per_step.update({"rowquant": 4 * layers + 1, kernels[1]: 7 * layers + 1,
                         kernels[2]: layers, kernels[3]: layers})
        per_step.update(row_route_launches("rowquant", rowquant_widths(cfg)))
    else:
        per_step.update({kernels[0]: 7 * layers + 1, "paged_kv_scatter_decode": layers,
                         "paged_int8_attention": layers})
    gemm = kernels[1] if kernels[0] == "rowquant" else kernels[0]
    if gemm in ROUTED_GEMMS:  # every GEMM of a decode step on its decode kernel
        per_step.update({gemm + "_decode": 7 * layers + 1, gemm + "_tile": 0})
    if kernels[2] in KIVI_WRITERS:  # a KIVI cache's writes on the decode route
        per_step.update({kernels[2] + "_decode": layers, kernels[2] + "_prefill": 0})
    return per_step


def serve(engine, prompts, ops, per_step, first_alone: bool = False,
          per_prefill: dict | None = None):
    """Serve ``prompts`` to the end, each step timed on the host clock.
    ``first_alone``: request 0 alone until its prefill ends (its prompt is
    then published), then the others. Returns the outputs in request order,
    the step times with and without a prefill chunk, and the decode steps
    whose launches (``path_counts``, over the keys of ``per_step``) differ
    from ``per_step`` (and the steps with a prefill chunk whose launches
    over the keys of ``per_prefill`` differ from it), the chunk boundaries
    that decode writes crossed (a KIVI cache flushes one chunk per
    crossing; 0 for the other caches), and the decode forwards in which
    some write crossed one (a KIVI update's launches that flush)."""
    rids = [engine.add_request(p) for p in (prompts[:1] if first_alone else prompts)]
    prefill_ms, decode_ms, bad_steps = [], [], []
    group = getattr(engine.caches[0], "group", None)
    crossed, flushing = [0], [0]

    def step():
        with_prefill = bool(engine.prefilling) or (
            bool(engine.waiting) and any(r is None for r in engine.slot_req))
        before = path_counts(ops)
        lengths = engine.caches[0].lengths.clone()
        decoding = torch.tensor(engine.active, device=lengths.device)
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t)
        after = path_counts(ops)
        if group:  # slots that decoded this step moved by one position
            now = engine.caches[0].lengths
            crossing = int((decoding & (now == lengths + 1)
                            & (now // group > lengths // group)).sum())
            crossed[0] += crossing
            flushing[0] += crossing > 0
        if with_prefill:
            prefill_ms.append(dt)
            delta = {k: after[k] - before[k] for k in per_prefill or {}}
            if delta != (per_prefill or {}):
                bad_steps.append({"prefill step": delta})
        else:
            decode_ms.append(dt)
            delta = {k: after[k] - before[k] for k in per_step}
            if delta != per_step:
                bad_steps.append(delta)

    if first_alone:
        while engine.prefilling or engine.waiting:
            step()
        rids += [engine.add_request(p) for p in prompts[1:]]
    while engine.has_work():
        step()
    outs = {r.rid: r.out for r in engine.finished}
    return ([outs.get(r) for r in rids], prefill_ms, decode_ms, bad_steps, crossed[0],
            flushing[0])


def _build(preset: str, mode: str, seed: int, dev):
    from protoquant_tpu_torch import LlamaModel, ModelConfig

    cfg = getattr(ModelConfig, preset)()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, mode=mode, dtype=torch.bfloat16, device=dev)
    model.init_random_(seed)
    torch.cuda.synchronize()
    log(f"model: {preset} {mode}, {cfg.num_hidden_layers} layers, built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return cfg, model


# the dense slices' traffic, by preset: (max_seq_len, prefill_chunk, prompt
# lengths of the 6 requests). Gemma-2's longest prompts pass the window by
# more than one 512-key tile, so its sliding layers' decode skips tiles.
SLICES = {"llama2_7b": (1024, 256, [64, 700, 130, 411, 256, 517]),
          "gemma2_9b": (G2_SEQ, 512, [64, 6000, 300, 4700, 1000, 5200])}


def run_slice(ops, seed: int, dev, mode: str = "dynamic", formulation: str | None = None,
              fused_quant: str | None = None, kv_dtype: str = "int8",
              preset: str = "llama2_7b", keep_model: bool = False):
    """Phases 4, 8.1, 8.3, 10, 12, 13, 15 (Llama-2-7B) and 17 (Gemma-2-9B):
    the ``preset`` model in a dynamic mode (int8 or int4 weights) on the
    dense cache of ``kv_dtype``, 6 requests. ``formulation``: the W4A8
    formulation of a dynamic_int4 run; ``fused_quant``: the FUSED_QUANT knob
    (default: each as resolved); ``keep_model``: the model comes back in the
    stats (phase 20 serves phase 17's)."""
    with knob(ops, "W4A8_FORMULATION", formulation), knob(ops, "FUSED_QUANT", fused_quant):
        return _run_slice(ops, seed, dev, mode, kv_dtype, preset, keep_model)


def kv_cache_bytes(caches) -> int:
    """Bytes of every tensor of the caches."""
    return sum(t.numel() * t.element_size() for c in caches for t in vars(c).values()
               if isinstance(t, torch.Tensor))


def expected_cache_bytes(kv_dtype: str, layers: int, B: int, KV: int, S: int, Dh: int,
                         G: int = KIVI_G) -> int:
    """The layout's bytes from its shapes: int8 K/V + per-token scales;
    K8V4's int8 K and packed V, each with per-token scales; the KIVI tiers'
    packed K with chunk-channel scales, their V (int8 per token, or packed
    with parity-split scales) and two 2G-row int8 tails."""
    if kv_dtype == "int8":
        per = 2 * S * Dh + 2 * 4 * S
    elif kv_dtype == "k8v4":
        per = S * Dh + S // 2 * Dh + 2 * 4 * S
    else:
        v = S * Dh + 4 * S if kv_dtype == "k4v8" else S // 2 * Dh + 4 * S
        per = S // 2 * Dh + 4 * (S // G) * Dh + v + 2 * (2 * G * Dh + 4 * 2 * G)
    return layers * (B * KV * per + 4 * B)


def _run_slice(ops, seed: int, dev, mode: str, kv_dtype: str, preset: str,
               keep_model: bool = False):
    from protoquant_tpu_torch import Engine, EngineConfig

    max_seq, chunk, prompt_lens = SLICES[preset]
    cfg, model = _build(preset, mode, seed, dev)
    engine = Engine(model, EngineConfig(max_batch_size=4, max_seq_len=max_seq,
                                        prefill_chunk=chunk, max_new_tokens=32),
                    kv_dtype=kv_dtype)
    cache_bytes = kv_cache_bytes(engine.caches)
    want_bytes = expected_cache_bytes(kv_dtype, cfg.num_hidden_layers, 4,
                                      cfg.num_key_value_heads, max_seq, cfg.head_dim)
    if cache_bytes != want_bytes:
        raise AssertionError(f"{kv_dtype} cache: {cache_bytes} bytes, want {want_bytes}")
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in prompt_lens]

    per_step = decode_step_launches(ops, mode, cfg, kv_dtype)
    # every forward's token rows: a routed int4 GEMM routes by them
    chunks, decodes = forward_rows(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    # a KIVI cache: each prefill chunk's writes on the update's prefill route
    per_prefill = ({CACHE_KERNELS[kv_dtype][0] + "_prefill": cfg.num_hidden_layers}
                   if kv_dtype in KIVI_KERNELS else None)
    outs, prefill_ms, decode_ms, bad_steps, crossed, flushing = serve(
        engine, prompts, ops, per_step, per_prefill=per_prefill)
    wall = time.perf_counter() - t_run
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    gemm = path_kernels(ops, mode, kv_dtype)[1]
    if mode == "dynamic_int4" and gemm in ROUTED_GEMMS:
        want = gemm_routes(gemm, cfg.num_hidden_layers, chunks, decodes)
        got = {route: launches[f"{gemm}_{route}"] for route in want}
        log(f"slice {mode}: {len(chunks)} prefill forwards of {sorted(set(chunks))} rows, "
            f"{len(decodes)} decode forwards; {gemm} launches by route {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"slice {mode}: {gemm} routes {got} != {want}")

    generated = sum(len(o or []) for o in outs)
    path = path_kernels(ops, mode, kv_dtype)
    label = (f"{'' if preset == 'llama2_7b' else preset + ' '}{mode} "
             f"({path[1]}{', fused' if fused(mode) else ''}, {kv_dtype} KV)")
    log(f"slice {label}: {len(prompts)} requests, prompts {prompt_lens}, {generated} tokens "
        f"in {wall:.3f} s = {generated / wall:.1f} tok/s; "
        f"{len(prefill_ms)} steps with a prefill chunk (mean "
        f"{sum(prefill_ms) / max(1, len(prefill_ms)):.3f} ms), {len(decode_ms)} "
        f"decode steps (median "
        f"{sorted(decode_ms)[len(decode_ms) // 2] if decode_ms else 0:.3f} ms, "
        f"min {min(decode_ms, default=0):.3f} ms); peak memory {peak / 2**30:.2f} GiB")
    log(f"slice {label} launches: {json.dumps(launches)}; per decode step "
        f"{json.dumps(per_step)}")
    log(f"slice {label}: KV cache {cache_bytes} bytes = {cache_bytes / 2**20:.1f} MiB "
        f"({cfg.num_hidden_layers} layers, B=4, S={max_seq}); chunk boundaries crossed by "
        f"decode writes: {crossed}, in {flushing} of {len(decode_ms)} decode steps")
    if kv_dtype in KIVI_KERNELS and crossed < 1:
        raise AssertionError(f"slice {label}: no decode step flushed a chunk")
    if any(launches[k] <= 0 for k in routed(path)):
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    if bad_steps or not decode_ms:
        raise AssertionError(f"step launches {bad_steps[:3]} != {per_step} (decode), "
                             f"{per_prefill} (prefill)")
    for p, out in zip(prompts, outs):
        if out is None or len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"request (prompt {len(p)}): bad output {out}")
    stats = {"tokens_per_s": generated / wall, "wall_s": wall,
             "prefill_step_ms": prefill_ms, "decode_step_ms": decode_ms,
             "peak_gib": peak / 2**30, "outputs": outs}
    del engine
    if preset == "llama2_7b":
        profile_decode(model, prompts, kv_dtype=kv_dtype)
    else:  # the first 4 prompts whole, so that the window matters
        profile_decode(model, prompts, max_seq_len=max_seq, prefill_chunk=chunk,
                       ctx=max_seq, kv_dtype=kv_dtype)
    if keep_model:
        stats["model"] = model
    del model
    torch.cuda.empty_cache()
    return launches, stats


def profile_decode(model, prompts, steps: int = 5, max_seq_len: int = 1024,
                   prefill_chunk: int = 256, ctx: int = 200, **engine_kw):
    """Device busy share and time by kernel over ``steps`` decode steps of
    4 slots holding the first 4 prompts cut to ``ctx`` tokens, from
    torch.profiler (after the timed run, so it slows nothing that is
    reported above). ``engine_kw`` go to the Engine."""
    from torch.profiler import ProfilerActivity, profile

    from protoquant_tpu_torch import Engine, EngineConfig

    prompts = [p[:ctx] for p in prompts[:4]]
    # every slot still decoding when the window opens: a slot decodes one
    # token per tick from the end of its prefill
    ticks = sum(-(-len(p) // prefill_chunk) for p in prompts) + steps + 1
    engine = Engine(model, EngineConfig(max_batch_size=4, max_seq_len=max_seq_len,
                                        prefill_chunk=prefill_chunk,
                                        max_new_tokens=max(24, ticks)), **engine_kw)
    for p in prompts:
        engine.add_request(p)
    while engine.prefilling or engine.waiting:
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    try:  # these fields are missing from the event rows of some torch versions
        # kernel rows only: an op row's device time repeats its kernels'
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    except AttributeError as exc:
        log(f"profile: not measured ({exc})")
        return
    busy = sum(e.self_device_time_total for e in rows)
    log(f"profile {engine.kv_layout} ({steps} decode steps, 4 slots, prompts of "
        f"{[len(p) for p in prompts]} tokens): wall "
        f"{wall_us / steps:.1f} us/step, device busy {busy / steps:.1f} us/step, "
        f"idle share {1 - busy / wall_us:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"  profile kernel {e.key[:60]!r}: {e.self_device_time_total / steps:.1f} "
            f"us/step over {e.count // steps} launches/step")


SYSTEM_TOKENS = 512
SUFFIXES = (40, 300, 7, 130, 220, 65, 410, 90)


def run_paged_slice(ops, seed: int, dev, mode: str = "weight_only"):
    """Phases 6 and 8.2: Llama-2-7B in a weight-only mode (int8 or int4
    weights) over the paged pool with prefix caching, 8 requests sharing
    one system prompt."""
    from protoquant_tpu_torch import Engine, EngineConfig

    cfg, model = _build("llama2_7b", mode, seed, dev)
    gen = torch.Generator().manual_seed(seed + 2)
    system = torch.randint(1, cfg.vocab_size, (SYSTEM_TOKENS,), generator=gen).tolist()
    prompts = [system + torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in SUFFIXES]

    def engine(prefix_cache):
        return Engine(model, EngineConfig(
            max_batch_size=4, max_seq_len=1024, page_size=PAGE, prefill_chunk=256,
            max_new_tokens=32, prefix_cache=prefix_cache), kv_layout="paged")

    per_step = decode_step_launches(ops, mode, cfg)
    eng = engine(True)
    # every forward's token rows: the GEMM routes by them
    chunks, decodes = forward_rows(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    outs, prefill_ms, decode_ms, bad_steps, *_ = serve(eng, prompts, ops, per_step,
                                                      first_alone=True)
    wall = time.perf_counter() - t_run
    launches = path_counts(ops)
    gemm = path_kernels(ops, mode)[0]
    want = gemm_routes(gemm, cfg.num_hidden_layers, chunks, decodes)
    got = {route: launches[f"{gemm}_{route}"] for route in want}
    log(f"paged slice {mode}: {len(chunks)} prefill forwards of {sorted(set(chunks))} rows, "
        f"{len(decodes)} decode forwards; {gemm} launches by route {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"paged slice {mode}: {gemm} routes {got} != {want}")
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics()

    generated = sum(len(o or []) for o in outs)
    log(f"paged slice {mode}: {len(prompts)} requests, prompts {SYSTEM_TOKENS} + "
        f"{list(SUFFIXES)}, {generated} tokens in {wall:.3f} s = {generated / wall:.1f} "
        f"tok/s; {len(prefill_ms)} steps with a prefill chunk (mean "
        f"{sum(prefill_ms) / max(1, len(prefill_ms)):.3f} ms), {len(decode_ms)} decode "
        f"steps (median {sorted(decode_ms)[len(decode_ms) // 2] if decode_ms else 0:.3f} "
        f"ms, min {min(decode_ms, default=0):.3f} ms); peak memory {peak / 2**30:.2f} GiB")
    log(f"paged slice {mode} metrics: {json.dumps(m)}")
    log(f"paged slice {mode} launches: {json.dumps(launches)}; per decode step "
        f"{json.dumps(per_step)}")
    want_hits = (len(prompts) - 1) * SYSTEM_TOKENS
    if m["prefix_hit_tokens"] != want_hits:
        raise AssertionError(f"prefix_hit_tokens {m['prefix_hit_tokens']} != {want_hits}")
    if any(launches[k] <= 0 for k in routed(path_kernels(ops, mode))):
        raise AssertionError(f"a kernel of the {mode} paged path never launched: {launches}")
    if bad_steps or not decode_ms:
        raise AssertionError(f"paged decode-step launches {bad_steps[:3]} != {per_step}")
    for p, out in zip(prompts, outs):
        if out is None or len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"paged request (prompt {len(p)}): bad output {out}")
    if eng.prefix.refs or m["kv_pages_free"] + m["prefix_reusable_pages"] != m["kv_pages_total"]:
        raise AssertionError(f"pages leaked after the drain: {m}")

    # a reading, not a gate: the same traffic recomputing every prefill
    ref_outs = serve(engine(False), prompts, ops, per_step, first_alone=True)[0]
    same = sum(a == b for o, r in zip(outs, ref_outs) for a, b in zip(o, r))
    log(f"paged slice {mode}: {same} of {generated} tokens equal with prefix_cache=False "
        f"({same / generated:.4f})")
    stats = {"tokens_per_s": generated / wall, "wall_s": wall,
             "prefill_step_ms": prefill_ms, "decode_step_ms": decode_ms,
             "peak_gib": peak / 2**30, "equal_share_without_prefix": same / generated}
    profile_decode(model, prompts, kv_layout="paged")
    del eng, model
    torch.cuda.empty_cache()
    return launches, stats


def forward_rows(engine):
    """Record the token rows of every forward ``engine`` runs: its prefill
    chunks' padded lengths and its batched decodes' slots, in two lists
    (filled as it serves)."""
    chunks, decodes = [], []
    extend, decode = engine._extend_slot, engine._decode_step

    def extend_slot(tokens, *a, **k):
        chunks.append(tokens.numel())
        return extend(tokens, *a, **k)

    def decode_step():
        decodes.append(len(engine.active))
        return decode()

    engine._extend_slot, engine._decode_step = extend_slot, decode_step
    return chunks, decodes


def gemm_routes(gemm: str, layers: int, chunks: list, decodes: list) -> dict:
    """The launches of a routed GEMM ``gemm`` by route over forwards of
    ``chunks`` and ``decodes`` token rows: 7 a layer and lm_head each, on
    the decode route up to the wrapper's threshold and the tile route
    above it."""
    import importlib

    from protoquant_tpu_torch.ops.wo4_matmul import INT4_DECODE_MAX_M, SPLIT_DECODE_MAX_M
    from protoquant_tpu_torch.ops.wo_matmul import WO_DECODE_MAX_M

    A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
    per = 7 * layers + 1
    top = {"weight_only_matmul": WO_DECODE_MAX_M, "wo4_split": SPLIT_DECODE_MAX_M,
           "w4a8_two_level": INT4_DECODE_MAX_M, "w4a8_group": A.GROUP_DECODE_MAX_M}[gemm]
    rows = chunks + decodes
    return {"decode": per * sum(r <= top for r in rows), "tile": per * sum(r > top for r in rows)}


def step_launches(ops, cfg, writer: str | None, n_writes: int, attention: str) -> dict:
    """Exact launches of one unfused dynamic decode step of ``cfg``: 4
    rowquant per layer (the input of q/k/v, of o_proj, of the MLP, of
    down_proj) and one for lm_head; a qmatmul per projection (7 per gated
    layer, 6 per plain one) and lm_head; ``n_writes`` launches of the
    decode ``writer`` (the layers whose cache has one) and one
    ``attention`` per layer."""
    L = cfg.num_hidden_layers
    per_step = dict.fromkeys(ops.KERNELS, 0)
    per_step.update({"rowquant": 4 * L + 1, "qmatmul": (7 if cfg.mlp_gated else 6) * L + 1,
                     attention: L, **row_route_launches("rowquant", rowquant_widths(cfg))})
    if writer:
        per_step[writer] = n_writes
    return per_step


def mib_close(nbytes: int, mib: float) -> bool:
    """``nbytes`` is ``mib`` MiB give or take the caches' length vectors."""
    return abs(nbytes / 2**20 - mib) < 0.01


def _layer_bytes(B: int, KV: int, S: int, Dh: int) -> int:
    """Bytes of one int8 cache (dense or ring) of S columns."""
    return B * KV * S * (2 * Dh + 8) + 4 * B


def _check_served(label, cfg, launches, path, per_step, bad_steps, decode_ms, prompts, outs):
    if any(launches[k] <= 0 for k in routed(path)):
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    if bad_steps or not decode_ms:
        raise AssertionError(f"{label}: decode-step launches {bad_steps[:3]} != {per_step}")
    for p, out in zip(prompts, outs):
        if out is None or len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"{label} request (prompt {len(p)}): bad output {out}")


def _flush_note(crossed: int, flushing: int, decode_ms: list) -> str:
    """The chunk boundaries decode writes crossed and the decode steps in
    which any did (a KIVI update's launches that flush), where any did."""
    return (f"; chunk boundaries crossed by decode writes: {crossed}, in {flushing} of "
            f"{len(decode_ms)} decode steps" if crossed else "")


def _log_served(label, prompts, outs, wall, prefill_ms, decode_ms, peak):
    generated = sum(len(o or []) for o in outs)
    log(f"{label}: {len(prompts)} requests, prompts {[len(p) for p in prompts]}, {generated} "
        f"tokens in {wall:.3f} s = {generated / wall:.1f} tok/s; {len(prefill_ms)} steps with "
        f"a prefill chunk (mean {sum(prefill_ms) / max(1, len(prefill_ms)):.3f} ms), "
        f"{len(decode_ms)} decode steps (median {sorted(decode_ms)[len(decode_ms) // 2]:.3f} ms, "
        f"min {min(decode_ms):.3f} ms); peak memory {peak / 2**30:.2f} GiB")
    return {"tokens_per_s": generated / wall, "wall_s": wall, "prefill_step_ms": prefill_ms,
            "decode_step_ms": decode_ms, "peak_gib": peak / 2**30, "outputs": outs}


# the ring slices' traffic: Mistral's 6 prompts, three past its 4608 columns
RING_PROMPTS = [64, 9000, 300, 6100, 1000, 4700]
# cache MiB of the ring slices, and of the dense int8 layout they replace
RING_MIB = {"mistral_7b": (1188.0, 8448.0), "gemma2_9b": (4265.625, 5460.0)}


def run_ring_slice(ops, seed: int, dev, preset: str = "mistral_7b", model=None):
    """Phases 19 and 20: ``preset`` in ``dynamic`` mode over
    Engine(kv_layout="ring"), 4 slots, 6 greedy requests of 32 new tokens.
    Mistral-7B (built here, max_seq_len 32768, prefill_chunk 512): a ring on
    every layer. Gemma-2-9B (``model``, phase 17's, with its prompts and
    EngineConfig): the per-layer hybrid, a ring on each sliding layer and a
    dense int8 cache on each global one. Asserts the cache bytes and each
    decode step's launches (the ring writes in plain PyTorch: no decode
    scatter on its layers)."""
    from protoquant_tpu_torch import Engine, EngineConfig
    from protoquant_tpu_torch.models import RingInt8KVCache

    if preset == "mistral_7b":
        max_seq, chunk, prompt_lens = 32768, M7_CHUNK, RING_PROMPTS
        cfg, model = _build(preset, "dynamic", seed, dev)
    else:
        (max_seq, chunk, prompt_lens), cfg = SLICES[preset], model.cfg
    engine = Engine(model, EngineConfig(max_batch_size=4, max_seq_len=max_seq,
                                        prefill_chunk=chunk, max_new_tokens=32),
                    kv_layout="ring")
    rings = [c for c in engine.caches if isinstance(c, RingInt8KVCache)]
    L, KV, Dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    n_dense = L - len(rings)
    C = ring_capacity(cfg.sliding_window, chunk)
    cache_bytes = kv_cache_bytes(engine.caches)
    want = len(rings) * _layer_bytes(4, KV, C, Dh) + n_dense * _layer_bytes(4, KV, max_seq, Dh)
    want_mib, dense_mib = RING_MIB[preset]
    if (cache_bytes != want or not mib_close(cache_bytes, want_mib)
            or any(c.capacity != C for c in rings)
            or not mib_close(L * _layer_bytes(4, KV, max_seq, Dh), dense_mib)):
        raise AssertionError(f"ring cache: {cache_bytes} bytes, want {want} = {want_mib} MiB "
                             f"({len(rings)} rings of {C} columns)")
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in prompt_lens]
    per_step = step_launches(ops, cfg, "kv_scatter_decode", n_dense, "int8_kv_attention")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    outs, prefill_ms, decode_ms, bad_steps, *_ = serve(engine, prompts, ops, per_step)
    wall = time.perf_counter() - t_run
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    label = f"ring slice {preset} dynamic"
    stats = _log_served(label, prompts, outs, wall, prefill_ms, decode_ms, peak)
    log(f"{label} launches: {json.dumps(launches)}; per decode step {json.dumps(per_step)}")
    log(f"{label}: {len(rings)} rings of {C} columns and {n_dense} dense int8 caches of "
        f"{max_seq}: KV cache {cache_bytes} bytes = {cache_bytes / 2**20} MiB (the dense "
        f"int8 layout: {dense_mib} MiB)")
    path = ("rowquant", "qmatmul", "int8_kv_attention") + (
        ("kv_scatter_decode",) if n_dense else ())
    _check_served(label, cfg, launches, path, per_step, bad_steps, decode_ms, prompts, outs)
    del engine
    if preset == "mistral_7b":  # the first 4 prompts cut past the ring's columns
        profile_decode(model, prompts, max_seq_len=max_seq, prefill_chunk=chunk, ctx=C + 92,
                       kv_layout="ring")
    del model
    torch.cuda.empty_cache()
    return launches, stats


# phase 22: BLOOM-560m's runs, each (path, EngineConfig fields, kv_layout,
# kv_dtype, decode writer, attention)
BLOOM_RUNS = (
    ("bloom_dense", {}, "dense", "int8", "kv_scatter_decode", "int8_kv_attention"),
    ("bloom_paged", {"page_size": PAGE, "prefix_cache": True}, "paged", "int8",
     "paged_kv_scatter_decode", "paged_int8_attention"),
    ("bloom_k4v8", {}, "dense", "k4v8", *KIVI_KERNELS["k4v8"]),
    ("bloom_int4", {}, "dense", "int4", *KIVI_KERNELS["int4"]),
    ("bloom_ring", {"max_seq_len": 8192, "stream_window": 512, "attention_sinks": 4}, "ring",
     "int8", None, "int8_kv_attention"),
)
BLOOM_PROMPTS = [64, 700, 130, 1500, 256, 1017]
# the ring's prompts run past BLOOM's 2048 trained positions
BLOOM_RING_PROMPTS = [64, 6000, 300, 2500, 1000, 4000]
BLOOM_MIB = {"bloom_dense": 408.0, "bloom_ring": 159.375}


def run_bloom(ops, seed: int, dev) -> dict:
    """Phase 22: BLOOM-560m in ``dynamic`` mode at full width and depth,
    random int8 weights from ``seed``, 4 slots, prefill chunks of 256, 32
    new tokens, over the dense int8 (max_seq_len 2048), paged (128-token
    pages, prefix caching, 8 requests sharing a 512-token system prompt),
    K4V8 and Int4 (G = 64) caches, and the ring with StreamingLLM serving
    (window 512, 4 sinks, max_seq_len 8192: 800 columns). Each run is driven
    with the counts at 0 and asserts every decode step's launches; returns
    {path: (launches, stats)}."""
    from protoquant_tpu_torch import Engine, EngineConfig

    cfg, model = _build("bloom_560m", "dynamic", seed, dev)
    L, KV, Dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(seed + 3)
    draw = lambda n: torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    system = draw(SYSTEM_TOKENS)
    out = {}
    for path, extra, layout, kv_dtype, writer, attention in BLOOM_RUNS:
        ecfg = dict(max_batch_size=4, max_seq_len=BL_SEQ, prefill_chunk=256, max_new_tokens=32)
        ecfg.update(extra)
        engine = Engine(model, EngineConfig(**ecfg), kv_layout=layout, kv_dtype=kv_dtype)
        if layout == "paged":
            prompts = [system + draw(n) for n in SUFFIXES]
        else:
            prompts = [draw(n) for n in (BLOOM_RING_PROMPTS if layout == "ring"
                                         else BLOOM_PROMPTS)]
        cache_bytes = kv_cache_bytes(engine.caches)
        if layout == "ring":
            want = L * _layer_bytes(4, KV, ring_capacity(512, 256, 4), Dh)
            if engine.caches[0].capacity != 800:
                raise AssertionError(f"{path}: {engine.caches[0].capacity} columns, want 800")
        elif layout == "paged":
            P = 4 * BL_SEQ // PAGE + 1
            want = L * (P * KV * PAGE * (2 * Dh + 8) + 4 * 4 * BL_SEQ // PAGE + 4 * 4)
        else:
            want = expected_cache_bytes(kv_dtype, L, 4, KV, BL_SEQ, Dh)
        if cache_bytes != want or (path in BLOOM_MIB
                                   and not mib_close(cache_bytes, BLOOM_MIB[path])):
            raise AssertionError(f"{path}: KV cache {cache_bytes} bytes, want {want}")
        per_step = step_launches(ops, cfg, writer, L, attention)
        kernels = ("rowquant", "qmatmul", attention) + ((writer,) if writer else ()) + (
            ("int8_kv_attention",) if layout == "paged" else ())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        outs, prefill_ms, decode_ms, bad_steps, crossed, flushing = serve(
            engine, prompts, ops, per_step, first_alone=layout == "paged")
        wall = time.perf_counter() - t_run
        launches = path_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        label = f"bloom slice {layout} {kv_dtype}"
        stats = _log_served(label, prompts, outs, wall, prefill_ms, decode_ms, peak)
        log(f"{label} launches: {json.dumps(launches)}; per decode step "
            f"{json.dumps(per_step)}; KV cache {cache_bytes} bytes = {cache_bytes / 2**20} MiB"
            f"{_flush_note(crossed, flushing, decode_ms)}")
        _check_served(label, cfg, launches, kernels, per_step, bad_steps, decode_ms, prompts,
                      outs)
        if layout == "paged":
            m = engine.metrics()
            log(f"{label} metrics: {json.dumps(m)}")
            if m["prefix_hit_tokens"] != (len(prompts) - 1) * SYSTEM_TOKENS:
                raise AssertionError(f"{label}: prefix_hit_tokens {m['prefix_hit_tokens']}")
        out[path] = (launches, stats)
        del engine
        if layout == "paged":  # device busy of the paged decode (a reading)
            profile_decode(model, prompts, kv_layout="paged")
    del model
    torch.cuda.empty_cache()
    return out


# phases 24 and 25: GPT-OSS-20B's runs, each (path, kv_dtype, max_seq_len,
# prefill_chunk, prompt lengths): the int8 cache at 8192 positions behind
# chunks of 512 (prompts past the window of 128 but one), then the KIVI tiers
# at 2048 behind chunks of 256 (a chunk the KIVI guard admits at G = 64)
GO_RUNS = (("gpt_oss_dense", "int8", GO_SEQ, 512, [64, 6000, 300, 4700, 1000, 2500]),
           ("gpt_oss_k4v8", "k4v8", 2048, 256, [64, 1500, 300, 1900, 1000, 700]),
           ("gpt_oss_int4", "int4", 2048, 256, [64, 1500, 300, 1900, 1000, 700]))
GO_MIB = {"gpt_oss_dense": 816.0}


def moe_step_launches(ops, cfg, writer: str, attention: str) -> dict:
    """Exact launches of one dynamic decode step of a MoE model (every layer
    MoE): per layer one rowquant for q/k/v, one for o_proj, one of the
    experts' dispatched input and one of their hidden state; a qmatmul per
    attention projection and two per expert (gate_up or w1/w3 are one or
    two, and down); then lm_head's rowquant and qmatmul; one ``writer`` and
    one ``attention`` per layer."""
    L, E = cfg.num_hidden_layers, cfg.num_local_experts
    per_expert = 2 if cfg.moe_variant == "gpt_oss" else 3
    per_step = dict.fromkeys(ops.KERNELS, 0)
    per_step.update({"rowquant": 4 * L + 1, "qmatmul": (4 + per_expert * E) * L + 1,
                     writer: L, attention: L,
                     **row_route_launches("rowquant", rowquant_widths(cfg))})
    return per_step


def run_gpt_oss(ops, seed: int, dev) -> dict:
    """Phases 24 and 25: GPT-OSS-20B in ``dynamic`` mode at full width and
    all 24 layers, random int8 weights from ``seed`` (learned sinks drawn
    N(0, 1)), 4 slots, 32 new tokens, over the int8 cache (8192 positions,
    816.0 MiB) and the K4V8 and Int4 caches (2048 positions, G = 64). Each
    run is driven with the counts at 0 and asserts every decode step's
    launches and its cache's bytes; it prints the step median, peak memory
    and the share of expert assignments the capacity dropped. Returns
    {path: (launches, stats)}."""
    from protoquant_tpu_torch import Engine, EngineConfig
    from protoquant_tpu_torch.models.moe import MoEMLP

    cfg, model = _build("gpt_oss_20b", "dynamic", seed, dev)
    sink_gen = torch.Generator(device=dev).manual_seed(seed + 5)
    with torch.no_grad():
        for layer in model.layers:
            layer.self_attn.sinks.copy_(torch.randn(cfg.num_attention_heads, generator=sink_gen,
                                                    device=dev))
    moes = [m for m in model.modules() if isinstance(m, MoEMLP)]
    L, KV, Dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(seed + 7)
    out = {}
    for path, kv_dtype, max_seq, chunk, prompt_lens in GO_RUNS:
        engine = Engine(model, EngineConfig(max_batch_size=4, max_seq_len=max_seq,
                                            prefill_chunk=chunk, max_new_tokens=32),
                        kv_dtype=kv_dtype)
        prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
                   for n in prompt_lens]
        cache_bytes = kv_cache_bytes(engine.caches)
        want = expected_cache_bytes(kv_dtype, L, 4, KV, max_seq, Dh)
        if cache_bytes != want or (path in GO_MIB and not mib_close(cache_bytes, GO_MIB[path])):
            raise AssertionError(f"{path}: KV cache {cache_bytes} bytes, want {want}")
        writer, attention = CACHE_KERNELS[kv_dtype]
        per_step = moe_step_launches(ops, cfg, writer, attention)
        for m in moes:
            m.assignments, m.kept = 0, torch.zeros((), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        outs, prefill_ms, decode_ms, bad_steps, crossed, flushing = serve(engine, prompts, ops,
                                                                          per_step)
        wall = time.perf_counter() - t_run
        launches = path_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        label = f"gpt_oss slice {kv_dtype}"
        stats = _log_served(label, prompts, outs, wall, prefill_ms, decode_ms, peak)
        assigned = sum(m.assignments for m in moes)
        dropped = assigned - sum(float(m.kept) for m in moes)
        stats["dropped_share"] = dropped / assigned
        log(f"{label} launches: {json.dumps(launches)}; per decode step "
            f"{json.dumps(per_step)}; KV cache {cache_bytes} bytes = {cache_bytes / 2**20} MiB"
            f"{_flush_note(crossed, flushing, decode_ms)}; "
            f"expert assignments dropped by the capacity: {dropped:.0f} of {assigned} "
            f"({dropped / assigned:.4f}), idle slots and padding included")
        _check_served(label, cfg, launches, ("rowquant", "qmatmul", writer, attention),
                      per_step, bad_steps, decode_ms, prompts, outs)
        if kv_dtype in KIVI_KERNELS and crossed < 1:
            raise AssertionError(f"{label}: no decode step flushed a chunk")
        out[path] = (launches, stats)
        del engine
        if path == "gpt_oss_dense":  # the first 4 prompts whole, past the window
            profile_decode(model, prompts, max_seq_len=max_seq, prefill_chunk=chunk,
                           ctx=max_seq, kv_dtype=kv_dtype)
    del model, moes
    torch.cuda.empty_cache()
    return out


# -- phases 27 to 29: tensor parallelism, ranks sharing the card --------------

# the row-parallel products of Llama-2-7B (K, N): o_proj, down_proj
TP_SHAPES = ((HIDDEN, HIDDEN), (INTER, HIDDEN))
TP_RING_CALLS = 1000  # back-to-back calls of phase 27, M drawn from 1..256


def bench_eager(calls, iters: int = 20) -> float:
    """Device time per call, in ms, of ``iters`` calls cycling through
    ``calls``, launched one after another (no CUDA graph: a graph's replays
    would repeat the ring's per-call epoch). The card first sleeps while the
    host enqueues them all, so the events time the kernels back to back and
    not the host's launch overhead."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the card's clock
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if enqueue_ms > 40:
        raise AssertionError(f"bench_eager: enqueueing took {enqueue_ms:.1f} ms, the card "
                             "may have waited on the host")
    return start.elapsed_time(end) / iters


def ring_ref(xqs, sxs, wqs, sws, drop_hop=None, shift=0, reverse=False):
    """The ring written out, with the planted faults of phase 27: one hop's
    contribution dropped (``drop_hop``), each rank multiplying the chunk
    ``shift`` past the one it adds into, the ring's order reversed."""
    from protoquant_tpu_torch.core import numerics

    tp = len(xqs)
    nc = wqs[0].shape[0] // tp

    def part(d, e):
        rows = slice((e + shift) % tp * nc, ((e + shift) % tp + 1) * nc)
        return numerics.qmatmul_ref(xqs[d], wqs[d][rows], sxs[d], sws[d][rows])

    outs = []
    for e in range(tp):
        ranks = [(e + h) % tp for h in range(1, tp + 1)]  # e + 1, ..., e
        if reverse:
            ranks = [(e - h) % tp for h in range(1, tp + 1)]
        acc = None
        for i, d in enumerate(ranks):
            if i == drop_hop:
                continue
            acc = part(d, e) if acc is None else acc + part(d, e)
        outs.append(acc)
    return outs


def _ring_operands(gen, dev, tp, m, k, n, real, wqs=None):
    """Rank r's K slice of int8 activations [m, k] and of a weight [n, k]
    (``wqs``: the slices of an earlier call, reused); unit or real scales."""
    ks = k // tp
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    if wqs is None:
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        wqs = [wq[:, r * ks:(r + 1) * ks].contiguous() for r in range(tp)]
    sx = (torch.rand(m, generator=gen, device=dev) * 0.05 + 1e-3 if real
          else torch.ones(m, device=dev))
    sw = (torch.rand(n, generator=gen, device=dev) * 0.02 + 5e-4 if real
          else torch.ones(n, device=dev))
    return [xq[:, r * ks:(r + 1) * ks].contiguous() for r in range(tp)], [sx] * tp, wqs, [sw] * tp


def check_ring(ops, gen, dev):
    """Phase 27: the ring reduce-scatter matmul (B19) at Llama-2-7B's
    row-parallel shapes, tp = 2 and 4, M = 4 and 256, all ranks one launch
    on the card: equal to its plain version bit for bit with unit and with
    real scales; the planted faults of ``ring_ref`` (a hop dropped, the
    chunk one off, and at tp = 4 the order reversed, which only real scales
    show) must differ; then TP_RING_CALLS back-to-back calls of M from 1 to
    256, all equal. Timed (``bench_eager``) beside its bound (the weight's
    bytes: all ranks read from the one card), its plain version and, as a
    reading, ``torch._int_mm`` of the unsharded product with M padded to
    32 (no one PyTorch call computes a ring reduce-scatter). Each case
    asserts its route (M <= RING_DECODE_MAX_M decode, else prefill) and
    keeps its plan (the K splits of a cluster, the clusters and blocks)."""
    from protoquant_tpu_torch.ops.collective_matmul import ring_plan_of, ring_route, ring_tiles

    cases = []
    for tp in (2, 4):
        for k, n in TP_SHAPES:
            for m in (4, 256):
                faults = {}
                route = ring_route(m)
                for real in (False, True):
                    args = _ring_operands(gen, dev, tp, m, k, n, real)
                    before = dict(ops.qmatmul_reduce_scatter_dma.routes)
                    got = ops.qmatmul_reduce_scatter_dma_all(*args)
                    after = ops.qmatmul_reduce_scatter_dma.routes
                    if after[route] != before[route] + 1 or sum(after.values()) != sum(
                            before.values()) + 1:
                        raise AssertionError(f"ring tp={tp} M={m}: not the {route} route "
                                             f"({before} -> {after})")
                    want = ops.qmatmul_reduce_scatter_dma_all_ref(*args)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        err = max((a - b).abs().max().item() for a, b in zip(got, want))
                        raise AssertionError(f"ring tp={tp} M={m} K={k} N={n} real={real}: "
                                             f"max abs err {err}")
                    if not all(torch.equal(a, b) for a, b in zip(got, ring_ref(*args))):
                        raise AssertionError("ring_ref differs from the plain version")
                    planted = {"hop dropped": dict(drop_hop=1), "chunk one off": dict(shift=1)}
                    if tp > 2 and real:
                        planted["order reversed"] = dict(reverse=True)
                    for name, kw in planted.items():
                        bad = ring_ref(*args, **kw)
                        faults[f"{name}{'' if real else ', unit scales'}"] = sum(
                            int((a != b).sum()) for a, b in zip(got, bad))
                missed = [f for f, differ in faults.items() if differ == 0]
                if missed:
                    raise AssertionError(f"ring tp={tp} M={m}: planted faults {missed} "
                                         "equal the kernel")
                copies = [_ring_operands(gen, dev, tp, m, k, n, True)
                          for _ in range(copies_for(n * k))]
                xpad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
                xpad[:m] = torch.cat(copies[0][0], 1)
                b, kind = bound_ms(n * k + m * k + 4 * tp * (m + n) + 4 * m * n,
                                   2 * m * n * k, INT8_OPS_PER_S)
                full = [torch.cat(c[2], 1) for c in copies]
                splits, clusters = ring_plan_of(args[0], args[2]), ring_tiles(n // tp) * tp
                cases.append({
                    "shape": f"tp={tp} M={m} K={k} N={n}", "max_abs_err": 0.0,
                    "plan": {"route": route, "k_splits": splits, "clusters": clusters,
                             "blocks": clusters * splits},
                    "ms": bench_eager([lambda c=c: ops.qmatmul_reduce_scatter_dma_all(*c)
                                       for c in copies]),
                    "plain_ms": bench_eager([lambda c=c: ops.qmatmul_reduce_scatter_dma_all_ref(
                        *c) for c in copies], iters=5),
                    "bound_ms": b, "bound_by": kind,
                    "library_ms": bench([lambda w=w: torch._int_mm(xpad, w.t()) for w in full]),
                    "faults_differing_elements": faults})
                del copies, full
    # back-to-back calls, as the engine makes them: flags and slots of one
    # call must not leak into the next
    rng = torch.Generator().manual_seed(1234)
    wqs = {tp: _ring_operands(gen, dev, tp, 1, HIDDEN, HIDDEN, True)[2] for tp in (2, 4)}
    calls = []
    for i in range(TP_RING_CALLS):
        tp = (2, 4)[i % 2]
        m = int(torch.randint(1, 257, (1,), generator=rng))
        args = _ring_operands(gen, dev, tp, m, HIDDEN, HIDDEN, True, wqs[tp])
        calls.append((args, ops.qmatmul_reduce_scatter_dma_all(*args)))
    torch.cuda.synchronize()
    bad = [i for i, (args, got) in enumerate(calls)
           if not all(torch.equal(a, b) for a, b in
                      zip(got, ops.qmatmul_reduce_scatter_dma_all_ref(*args)))]
    if bad:
        raise AssertionError(f"ring: back-to-back calls {bad[:10]} of {TP_RING_CALLS} differ")
    log(f"ring: {TP_RING_CALLS} back-to-back calls (tp 2 and 4 in turn, M from 1 to 256, "
        f"K = N = {HIDDEN}) equal their plain versions")
    return cases


TP = 2  # phase 28's ranks, sharing the card


def tp_step_launches(ops, layers: int, tp: int) -> dict:
    """Exact launches of one TP decode step, ``collective=True`` under the
    "dma" ring: per rank, rowquant for q/k/v, o_proj, gate/up, down_proj
    and lm_head, qmatmul for q, k, v, gate, up and its lm_head shard, a
    decode write and an attention per layer; one ring launch for all ranks
    per row-parallel layer."""
    per_step = dict.fromkeys(ops.KERNELS, 0)
    per_step.update({"rowquant": tp * (4 * layers + 1), "qmatmul": tp * (5 * layers + 1),
                     "kv_scatter_decode": tp * layers, "int8_kv_attention": tp * layers,
                     "qmatmul_reduce_scatter_dma": 2 * layers,
                     "qmatmul_reduce_scatter_dma_decode": 2 * layers,
                     "qmatmul_reduce_scatter_dma_prefill": 0})
    return per_step


def ring_routes(layers: int, chunks: list, decodes: list) -> dict:
    """The ring's launches by route over forwards of ``chunks`` and
    ``decodes`` token rows: o_proj and down_proj of each layer, on the
    decode route up to RING_DECODE_MAX_M rows and the prefill route above."""
    from protoquant_tpu_torch.ops.collective_matmul import ring_route

    routes = [ring_route(r) for r in chunks + decodes]
    return {route: 2 * layers * routes.count(route) for route in ("decode", "prefill")}


TP_KERNELS = ("rowquant", "qmatmul", "kv_scatter_decode", "int8_kv_attention",
              "qmatmul_reduce_scatter_dma")


@contextlib.contextmanager
def ring_backend(value: str):
    from protoquant_tpu_torch.parallel import collective as coll

    saved = coll.RING_BACKEND
    try:
        coll.RING_BACKEND = value
        yield
    finally:
        coll.RING_BACKEND = saved


def _tp_from(model, mesh, collective=True):
    """The TP model of ``mesh`` holding ``model``'s weights, split by
    ``shard_params``."""
    from protoquant_tpu_torch.parallel import shard_params, tp_model

    tpm = tp_model(model.cfg, "dynamic", mesh, model.dtype, collective=collective)
    return tpm.load_shards(shard_params(model.state_dict(), mesh))


def run_tp_slice(ops, seed: int, dev, single_outputs):
    """Phase 28: Llama-2-7B ``dynamic`` at full width and all 32 layers, the
    weights of phase 4 (same seed) split over tp = 2 ranks that share the
    card (``devices=["cuda:0"] * 2``), ``collective=True`` under
    ``RING_BACKEND="dma"``: every o_proj and down_proj reduction is one ring
    launch. Phase 4's 6 requests through Engine(max_batch_size=4,
    max_seq_len=1024, prefill_chunk=256, mesh=mesh); every decode step's
    launches asserted. The share of tokens equal to phase 4's is a reading:
    each rank quantizes its activations against its own K rows."""
    from protoquant_tpu_torch import Engine, EngineConfig
    from protoquant_tpu_torch.parallel import make_mesh
    from protoquant_tpu_torch.utils import MeshConfig

    max_seq, chunk, prompt_lens = SLICES["llama2_7b"]
    cfg, model = _build("llama2_7b", "dynamic", seed, dev)
    mesh = make_mesh(MeshConfig(tp=TP), [dev] * TP)
    t0 = time.perf_counter()
    tpm = _tp_from(model, mesh)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"tp model: {TP} ranks on {mesh.devices}, sharded in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine = Engine(tpm, EngineConfig(max_batch_size=4, max_seq_len=max_seq,
                                      prefill_chunk=chunk, max_new_tokens=32),
                    kv_dtype="int8", mesh=mesh)
    cache_bytes = sum(kv_cache_bytes(c.shards) for c in engine.caches)
    want = expected_cache_bytes("int8", cfg.num_hidden_layers, 4, cfg.num_key_value_heads,
                                max_seq, cfg.head_dim) + 4 * 4 * cfg.num_hidden_layers * (TP - 1)
    if cache_bytes != want:  # each rank keeps its own lengths vector
        raise AssertionError(f"tp cache: {cache_bytes} bytes, want {want}")
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in prompt_lens]
    per_step = tp_step_launches(ops, cfg.num_hidden_layers, TP)
    # every forward's token rows: the ring routes by them
    chunks, decodes = forward_rows(engine)
    with ring_backend("dma"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        outs, prefill_ms, decode_ms, bad_steps, *_ = serve(engine, prompts, ops, per_step)
        wall = time.perf_counter() - t_run
        launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    label = f"tp slice dynamic tp={TP} (ring dma, int8 KV)"
    want = ring_routes(cfg.num_hidden_layers, chunks, decodes)
    got = {route: launches[f"qmatmul_reduce_scatter_dma_{route}"] for route in want}
    log(f"{label}: {len(chunks)} prefill forwards of {sorted(set(chunks))} rows, "
        f"{len(decodes)} decode forwards; qmatmul_reduce_scatter_dma launches by route "
        f"{json.dumps(got)}")
    if got != want:
        raise AssertionError(f"{label}: ring routes {got} != {want}")
    stats = _log_served(label, prompts, outs, wall, prefill_ms, decode_ms, peak)
    log(f"{label} launches: {json.dumps(launches)}; per decode step {json.dumps(per_step)}; "
        f"KV cache {cache_bytes} bytes = {cache_bytes / 2**20:.4f} MiB over {TP} ranks")
    _check_served(label, cfg, launches, TP_KERNELS, per_step, bad_steps, decode_ms, prompts,
                  outs)
    pairs = [(a, b) for o, r in zip(outs, single_outputs) for a, b in zip(o, r)]
    log(f"{label}: {sum(a == b for a, b in pairs)} of {len(pairs)} generated tokens equal to "
        f"phase 4's single-card engine ({sum(a == b for a, b in pairs) / len(pairs):.4f}; a "
        "reading)")
    del engine, tpm
    torch.cuda.empty_cache()
    return launches, stats


def run_tp_agreement(ops, seed: int, dev, dtype, tp: int):
    """Phase 29: a 2-layer full-width Llama-2-7B ``dynamic`` model split
    over tp ranks sharing the card (``collective=True``, "dma"), run on
    phase 5's prompt (48 tokens into 2 slots, then 4 greedy decode steps
    over ``make_tp_caches``) through the kernels, through the plain versions
    (on the card too) and through the plain versions with the ring's
    planted faults: prefill and decode logits must agree within phase 5's
    limits, and each fault must fail them."""
    import dataclasses

    from protoquant_tpu_torch import LlamaModel, ModelConfig
    from protoquant_tpu_torch.parallel import make_mesh, make_tp_caches
    from protoquant_tpu_torch.utils import MeshConfig

    cfg = dataclasses.replace(ModelConfig.llama2_7b(), num_hidden_layers=2)
    model = LlamaModel(cfg, mode="dynamic", dtype=dtype, device=dev).init_random_(seed + 1)
    mesh = make_mesh(MeshConfig(tp=tp), [dev] * tp)
    tpm = _tp_from(model, mesh)
    del model
    gen = torch.Generator().manual_seed(seed + 1)
    n_prompt = 48
    prompt = torch.randint(1, cfg.vocab_size, (2, n_prompt), generator=gen).to(dev)

    def run(tokens_in=None):
        caches, out, toks = make_tp_caches(cfg, mesh, 2, 128, "int8"), [], []
        pos = torch.arange(n_prompt, device=dev)[None].expand(2, -1)
        out.append(tpm(prompt, pos, caches))
        last = out[-1][:, -1]
        for i in range(4):
            tok = last.argmax(-1) if tokens_in is None else tokens_in[i]
            toks.append(tok)
            out.append(tpm(tok[:, None], caches[0].lengths.long()[:, None], caches))
            last = out[-1][:, -1]
        return out, toks

    def compare(out, ref):
        a = torch.cat([x.reshape(-1, cfg.vocab_size) for x in out]).float()
        b = torch.cat([x.reshape(-1, cfg.vocab_size) for x in ref]).float()
        da, db = a[-8:], b[-8:]  # the 4 decode steps of the 2 slots
        got = {"rel_l2": ((a - b).norm() / b.norm()).item(),
               "decode_rel_l2": ((da - db).norm() / db.norm()).item(),
               "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
               "max_abs": (a - b).abs().max().item(), "positions": a.shape[0],
               "finite": bool(torch.isfinite(a).all())}
        got["pass"] = (got["finite"] and got["rel_l2"] <= AGREE_REL
                       and got["decode_rel_l2"] <= AGREE_REL
                       and got["argmax_agree"] >= AGREE_ARGMAX)
        return got

    def faulty(**kw):
        return lambda xq, sx, wq, sw, group: group.collective(
            (xq, sx, wq, sw), lambda o: ring_ref(*map(list, zip(*o)), **kw),
            "qmatmul_reduce_scatter_dma")

    with ring_backend("dma"):
        ops.reset_launch_counts()
        kern, toks = run()
        launched = ops.launch_counts()
        ops.reset_launch_counts()
        with plain_versions():
            plain, _ = run(toks)
        readings = {"kernels": compare(kern, plain)}
        faults = {"ring drops a hop": faulty(drop_hop=1),
                  "ring adds the chunk one off": faulty(shift=1)}
        for name, fn in faults.items():
            with plain_versions(qmatmul_reduce_scatter_dma=fn):
                readings[name] = compare(run(toks)[0], plain)
    if any(ops.launch_counts().values()) or not all(launched[k] for k in TP_KERNELS) or any(
            launched[k] for k in launched if k not in TP_KERNELS):
        raise AssertionError(f"tp agreement: kernel run launched {launched}, plain runs "
                             f"{ops.launch_counts()}")
    for name, got in readings.items():
        log(f"tp agreement tp={tp} {str(dtype).replace('torch.', '')} (2 layers, full width, "
            f"dynamic, ring dma, prompt {n_prompt}, {name} vs plain on the card): "
            f"{json.dumps(got)}; limits rel_l2 <= {AGREE_REL}, argmax_agree >= {AGREE_ARGMAX}")
    if not readings["kernels"]["pass"]:
        raise AssertionError(f"tp agreement tp={tp} {dtype}: kernels and plain disagree")
    missed = [name for name in faults if readings[name]["pass"]]
    if missed:
        raise AssertionError(f"tp agreement tp={tp}: the limits pass planted fault(s) {missed}")
    del tpm
    torch.cuda.empty_cache()


@contextlib.contextmanager
def knob(ops, name: str, value: str | None):
    """Within the block, the module knob ``ops.<name>`` (W4A8_FORMULATION,
    FUSED_QUANT) reads ``value`` (None: as resolved at import)."""
    saved = getattr(ops, name)
    try:
        if value is not None:
            setattr(ops, name, value)
        yield
    finally:
        setattr(ops, name, saved)


@contextlib.contextmanager
def plain_versions(**faulty):
    """Within the block the model calls the plain PyTorch version wherever
    it would launch a kernel, or the function given for that kernel's name
    in ``faulty``. A harness for the agreement phases only: the package
    itself has no such switch, it dispatches by device."""
    from protoquant_tpu_torch import ops
    from protoquant_tpu_torch.engine import paged_kv
    from protoquant_tpu_torch.models import kv_cache

    swaps = [("rowquant", ops, ops.rowquant_ref), ("qmatmul", ops, ops.qmatmul_ref),
             ("rms_norm_quant", ops, ops.rms_norm_quant_ref),
             ("swiglu_quant", ops, ops.swiglu_quant_ref),
             ("weight_only_matmul", ops, ops.weight_only_matmul_ref),
             ("weight_only_int4_matmul", ops, ops.weight_only_int4_matmul_ref),
             ("w4a8_matmul", ops, ops.w4a8_matmul_ref),
             ("kv_scatter_decode", kv_cache, ops.kv_scatter_decode_ref),
             ("int8_kv_attention", kv_cache, ops.int8_kv_attention_ref),
             ("int8_kv_attention", paged_kv, ops.int8_kv_attention_ref),
             ("paged_kv_scatter_decode", paged_kv, ops.paged_kv_scatter_decode_ref),
             ("paged_int8_attention", paged_kv, ops.paged_int8_attention_ref),
             ("k4v8_decode_update", kv_cache, ops.k4v8_decode_update_ref),
             ("k4v8_attention", kv_cache, ops.k4v8_attention_ref),
             ("kivi4_decode_update", kv_cache, ops.kivi4_decode_update_ref),
             ("int4_kv_attention", kv_cache, ops.int4_kv_attention_ref),
             ("kv_mixed_scatter_decode", kv_cache, ops.kv_mixed_scatter_decode_ref),
             ("mixed_kv_attention", kv_cache, ops.mixed_kv_attention_ref),
             ("qmatmul_reduce_scatter_dma", ops, ops.qmatmul_reduce_scatter_dma_ref)]
    saved = [(mod, name, getattr(mod, name)) for name, mod, _ in swaps]
    try:
        for name, mod, plain in swaps:
            setattr(mod, name, faulty.get(name, plain))
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


@contextlib.contextmanager
def pinned_routing(record: list, replay: bool):
    """Within the block every MoE layer routes as in a recorded run: a
    recording run (``replay`` False) appends each forward's expert choices
    and router logits to ``record``; a replay takes the choices in the same
    order and computes only their combine weights from its own router
    logits. Top-k is discontinuous: the kernels sum in other orders than
    their plain versions, a router logit near a tie then picks another
    expert, and an agreement would measure that choice and not the
    kernels. ``route_divergence`` reads, from a run with its own routing,
    where that happens. A harness for the agreement phases only."""
    from protoquant_tpu_torch.models.moe import MoEMLP

    orig, calls = MoEMLP.route, iter(record)

    def route(self, xf):
        if not replay:
            gate_idx, gate_vals = orig(self, xf)
            record.append((gate_idx, self.router_logits(xf)))
            return gate_idx, gate_vals
        gate_idx = next(calls)[0]
        return gate_idx, self.gate_values(self.router_logits(xf), gate_idx)

    MoEMLP.route = route
    try:
        yield
    finally:
        MoEMLP.route = orig


def route_divergence(kern: list, plain: list, k: int) -> dict:
    """Where a run with its own routing (``plain``) routes otherwise than
    the kernel run (``kern``), both recorded by ``pinned_routing``: the
    (token, MoE call) routes whose expert sets differ, and at the first
    call in execution order with any, each such token's top-k margin in
    the kernel run (the k-th minus the (k+1)-th router logit), also in f32
    ulps of the k-th logit, beside the call's noise: the largest router
    logit difference between the two runs over the call's tokens whose
    routes agree. Upstream of that call the runs differ only by the
    kernels' rounding, so a route that flips there on a margin above twice
    the noise (more than the noise the call shows can move) is a fault:
    ``explained`` is False."""
    got = {"calls": len(kern), "routes": 0, "differ": 0, "first_call": None,
           "margins": [], "margins_ulps": [], "noise": None, "noise_ulps": None,
           "explained": True}
    for call, ((ia, la), (ib, lb)) in enumerate(zip(kern, plain)):
        bad = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        got["routes"] += bad.numel()
        got["differ"] += int(bad.sum())
        if got["first_call"] is not None or not bad.any():
            continue
        top = la.topk(k + 1, dim=-1).values
        kth = top[:, k - 1]
        ulp = (torch.nextafter(kth, torch.full_like(kth, math.inf)) - kth).abs()
        margin = (kth - top[:, k])[bad]
        diff = (la - lb).abs().amax(-1)
        noise = diff[~bad].max().item() if (~bad).any() else math.inf
        got.update(first_call=call, margins=margin.tolist(),
                   margins_ulps=(margin / ulp[bad]).tolist(), noise=noise,
                   noise_ulps=noise / ulp.median().item(),
                   explained=bool((margin <= 2 * noise).all()))
    return got


def _swap_nibbles(packed):
    """Each byte's two nibbles exchanged: the low and high halves of every
    group trade places."""
    u = packed.to(torch.int32) & 0xFF
    return (((u & 0x0F) << 4) | (u >> 4)).to(torch.uint8).view(torch.int8)


def _scale_row_shifted(writer):
    """``writer`` (a KIVI decode writer's plain version) with a fault: the
    channel scales of a flushed chunk c land in row c + 1 of kchs, and row c
    keeps what it held."""
    def faulty(kq, kchs, *rest, **kw):
        before = kchs.clone()
        out = writer(kq, kchs, *rest, **kw)
        moved = (kchs != before).any(dim=-1, keepdim=True).roll(1, dims=2)
        kchs.copy_(torch.where(moved, kchs.roll(1, dims=2), before))
        return out
    return faulty


def _tails_first(ops, tier: str):
    """The KIVI update's plain version with a fault on its prefill route:
    the new rows go to the tails first (a call that advances no length and
    so flushes nothing), then the update runs, so its first chunk reads
    back as old the tail rows that new positions landed on."""
    writer = getattr(ops, KIVI_KERNELS[tier][0] + "_ref")

    def faulty(*args, group, adv=None):
        lengths, k8 = args[8], args[9]
        if k8.shape[2] > 1:
            ops.kivi_prefill_update_ref(*args, group=group, adv=torch.zeros_like(lengths),
                                        v4=tier == "int4")
        return writer(*args, group=group, adv=adv)
    return faulty


def _partner_nibble(ops):
    """The K8V4 writer's plain version with a fault: each token's V nibble
    lands in its pair partner's half of the byte, its own half keeps what
    it held (K and both scales are written right)."""
    from protoquant_tpu_torch.ops.kv_scatter import merge_nibble

    def faulty(kq, ks, vq, vs, lengths, k8, ks_new, v4, vs_new):
        B, S = kq.shape[0], kq.shape[2]
        p = lengths.long().clamp(0, S - 1)
        b, row = torch.arange(B, device=kq.device), p // 2
        before = vq[b, :, row].clone()
        out = ops.kv_mixed_scatter_decode_ref(kq, ks, vq, vs, lengths, k8, ks_new, v4, vs_new)
        wrong = merge_nibble(before, v4.reshape(before.shape), (1 - p % 2)[:, None, None])
        keep = (lengths.long().clamp_min(0) < S)[:, None, None]
        vq[b, :, row] = torch.where(keep, wrong, vq[b, :, row])
        return out
    return faulty


def gemma2_attention_faults(ops, kv_dtype: str):
    """Gemma-2's planted faults in the attention of the ``kv_dtype`` cache,
    as (faults the limits must reject, faults only read): the plain version
    ignoring the sliding window, and dropping the score scale (scores times
    1 for 256^-0.5, where the model's own Dh^-0.5 would equal it); and
    ignoring the softcap, which the model's scores at random weights reach
    too rarely for a gate."""
    attn = CACHE_KERNELS[kv_dtype][1]
    plain = getattr(ops, attn + "_ref")

    def fault(**wrong):
        return {attn: lambda *a, **k: plain(*a, **dict(k, **wrong))}

    return ({f"{attn} ignores the sliding window": fault(window=0),
             f"{attn} drops the score scale": fault(scale=1.0)},
            {f"{attn} ignores the softcap (a reading)": fault(softcap=0.0)})


def planted_faults(ops, mode: str = "dynamic", kv_dtype: str = "int8",
                   preset: str = "llama2_7b"):
    """Plain versions with one small fault each, standing in for a wrong
    kernel: the agreement limits must reject every one. One fault for each
    kernel that a mode's agreement brought in (the fused path: its two
    producers; a KIVI or K8V4 cache: its writer and its attention; Gemma-2:
    its attention's variants)."""
    if preset == "gemma2_9b":
        return gemma2_attention_faults(ops, kv_dtype)[0]
    if kv_dtype == "k8v4":
        return {
            "kv_mixed_scatter_decode writes V into the pair partner's nibble": {
                "kv_mixed_scatter_decode": _partner_nibble(ops)},
            "mixed_kv_attention swaps the two V-scale planes": {
                "mixed_kv_attention": lambda q, kq, ks, vq, vs, lengths, **k:
                    ops.mixed_kv_attention_ref(q, kq, ks, vq, vs.flip(2), lengths, **k)},
        }
    if kv_dtype in KIVI_KERNELS:
        writer, attn = KIVI_KERNELS[kv_dtype]
        plain_attn = getattr(ops, attn + "_ref")
        return {
            f"{writer} writes chunk c's scales into row c + 1": {
                writer: _scale_row_shifted(getattr(ops, writer + "_ref"))},
            f"{writer} writes the tails before its first chunk reads them": {
                writer: _tails_first(ops, kv_dtype)},
            f"{attn} swaps the low and high nibbles of K": {
                attn: lambda q, kq, *a, **k: plain_attn(q, _swap_nibbles(kq), *a, **k)},
        }
    if fused(mode):
        return {
            "rms_norm_quant reads the neighbouring channel's weight": {
                "rms_norm_quant": lambda x, w, **k: ops.rms_norm_quant_ref(x, w.roll(1), **k)},
            "swiglu_quant applies the activation to up": {
                "swiglu_quant": lambda gate, up, **k: ops.swiglu_quant_ref(up, gate, **k)},
        }
    if mode == "dynamic":
        return {
            "qmatmul epilogue reads s_w[n-1]": {
                "qmatmul": lambda xq, w, sx, sw, *a, **k: ops.qmatmul_ref(
                    xq, w, sx, sw.roll(1), *a, **k)},
            "attention mask one key short": {
                "int8_kv_attention": lambda q, kq, ks, vq, vs, lengths, **k:
                    ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths - 1, **k)},
        }
    if mode == "weight_only":
        return {
            "weight_only_matmul epilogue reads s_w[n-1]": {
                "weight_only_matmul": lambda x, w, sw, *a, **k: ops.weight_only_matmul_ref(
                    x, w, sw.roll(1), *a, **k)},
            **{f"weight_only_matmul {route} route drops its last K slice": {
                "weight_only_matmul": _wo_slice_dropped(ops, route)}
               for route in ("decode", "tile")},
            "paged attention one key short": {
                "paged_int8_attention": lambda q, kq, ks, vq, vs, pt, lengths, **k:
                    ops.paged_int8_attention_ref(q, kq, ks, vq, vs, pt, lengths - 1, **k)},
            "paged scatter writes every row to the trash page": {
                "paged_kv_scatter_decode": lambda kq, ks, vq, vs, pt, *a:
                    ops.paged_kv_scatter_decode_ref(kq, ks, vq, vs, torch.full_like(pt, -1),
                                                    *a)},
        }
    if mode == "dynamic_int4":
        return {
            "w4a8 reads scale column n-1": {
                "w4a8_matmul": lambda xq, sx, p, sc, g, *a, **k: ops.w4a8_matmul_ref(
                    xq, sx, p, sc.roll(1, 0), g, *a, **dict(k, two_level=None))},
        }
    return {
        "wo4 swaps the low and high nibble halves": {
            "weight_only_int4_matmul": lambda x, p, *a, **k: ops.weight_only_int4_matmul_ref(
                x, _swap_nibbles(p), *a, **k)},
    }


def _wo_slice_dropped(ops, route: str):
    """The plain weight-only product, but on ``route``'s calls (the decode
    or the tile kernel's M) with the last K slice of the kernel's plan
    dropped: a fault of that route alone."""
    def faulty(x, wq, s_w, bias=None, out_dtype=None):
        here, _, (k0, k1) = _wo_route(x.numel() // x.shape[-1], *wq.shape, x.device)
        if here == route:
            x = x.clone()
            x[..., k0:k1] = 0
        return ops.weight_only_matmul_ref(x, wq, s_w, bias, out_dtype)
    return faulty


# The KIVI agreement's prompt (phase 14), prefilled in two chunks: the second
# starts 63 positions into chunk 2 and is longer than 2G, so its first flush
# reads 63 old tail rows that its own later rows land on; the prompt is 62
# past a multiple of G = 64, so the second decode step's write completes a
# chunk and flushes it, and the last three steps read it packed
KIVI_AGREE_PROMPT, KIVI_AGREE_CHUNK = 382, 191
# Gemma-2's agreement prompt: 1.5 times the window and more, so that layer
# 0's window hides keys from every decode position; the second decode write
# completes a KIVI chunk (G = 64) and flushes it. Prefill in chunks of 1024,
# logits kept at every 16th prompt position. Mistral's ring agreement: 6000
# tokens through a ring of 4096 + 1024 columns, which wraps.
G2_AGREE_PROMPT, G2_AGREE_CHUNK, G2_AGREE_STRIDE = 6206, 1024, 16
M7_AGREE_PROMPT = 6000
# BLOOM's ring agreement: a serving window of 16 and 4 sinks behind
# 8-token chunks (32 columns) under a 60-token prompt, so the ring wraps and
# the sinks hold a share of each row's keys that dropping them shows
BL_AGREE_RING = dict(window=16, sinks=4, chunk=8, prompt=60)
# In the ring agreements q_proj's output is scaled by this much, so that a
# row's attention falls on few keys, as a trained model's does, and not
# spread evenly over thousands: which keys a row sees then shows in the
# logits, and a fault in the mask with it
RING_Q_GAIN = 4.0


def ring_faults(ops):
    """The ring's planted faults in the int8 attention's plain version: the
    columns read as positions, and the window dropped."""
    plain = ops.int8_kv_attention_ref
    return {"int8_kv_attention reads the ring's columns as positions": {
                "int8_kv_attention": lambda *a, **k: plain(*a, **dict(k, k_positions=None))},
            "int8_kv_attention drops the window on the ring": {
                "int8_kv_attention": lambda *a, **k: plain(*a, **dict(k, window=0))}}


def bloom_faults(ops, kv_dtype: str, layout: str):
    """BLOOM's planted faults: each attention of the cache dropping the
    ALiBi slopes; on the ring, also the sinks."""
    attns = {"paged": ("paged_int8_attention", "int8_kv_attention"),
             "ring": ("int8_kv_attention",)}.get(layout, (CACHE_KERNELS[kv_dtype][1],))

    def fault(attn, **wrong):
        plain = getattr(ops, attn + "_ref")
        return {attn: lambda *a, **k: plain(*a, **dict(k, **wrong))}

    faults = {f"{a} drops ALiBi": fault(a, alibi_slopes=None) for a in attns}
    if layout == "ring":
        faults["int8_kv_attention drops the ring's sinks"] = fault("int8_kv_attention", sinks=0)
    return faults


# GPT-OSS's agreement prompt: past the window of 128 many times, prefilled in
# chunks of 512 (128 for the weight_only_int4 model, whose plain lm_head
# keeps a [K/64, chunk, 201088] f32 partial per group), logits kept at every
# 16th prompt position; each sink logit ln 128 + N(0, 1), so that a sink
# holds about half of a sliding row's mass and dropping it shows
GO_AGREE_PROMPT, GO_AGREE_STRIDE = 1200, 16
GO_AGREE_CHUNK = {"dynamic": 512, "weight_only_int4": 128}


def _gate_up_halves(y, n: int, inter: int):
    """A gate_up product's output laid out so that the MoE, reading gate from
    the even columns and up from the odd ones, reads gate from the first
    half and up from the second (the layout de-interleaved); any other
    product's output as it is."""
    if n != 2 * inter:
        return y
    return torch.stack([y[..., :inter], y[..., inter:]], dim=-1).reshape(y.shape)


def gpt_oss_faults(ops, mode: str, kv_dtype: str, inter: int):
    """GPT-OSS's planted faults: the cache's attention dropping its learned
    sinks (the bf16 cache attends in plain PyTorch: no kernel to fault), and
    the experts' gate/up read de-interleaved, through the mode's GEMM."""
    faults = {}
    if kv_dtype != "bf16":
        attn = CACHE_KERNELS[kv_dtype][1]
        plain = getattr(ops, attn + "_ref")
        faults[f"{attn} drops the learned sinks"] = {
            attn: lambda *a, **k: plain(*a, **dict(k, sink_logits=None))}
    if mode == "dynamic":
        faults["the experts' gate/up de-interleaved"] = {
            "qmatmul": lambda xq, w, *a, **k: _gate_up_halves(
                ops.qmatmul_ref(xq, w, *a, **k), w.shape[0], inter)}
    else:
        faults["the experts' gate/up de-interleaved"] = {
            "weight_only_int4_matmul": lambda x, p, *a, **k: _gate_up_halves(
                ops.weight_only_int4_matmul_ref(x, p, *a, **k), p.shape[0], inter)}
    return faults


def agreement_path(ops, mode: str, kv_dtype: str, layout: str, n_dense: int,
                   preset: str = "llama2_7b") -> tuple:
    """The kernel bodies an agreement's kernel run launches."""
    if preset == "gpt_oss_20b":  # dense caches only; the bf16 one attends in plain PyTorch
        gemm = ("rowquant", "qmatmul") if mode == "dynamic" else ("wo4_split",)
        return gemm + (CACHE_KERNELS[kv_dtype] if kv_dtype != "bf16" else ())
    if layout == "ring":
        return ("rowquant", "qmatmul", "int8_kv_attention") + (
            ("kv_scatter_decode",) if n_dense else ())
    if layout == "paged" and mode == "dynamic":
        return ("rowquant", "qmatmul", "paged_kv_scatter_decode", "paged_int8_attention",
                "int8_kv_attention")
    return path_kernels(ops, mode, kv_dtype)


def run_agreement(ops, seed: int, dev, dtype, mode: str = "dynamic",
                  formulation: str | None = None, fused_quant: str | None = None,
                  kv_dtype: str = "int8", preset: str = "llama2_7b", layout: str | None = None):
    """2 layers at full width on the card, run on the same prompt through
    the kernels, through their plain versions, and through the plain
    versions with each planted fault. A prefill of 48 tokens into 2 slots,
    then 4 greedy decode steps (the decode scatter, T = 1 attention); every
    run decodes the kernel run's tokens, so all see the same inputs.

    The dynamic modes run over the dense cache, the weight-only modes over a
    paged pool of 16-token pages, so each slot's 52 tokens span 4 pages,
    mapped in a shuffled order. ``formulation``: the W4A8 formulation of a
    dynamic_int4 run; ``fused_quant``: the FUSED_QUANT knob (default: each
    as resolved). On the fused path the norm weights are drawn from
    [0.5, 1.5] (init_random_ sets them to 1, under which a kernel reading
    the wrong weight would pass unseen). Over a KIVI cache (``kv_dtype``
    "k4v8" or "int4", G = 64) the prompt is KIVI_AGREE_PROMPT tokens in two
    prefill chunks, the second read from old tail rows that it overwrites
    (the update's prefill route), and the second decode step's write
    completes a chunk and flushes it, and the last three steps read it from
    the packed store (BLOOM's: 62 tokens in one chunk); over the K8V4 cache
    it is 61 tokens, so
    the decode writes land in both nibble parities (61 shares its byte with
    the prompt's last token). These caches' kernels act on the decode
    positions, so their runs must pass the limit there too, as the paged
    ones.

    ``preset="gemma2_9b"`` (phase 18): a 2-layer Gemma-2-9B, layer 0 sliding
    (window 4096) and layer 1 global, over the dense cache of ``kv_dtype``,
    with a prompt of G2_AGREE_PROMPT tokens prefilled in chunks; judged on
    the decode positions too, against the window and scale faults of its
    attention; the softcap fault is printed as a reading.

    ``layout="ring"`` (phase 21): Mistral-7B (M7_AGREE_PROMPT tokens, both
    layers on rings of 5120 columns) or the Gemma-2 hybrid (layer 0 on a
    ring, layer 1 dense), prefilled in chunks of 1024, q_proj scaled by
    RING_Q_GAIN; the kernel run must also agree with the kernels over the
    dense windowed int8 cache, and the ring's faults (columns read as
    positions, window dropped) must fail.
    ``preset="bloom_560m"`` (phase 23): a 2-layer BLOOM over ``layout``
    "dense" (``kv_dtype`` int8, k4v8 or int4), "paged" (``mode`` dynamic)
    or "ring" (BL_AGREE_RING), against the faults of ``bloom_faults``.
    ``preset="gpt_oss_20b"`` (phase 26): a 2-layer GPT-OSS-20B (layer 0
    sliding, layer 1 global, both MoE) in ``mode`` "dynamic" or
    "weight_only_int4" over the dense cache of ``kv_dtype`` (int8, k4v8,
    int4 or bf16), GO_AGREE_PROMPT tokens prefilled in chunks, sinks drawn
    ln 128 + N(0, 1), judged on the decode positions too, against the
    faults of ``gpt_oss_faults``; the plain and faulted runs route every
    token to the experts the kernel run chose (``pinned_routing``), and one
    more plain run with routing of its own is a reading whose first route
    flip must be explained by the router noise (``route_divergence``)."""
    import dataclasses

    from protoquant_tpu_torch import LlamaModel, ModelConfig
    from protoquant_tpu_torch.engine import PagedInt8KVCache
    from protoquant_tpu_torch.models import Int8KVCache, RingInt8KVCache, init_cache
    from protoquant_tpu_torch.models.llama import RMSNorm

    gpt = preset == "gpt_oss_20b"
    layout = layout or ("paged" if mode.startswith("weight_only") and not gpt else "dense")
    gemma, bloom = preset == "gemma2_9b", preset == "bloom_560m"
    paged, ring = layout == "paged", layout == "ring"
    kv_kernels = kv_dtype != "int8"  # the decode writer and attention of a KIVI or K8V4 cache
    cfg = dataclasses.replace(getattr(ModelConfig, preset)(), num_hidden_layers=2)
    model = LlamaModel(cfg, mode=mode, dtype=dtype, device=dev).init_random_(seed + 1)
    gen = torch.Generator().manual_seed(seed + 1)
    window, sinks = cfg.sliding_window, 0
    if gemma or preset == "mistral_7b":
        n_prompt = G2_AGREE_PROMPT if gemma else M7_AGREE_PROMPT
        chunk, stride = G2_AGREE_CHUNK, G2_AGREE_STRIDE
        max_seq = -(-(n_prompt + 4) // KIVI_G) * KIVI_G
    elif gpt:
        n_prompt, chunk, stride = GO_AGREE_PROMPT, GO_AGREE_CHUNK[mode], GO_AGREE_STRIDE
        max_seq = -(-(n_prompt + 4) // KIVI_G) * KIVI_G
        with torch.no_grad():
            for layer in model.layers:
                layer.self_attn.sinks.copy_(
                    torch.randn(cfg.num_attention_heads, generator=gen).to(dev)
                    + math.log(GO_WINDOW))
    elif bloom and ring:
        window, sinks = BL_AGREE_RING["window"], BL_AGREE_RING["sinks"]
        n_prompt, chunk, max_seq, stride = BL_AGREE_RING["prompt"], BL_AGREE_RING["chunk"], 128, 1
    elif kv_dtype in KIVI_KERNELS and not bloom:
        n_prompt, chunk, stride = KIVI_AGREE_PROMPT, KIVI_AGREE_CHUNK, 1
        max_seq = -(-(n_prompt + 4) // KIVI_G) * KIVI_G
    else:
        n_prompt, max_seq, stride = {"int8": 48, "k8v4": 61}.get(kv_dtype, 62), 128, 1
        chunk = n_prompt
    prompt = torch.randint(1, cfg.vocab_size, (2, n_prompt), generator=gen).to(dev)
    ps, max_pages = 16, 128 // 16
    order = torch.randperm(2 * max_pages, generator=gen).tolist()
    KV, Dh = cfg.num_key_value_heads, cfg.head_dim
    n_dense = sum(ring and cfg.layer_window(i) == 0 and not bloom for i in range(2))

    def new_caches(kind=layout):
        if kind == "ring":
            return [RingInt8KVCache.init(2, window, chunk, KV, Dh, sinks=sinks, device=dev)
                    if bloom or cfg.layer_window(i) else Int8KVCache.init(2, max_seq, KV, Dh, dev)
                    for i in range(cfg.num_hidden_layers)]
        if kind != "paged":
            return init_cache(cfg, 2, max_seq, dev, kv_dtype)
        caches = [PagedInt8KVCache.init(2, 2 * max_pages + 1, max_pages, ps, KV, Dh, dev)
                  for _ in range(cfg.num_hidden_layers)]
        for c in caches:
            for slot in range(2):
                c.map_slot(slot, order[slot * max_pages:(slot + 1) * max_pages])
        return caches

    def run(tokens_in=None, kind=layout):
        """Logits of every ``stride``-th prompt position, then of the 4
        decode steps, and the tokens decoded."""
        caches, out, toks = new_caches(kind), [], []
        if ring and kind == "ring" and not any(isinstance(c, RingInt8KVCache)
                                               and c.capacity < n_prompt for c in caches):
            raise AssertionError(f"ring agreement: the prompt of {n_prompt} does not wrap")
        for c0 in range(0, n_prompt, chunk):
            piece = prompt[:, c0:c0 + chunk]
            pos = torch.arange(c0, c0 + piece.shape[1], device=dev)[None].expand(2, -1)
            logits = model(piece, pos, caches)
            last = logits[:, -1]
            out.append(logits[:, ::stride].clone())
            del logits
        for i in range(4):
            tok = last.argmax(-1) if tokens_in is None else tokens_in[i]
            toks.append(tok)
            out.append(model(tok[:, None], caches[0].lengths.long()[:, None], caches))
            last = out[-1][:, -1]
        return out, toks

    def compare(out, ref):
        """Readings over all positions kept, and the relative L2 error over
        the decode positions alone (8 of the 104, or of the 772 with a KIVI
        cache, 130 with K8V4), where the decode writer and T = 1 attention
        act. The paged path's two attention kernels, the KIVI flush and the
        K8V4 nibble writes act there only, so their runs must pass the limit
        there too; so must Gemma-2's, whose window hides keys there, and
        the ring's and BLOOM's."""
        a = torch.cat([x.reshape(-1, cfg.vocab_size) for x in out]).float()
        b = torch.cat([x.reshape(-1, cfg.vocab_size) for x in ref]).float()
        da = torch.cat([x.reshape(-1, cfg.vocab_size) for x in out[-4:]]).float()
        db = torch.cat([x.reshape(-1, cfg.vocab_size) for x in ref[-4:]]).float()
        got = {"rel_l2": ((a - b).norm() / b.norm()).item(),
               "decode_rel_l2": ((da - db).norm() / db.norm()).item(),
               "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
               "max_abs": (a - b).abs().max().item(), "positions": a.shape[0],
               "finite": bool(torch.isfinite(a).all())}
        got["pass"] = (got["finite"] and got["rel_l2"] <= AGREE_REL
                       and got["argmax_agree"] >= AGREE_ARGMAX
                       and (not (paged or kv_kernels or gemma or ring or bloom or gpt)
                            or got["decode_rel_l2"] <= AGREE_REL))
        return got

    with knob(ops, "W4A8_FORMULATION", formulation), knob(ops, "FUSED_QUANT", fused_quant):
        if fused(mode):
            with torch.no_grad():
                for norm in (m for m in model.modules() if isinstance(m, RMSNorm)):
                    norm.weight.copy_(torch.rand(norm.weight.shape, generator=gen) + 0.5)
        if ring and not bloom:
            for layer in model.layers:
                layer.self_attn.q_proj.qscale.mul_(RING_Q_GAIN)
        # a MoE model's plain and faulted runs take the kernel run's routing
        routes = []
        routing = ((lambda replay: pinned_routing(routes, replay)) if gpt
                   else (lambda replay: contextlib.nullcontext()))
        ops.reset_launch_counts()
        with routing(False):
            kern, toks = run()
        launched, routes_run = ops.launch_counts(), ops.route_counts()
        readings, must_pass = {}, ["kernels"]
        if ring and not bloom:  # the same kernels over the dense windowed cache
            readings["ring vs dense windowed cache"] = compare(kern, run(toks, "dense")[0])
            must_pass.append("ring vs dense windowed cache")
        ops.reset_launch_counts()
        with plain_versions(), routing(True):
            plain, _ = run(toks)
        readings["kernels"] = compare(kern, plain)
        if gpt:  # a reading: the plain versions with routing of their own
            free = []
            with plain_versions(), pinned_routing(free, False):
                readings["kernels, routing not pinned"] = compare(kern, run(toks)[0])
            divergence = route_divergence(routes, free, cfg.num_experts_per_tok)
        del kern
        if bloom:
            faults = bloom_faults(ops, kv_dtype, layout)
        elif gpt:
            faults = gpt_oss_faults(ops, mode, kv_dtype,
                                    cfg.moe_intermediate_size or cfg.intermediate_size)
        elif ring:
            faults = ring_faults(ops)
        else:
            faults = planted_faults(ops, mode, kv_dtype, preset)
        unjudged = gemma2_attention_faults(ops, kv_dtype)[1] if gemma and not ring else {}
        for fault, swaps in {**faults, **unjudged}.items():
            with plain_versions(**swaps), routing(True):
                readings[fault] = compare(run(toks)[0], plain)
        path = agreement_path(ops, mode, kv_dtype, layout, n_dense, preset)
        label = {"paged": "paged agreement", "ring": "ring agreement"}.get(
            layout, "agreement") + (" fused" if fused(mode) else "") + (
            f" {kv_dtype} KV" if kv_kernels else "")
        label = f"{preset.split('_')[0]} {label}" if preset != "llama2_7b" else label
    if any(ops.launch_counts().values()) or not all(launched[k] for k in path) or any(
            launched[k] for k in launched if k not in path):
        raise AssertionError(f"agreement: kernel run launched {launched}, plain runs "
                             f"{ops.launch_counts()}")
    gemm = path[1] if path[0] == "rowquant" else path[0]
    if mode == "weight_only" and not gpt:  # the prefill (2 x n_prompt rows) and 4 decodes (2)
        want = gemm_routes(gemm, 2, [2 * n_prompt], [2] * 4)
        got = {route: routes_run[f"{gemm}_{route}"] for route in want}
        if got != want:
            raise AssertionError(f"agreement {mode}: {gemm} routes {got} != {want}")
    for name, got in readings.items():
        vs = "" if " vs " in name else " vs plain"
        log(f"{label} {str(dtype).replace('torch.', '')} (2 layers, full width, {mode}, {gemm}, "
            f"prompt {n_prompt}, {name}{vs} on the card): {json.dumps(got)}; limits "
            f"rel_l2 <= {AGREE_REL}, argmax_agree >= {AGREE_ARGMAX}")
    if gpt:
        log(f"{label} {str(dtype).replace('torch.', '')} ({mode}) routes of the plain run "
            f"with its own routing against the kernel run's: {json.dumps(divergence)}")
    failed = [name for name in must_pass if not readings[name]["pass"]]
    if failed:
        raise AssertionError(f"{label} {mode}: {failed} disagree")
    if gpt and not divergence["explained"]:
        raise AssertionError(f"{label} {mode}: a route flips on a margin above twice the "
                             f"router noise: {divergence}")
    missed = [name for name in faults if readings[name]["pass"]]
    if missed:
        raise AssertionError(f"{label} {mode}: the limits pass planted fault(s) {missed}")


# -- main ----------------------------------------------------------------------

# the KIVI updates' prefill row: the 7B chunk from 300, whose first chunk
# mixes old tail rows and new ones
KIVI_PREFILL_ROW = f"prefill B=4 KV={HEADS} S=1024 Dh={HEAD_DIM} G={KIVI_G} T=256 lengths=[300"
KERNEL_META = {  # name: (source, TPU kernel it replaces, shape of the row)
    "rowquant": ("protoquant_tpu_torch/csrc/rowquant.cu",
                 "protoquant_tpu/ops/rowquant.py:23", "M=256 K=11008 bf16"),
    "rowquant_cluster": ("protoquant_tpu_torch/csrc/rowquant.cu",
                         "protoquant_tpu/ops/rowquant.py:23", "M=4 K=11008 bf16"),
    "qmatmul": ("protoquant_tpu_torch/csrc/qmatmul.cu",
                "protoquant_tpu/ops/qmatmul.py:38", "M=256 K=4096 N=11008 bf16 out"),
    "qmatmul_decode": ("protoquant_tpu_torch/csrc/qmatmul_decode.cu",
                       "protoquant_tpu/ops/qmatmul.py:38", "M=4 K=4096 N=11008 bf16 out"),
    "kv_scatter_decode": ("protoquant_tpu_torch/csrc/kv_scatter.cu",
                          "protoquant_tpu/ops/kv_scatter.py:37", None),
    "int8_kv_attention": ("protoquant_tpu_torch/csrc/attn_split.cuh",
                          "protoquant_tpu/ops/attention.py:68", "decode"),
    "int8_kv_attention_prefill": ("protoquant_tpu_torch/csrc/attn_prefill.cuh",
                                  "protoquant_tpu/ops/attention.py:68",
                                  "prefill B=1 T=256 H=32 S=1024 lengths=[256]"),
    "weight_only_matmul": ("protoquant_tpu_torch/csrc/wo_tile.cu",
                           "protoquant_tpu/ops/wo_matmul.py:24", "M=256 K=4096 N=11008 bf16 out"),
    "weight_only_matmul_decode": ("protoquant_tpu_torch/csrc/wo_decode.cu",
                                  "protoquant_tpu/ops/wo_matmul.py:24",
                                  "M=4 K=4096 N=11008 bf16 out"),
    "paged_kv_scatter_decode": ("protoquant_tpu_torch/csrc/kv_scatter.cu",
                                "protoquant_tpu/ops/kv_scatter.py:118", None),
    "paged_int8_attention": ("protoquant_tpu_torch/csrc/paged_attention.cu",
                             "protoquant_tpu/ops/paged_attention.py:28", None),
    "paged_int8_attention_split": ("protoquant_tpu_torch/csrc/attn_split.cuh",
                                   "protoquant_tpu/ops/paged_attention.py:28",
                                   "decode B=4 H=32 KV=32 G=1"),
    "wo4_split": ("protoquant_tpu_torch/csrc/wo4_tile.cu",
                  "protoquant_tpu/ops/wo4_matmul.py:64", "M=256 K=4096 N=11008 bf16 out"),
    "wo4_split_decode": ("protoquant_tpu_torch/csrc/wo4_decode.cu",
                         "protoquant_tpu/ops/wo4_matmul.py:64", "M=4 K=4096 N=11008 bf16 out"),
    "wo4_legacy": ("protoquant_tpu_torch/csrc/wo4_matmul.cu",
                   "protoquant_tpu/ops/wo4_matmul.py:41", "M=4 K=4096 N=11008 bf16 out"),
    "w4a8_two_level": ("protoquant_tpu_torch/csrc/w4a8_tile.cu",
                       "protoquant_tpu/ops/w4a8_matmul.py:70", "M=256 K=4096 N=11008 bf16 out"),
    "w4a8_two_level_decode": ("protoquant_tpu_torch/csrc/w4a8_decode.cu",
                              "protoquant_tpu/ops/w4a8_matmul.py:70",
                              "M=4 K=4096 N=11008 bf16 out"),
    "w4a8_group": ("protoquant_tpu_torch/csrc/w4a8_group_tile.cu",
                   "protoquant_tpu/ops/w4a8_matmul.py:38", "M=256 K=4096 N=11008 bf16 out"),
    "w4a8_group_decode": ("protoquant_tpu_torch/csrc/w4a8_group_decode.cu",
                          "protoquant_tpu/ops/w4a8_matmul.py:38", "M=4 K=4096 N=11008 bf16 out"),
    "rms_norm_quant": ("protoquant_tpu_torch/csrc/fused_quant.cu",
                       "protoquant_tpu/ops/fused_quant.py:44", "M=4 K=4096 bf16"),
    "swiglu_quant": ("protoquant_tpu_torch/csrc/fused_quant.cu",
                     "protoquant_tpu/ops/fused_quant.py:56", "M=256 I=11008 silu"),
    "swiglu_quant_cluster": ("protoquant_tpu_torch/csrc/fused_quant.cu",
                             "protoquant_tpu/ops/fused_quant.py:56", "M=4 I=11008 silu"),
    "dequant": ("protoquant_tpu_torch/csrc/dequant.cu",
                "protoquant_tpu/ops/dequant.py:20", "axis=0 f32 out"),
    "k4v8_decode_update": ("protoquant_tpu_torch/csrc/kivi_update.cu",
                           "protoquant_tpu/ops/kv_scatter.py:472", None),
    "k4v8_decode_update_prefill": ("protoquant_tpu_torch/csrc/kivi_update.cu",
                                   "protoquant_tpu/ops/kv_scatter.py:472", KIVI_PREFILL_ROW),
    "k4v8_attention": ("protoquant_tpu_torch/csrc/kivi_split.cuh",
                       "protoquant_tpu/ops/attention.py:1037", "decode"),
    "k4v8_attention_prefill": ("protoquant_tpu_torch/csrc/attn_prefill.cuh",
                               "protoquant_tpu/ops/attention.py:1037", "prefill"),
    "kivi4_decode_update": ("protoquant_tpu_torch/csrc/kivi_update.cu",
                            "protoquant_tpu/ops/kv_scatter.py:205", None),
    "kivi4_decode_update_prefill": ("protoquant_tpu_torch/csrc/kivi_update.cu",
                                    "protoquant_tpu/ops/kv_scatter.py:205", KIVI_PREFILL_ROW),
    "int4_kv_attention": ("protoquant_tpu_torch/csrc/kivi_split.cuh",
                          "protoquant_tpu/ops/attention.py:495", "decode"),
    "int4_kv_attention_prefill": ("protoquant_tpu_torch/csrc/attn_prefill.cuh",
                                  "protoquant_tpu/ops/attention.py:495", "prefill"),
    "kv_mixed_scatter_decode": ("protoquant_tpu_torch/csrc/kv_scatter.cu",
                                "protoquant_tpu/ops/kv_scatter.py:362", None),
    "mixed_kv_attention": ("protoquant_tpu_torch/csrc/attn_split.cuh",
                           "protoquant_tpu/ops/attention.py:854", "decode"),
    "mixed_kv_attention_prefill": ("protoquant_tpu_torch/csrc/attn_prefill.cuh",
                                   "protoquant_tpu/ops/attention.py:854", "prefill"),
    "qmatmul_reduce_scatter_dma_decode": ("protoquant_tpu_torch/csrc/collective_matmul.cu",
                                          "protoquant_tpu/ops/collective_matmul.py:48",
                                          f"tp=2 M=4 K={HIDDEN} N={HIDDEN}"),
    "qmatmul_reduce_scatter_dma": ("protoquant_tpu_torch/csrc/collective_matmul.cu",
                                   "protoquant_tpu/ops/collective_matmul.py:48",
                                   f"tp=2 M=256 K={HIDDEN} N={HIDDEN}"),
}
# Every file of a kernel whose wrapper runs more than one source, by the
# calls that run each: a decode is the split kernel and then the merge, two
# CUDA launches that the wrapper counts as one call; a prefill chunk is one
# launch of the prefill kernel (entries of their own). The "decode" row's
# times are those of the pair.
_CSRC = "protoquant_tpu_torch/csrc/"
_MERGE = [_CSRC + "split_common.cuh", _CSRC + "split_merge.cu"]
KERNEL_SOURCES = {
    **{name + route: {"row": [_CSRC + src, _CSRC + "row_quant.cuh"]}
       for name, src in (("rowquant", "rowquant.cu"), ("swiglu_quant", "fused_quant.cu"))
       for route in ("", "_cluster")},
    **{name: {"decode": [_CSRC + "kivi_split.cuh", _CSRC + f"kivi_split_{tier}.cu",
                         _CSRC + "kivi_combine.cu", *_MERGE]}
       for name, tier in (("k4v8_attention", "k4v8"), ("int4_kv_attention", "int4"))},
    **{name + "_prefill": {"prefill": [_CSRC + "attn_prefill.cuh", _CSRC + "attn_prefill.cu",
                                       _CSRC + f"attn_prefill_kivi_{tier}.cu"]}
       for name, tier in (("k4v8_attention", "k4v8"), ("int4_kv_attention", "int4"))},
    "int8_kv_attention": {"decode": [_CSRC + f for f in (
        "attn_split.cuh", "attn_split.cu", "attn_split_int8.cu", "attn_split_ext.cu")] + _MERGE},
    "int8_kv_attention_prefill": {"prefill": [_CSRC + f for f in (
        "attn_prefill.cuh", "attn_prefill.cu", "attn_prefill_int8.cu", "attn_prefill_var.cu",
        "attn_prefill_ext.cu")]},
    "mixed_kv_attention": {"decode": [_CSRC + f for f in (
        "attn_split.cuh", "attn_split.cu", "attn_split_k8v4.cu")] + _MERGE},
    "mixed_kv_attention_prefill": {"prefill": [_CSRC + f for f in (
        "attn_prefill.cuh", "attn_prefill.cu", "attn_prefill_k8v4.cu")]},
    "paged_int8_attention_split": {"decode": [_CSRC + f for f in (
        "attn_split.cuh", "attn_split.cu", "attn_split_paged.cu")] + _MERGE},
    "qmatmul": {"prefill": [_CSRC + "qmatmul.cu", _CSRC + "sm90_gemm.cuh"]},
    "qmatmul_decode": {"decode_gemm": [_CSRC + "qmatmul_decode.cu", _CSRC + "int8_mma.cuh"]},
    **{name: {"ring": [_CSRC + "collective_matmul.cu", _CSRC + "int8_mma.cuh"]}
       for name in ("qmatmul_reduce_scatter_dma", "qmatmul_reduce_scatter_dma_decode")},
    **{name + "_decode": {"decode_gemm": [_CSRC + "int4_decode.cuh", _CSRC + f"{src}_decode.cu"]}
       for name, src in (("wo4_split", "wo4"), ("w4a8_two_level", "w4a8"),
                         ("w4a8_group", "w4a8_group"), ("weight_only_matmul", "wo"))},
    **{name: {"prefill": [_CSRC + f"{src}_tile.cu", _CSRC + "int4_tile_sm90.cuh",
                          _CSRC + "sm90_gemm.cuh"]}
       for name, src in (("wo4_split", "wo4"), ("w4a8_two_level", "w4a8"),
                         ("w4a8_group", "w4a8_group"), ("weight_only_matmul", "wo"))}}
# The entries whose launches are a route count of their wrapper under
# another name (ops.ROUTED; "qmatmul_decode", "paged_int8_attention_split"
# and the "_prefill" entries are counted under their own): the wrapper's own
# count is the routes' sum.
ROUTE_COUNT = {"qmatmul": "qmatmul_tile", "paged_int8_attention": "paged_int8_attention_walk",
               **{name: name + "_rows" for name in ROW_ROUTED},
               "qmatmul_reduce_scatter_dma": "qmatmul_reduce_scatter_dma_prefill",
               **{name: name + "_decode" for name in KIVI_WRITERS},
               **{name: name + "_split" for name in ROUTED_ATTENTIONS},
               **{name: name + "_tile" for name in ROUTED_GEMMS}}
# the decode-route entries of a routed GEMM and the cluster-route entries of
# the row kernels, by the wrapper whose cases they are in the kernel sums of
# a decode step
DECODE_GEMMS = {"qmatmul_decode": "qmatmul", **{name + "_decode": name for name in ROUTED_GEMMS},
                **{name + "_cluster": name for name in ROW_ROUTED}}


def timed(name: str, fn, *args, **kwargs):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def check_kernels(ops, gen, dev) -> dict:
    """Phase 3: every kernel body against its plain version, timed."""
    results = {}
    checks = (("rowquant", check_rowquant),
              ("qmatmul_decode", lambda *a: check_qmatmul(*a, "decode")),
              ("qmatmul", lambda *a: check_qmatmul(*a, "tile")),
              ("kv_scatter_decode", check_scatter),
              ("int8_kv_attention",
               lambda *a: check_attention(*a) + check_gemma2_attention(*a, "int8")
               + check_ring_attention(*a) + check_alibi_attention(*a, "int8")
               + check_gpt_oss_attention(*a, "int8")),
              ("weight_only_matmul", check_weight_only),
              ("paged_kv_scatter_decode", check_paged_scatter),
              ("paged_int8_attention_split",
               lambda *a: check_paged_attention(*a) + check_alibi_attention(*a, "paged")),
              ("paged_int8_attention", lambda *a: check_paged_attention(*a, "walk")),
              ("wo4_split", lambda *a: check_wo4(*a, "split")),
              ("wo4_legacy", lambda *a: check_wo4(*a, "legacy")),
              ("w4a8_two_level", lambda *a: check_w4a8(*a, "two_level")),
              ("w4a8_group", lambda *a: check_w4a8(*a, "group")),
              ("rms_norm_quant", check_rms_norm_quant),
              ("swiglu_quant", check_swiglu_quant),
              ("dequant", check_dequant),
              ("k4v8_decode_update", lambda *a: check_kivi_update(*a, "k4v8")),
              ("k4v8_attention", lambda *a: check_kivi_attention(*a, "k4v8")
               + check_gemma2_attention(*a, "k4v8") + check_alibi_attention(*a, "k4v8")
               + check_gpt_oss_attention(*a, "k4v8")),
              ("kivi4_decode_update", lambda *a: check_kivi_update(*a, "int4")),
              ("int4_kv_attention", lambda *a: check_kivi_attention(*a, "int4")
               + check_gemma2_attention(*a, "int4") + check_alibi_attention(*a, "int4")
               + check_gpt_oss_attention(*a, "int4")),
              ("kv_mixed_scatter_decode", check_mixed_scatter),
              ("mixed_kv_attention", check_mixed_attention))
    for name, fn in checks:
        cases = fn(ops, gen, dev)
        groups = {name: cases}
        if name in ROUTED_ATTENTIONS:  # the prefill kernel's cases under its own entry
            groups = {name: [c for c in cases if "prefill" not in c["shape"]],
                      name + "_prefill": [c for c in cases if "prefill" in c["shape"]]}
        elif name in KIVI_WRITERS:  # the prefill route's cases under their own entry
            groups = {name: [c for c in cases if c["route"] == "decode"],
                      name + "_prefill": [c for c in cases if c["route"] == "prefill"]}
        elif name in ROW_ROUTED:  # the cluster route's cases under their own entry
            groups = {name + "_cluster": [c for c in cases if c["route"] == "cluster"],
                      name: [c for c in cases if c["route"] == "rows"]}
        elif name in ROUTED_GEMMS:  # the decode kernel's cases under their own
            decode = [c for c in cases if c["plan"]["route"] == "decode"]
            groups = {name + "_decode": decode, name: [c for c in cases if c not in decode]}
        for key, group in groups.items():
            results[key] = group
            for c in group:
                flips = (f", flip share {c['flip_share']}, scales max rel err "
                         f"{c['scale_max_rel_err']}" if "flip_share" in c else "")
                if c.get("fault_margins"):
                    flips += f", planted faults' errors over the tolerance {c['fault_margins']}"
                if c.get("faults_differing_elements"):
                    flips += (f", {c['k_splits']} K splits" if "k_splits" in c else "") + (
                        f", planted faults' differing elements {c['faults_differing_elements']}")
                if c.get("plan"):
                    flips += f", plan {c['plan']}"
                if c.get("tiles_err_over_tol") is not None:
                    flips += (f", {c['tiles_err_over_tol']:.4f} of the tolerance from its "
                              "bf16-lane spelling")
                log(f"kernel {key} {c['shape']}: {c['ms']:.4f} ms, plain "
                    f"{c['plain_ms']:.4f} ms, library {c['library_ms']}, bound "
                    f"{c['bound_ms']:.4f} ms ({c['bound_by']}), err {c['max_abs_err']}{flips}")
        torch.cuda.empty_cache()
    return results


def run_all(ops, seed: int, dev) -> list:
    """Phases 3 to 29 on ``dev``; returns the kernels line's entries."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = timed("3 kernels", check_kernels, ops, gen, dev)

    # each main path is driven with the counts at 0 and read just after
    by_path, stats = {}, {}
    by_path["dense"], stats["dense dynamic"] = timed(
        "4 slice", run_slice, ops, seed, dev)
    for dtype in (torch.float32, torch.bfloat16):
        timed(f"5 agreement {dtype}", run_agreement, ops, seed, dev, dtype)
    by_path["paged"], stats["paged weight_only"] = timed(
        "6 paged slice", run_paged_slice, ops, seed, dev)
    for dtype in (torch.float32, torch.bfloat16):
        timed(f"7 paged agreement {dtype}", run_agreement, ops, seed, dev, dtype,
              "weight_only")
    by_path["dense_int4"], stats["dense dynamic_int4"] = timed(
        "8.1 int4 slice", run_slice, ops, seed, dev, "dynamic_int4")
    by_path["paged_int4"], stats["paged weight_only_int4"] = timed(
        "8.2 int4 paged slice", run_paged_slice, ops, seed, dev, "weight_only_int4")
    by_path["dense_int4_group"], stats["dense dynamic_int4 group"] = timed(
        "8.3 int4 slice, group", run_slice, ops, seed, dev, "dynamic_int4", "group")
    for mode, dtype, form in (("dynamic_int4", torch.float32, None),
                              ("dynamic_int4", torch.bfloat16, None),
                              ("dynamic_int4", torch.bfloat16, "group"),
                              ("weight_only_int4", torch.float32, None),
                              ("weight_only_int4", torch.bfloat16, None)):
        timed(f"9 int4 agreement {mode} {dtype} {form or ''}", run_agreement, ops,
              seed, dev, dtype, mode, form)
    by_path["dense_fused"], stats["dense dynamic fused"] = timed(
        "10 fused slice", run_slice, ops, seed, dev, "dynamic", None, "on")
    for dtype in (torch.float32, torch.bfloat16):
        timed(f"11 fused agreement {dtype}", run_agreement, ops, seed, dev, dtype,
              "dynamic", None, "on")
    by_path["dense_k4v8"], stats["dense dynamic k4v8"] = timed(
        "12 k4v8 slice", run_slice, ops, seed, dev, "dynamic", None, None, "k4v8")
    by_path["dense_int4kv"], stats["dense dynamic int4"] = timed(
        "13 int4 KV slice", run_slice, ops, seed, dev, "dynamic", None, None, "int4")
    for kv_dtype in KIVI_KERNELS:
        for dtype in (torch.float32, torch.bfloat16):
            timed(f"14 KIVI agreement {kv_dtype} {dtype}", run_agreement, ops, seed, dev,
                  dtype, "dynamic", None, None, kv_dtype)
    by_path["dense_k8v4"], stats["dense dynamic k8v4"] = timed(
        "15 k8v4 slice", run_slice, ops, seed, dev, "dynamic", None, None, "k8v4")
    for dtype in (torch.float32, torch.bfloat16):
        timed(f"16 K8V4 agreement {dtype}", run_agreement, ops, seed, dev, dtype, "dynamic",
              None, None, "k8v4")
    by_path["dense_gemma2"], stats["gemma2_9b dense dynamic"] = timed(
        "17 gemma2 slice", run_slice, ops, seed, dev, "dynamic", None, None, "int8",
        "gemma2_9b", True)
    # phase 20 serves phase 17's model, so it runs next: no other model is
    # resident beside one of them
    by_path["ring_gemma2"], stats["gemma2_9b ring"] = timed(
        "20 gemma2 hybrid ring slice", run_ring_slice, ops, seed, dev, "gemma2_9b",
        stats["gemma2_9b dense dynamic"].pop("model"))
    torch.cuda.empty_cache()
    for kv_dtype in ("int8", *KIVI_KERNELS):
        for dtype in (torch.float32, torch.bfloat16):
            timed(f"18 gemma2 agreement {kv_dtype} {dtype}", run_agreement, ops, seed, dev,
                  dtype, "dynamic", None, None, kv_dtype, "gemma2_9b")
    by_path["ring_mistral"], stats["mistral_7b ring"] = timed(
        "19 mistral ring slice", run_ring_slice, ops, seed, dev)
    for preset in ("mistral_7b", "gemma2_9b"):
        for dtype in (torch.float32, torch.bfloat16):
            timed(f"21 ring agreement {preset} {dtype}", run_agreement, ops, seed, dev, dtype,
                  "dynamic", None, None, "int8", preset, "ring")
    for path, (launches, st) in timed("22 bloom slices", run_bloom, ops, seed, dev).items():
        by_path[path], stats[path] = launches, st
    for layout, kv_dtype in (("dense", "int8"), ("paged", "int8"), ("dense", "k4v8"),
                             ("dense", "int4"), ("ring", "int8")):
        for dtype in (torch.float32, torch.bfloat16):
            timed(f"23 bloom agreement {layout} {kv_dtype} {dtype}", run_agreement, ops, seed,
                  dev, dtype, "dynamic", None, None, kv_dtype, "bloom_560m", layout)
    for path, (launches, st) in timed("24-25 gpt_oss slices", run_gpt_oss, ops, seed,
                                      dev).items():
        by_path[path], stats[path] = launches, st
    for mode in GO_AGREE_CHUNK:
        for kv_dtype in ("int8", *KIVI_KERNELS, "bf16"):
            for dtype in (torch.float32, torch.bfloat16):
                timed(f"26 gpt_oss agreement {mode} {kv_dtype} {dtype}", run_agreement, ops,
                      seed, dev, dtype, mode, None, None, kv_dtype, "gpt_oss_20b", "dense")
    ring_cases = timed("27 ring kernel", check_ring, ops, gen, dev)
    # each route's cases under its own entry, as the routed GEMMs'
    results["qmatmul_reduce_scatter_dma_decode"] = [c for c in ring_cases
                                                    if c["plan"]["route"] == "decode"]
    results["qmatmul_reduce_scatter_dma"] = [c for c in ring_cases
                                             if c["plan"]["route"] == "prefill"]
    for c in ring_cases:
        log(f"kernel qmatmul_reduce_scatter_dma {c['shape']}: {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, library (torch._int_mm, unsharded, a reading) "
            f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}), err "
            f"{c['max_abs_err']}, plan {json.dumps(c['plan'])}, planted faults' differing "
            f"elements {c['faults_differing_elements']}")
    by_path["tp"], stats["tp dynamic"] = timed(
        "28 tp slice", run_tp_slice, ops, seed, dev, stats["dense dynamic"]["outputs"])
    for tp in (2, 4):
        for dtype in (torch.float32, torch.bfloat16):
            timed(f"29 tp agreement tp={tp} {dtype}", run_tp_agreement, ops, seed, dev, dtype,
                  tp)
    ring = {c["shape"]: c["ms"] for c in ring_cases}
    steps = sorted(stats["tp dynamic"]["decode_step_ms"])
    single = sorted(stats["dense dynamic"]["decode_step_ms"])
    ring_ms = LAYERS * (ring[f"tp={TP} M=4 K={HIDDEN} N={HIDDEN}"]
                        + ring[f"tp={TP} M=4 K={INTER} N={HIDDEN}"])
    log(f"decode step, tp dynamic (tp={TP} on one card): the ring launches at the measured "
        f"shapes sum to {ring_ms:.3f} ms; engine decode step median "
        f"{steps[len(steps) // 2]:.3f} ms (phase 4: {single[len(single) // 2]:.3f} ms); peak "
        f"memory {stats['tp dynamic']['peak_gib']:.2f} GiB")
    kernels = []
    for name, cases in results.items():
        source, replaces, main_shape = KERNEL_META[name]
        head = next((c for c in cases if main_shape is None
                     or c["shape"].startswith(main_shape)), cases[0])
        key = ROUTE_COUNT.get(name, name)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(counts[key] for counts in by_path.values()),
            "launches_by_path": {p: counts[key] for p, counts in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            **({"sources": KERNEL_SOURCES[name]} if name in KERNEL_SOURCES else {}),
            **({"cuda_launches_per_decode_call": 2}
               if "decode" in KERNEL_SOURCES.get(name, {}) else {}),
            "cases": cases})

    # kernel time of one decode step at the measured decode shapes (a
    # qmatmul call at decode M runs the decode kernel)
    by = {(DECODE_GEMMS.get(n, n), c["shape"]): c["ms"] for n, cs in results.items() for c in cs}
    L = LAYERS

    def linears(name):
        return (by[(name, f"M=4 K={HIDDEN} N={HIDDEN} bf16 out")] * 4 * L
                + by[(name, f"M=4 K={HIDDEN} N={INTER} bf16 out")] * 2 * L
                + by[(name, f"M=4 K={INTER} N={HIDDEN} bf16 out")] * L
                + by[(name, f"M=4 K={HIDDEN} N={VOCAB} bf16 out")])

    rq_hidden = by[("rowquant", f"M=4 K={HIDDEN} bf16")]
    rowquant = rq_hidden * (3 * L + 1) + by[("rowquant", f"M=4 K={INTER} bf16")] * L
    # fused: rowquant for o_proj and lm_head, the producers for the rest
    producers = (rq_hidden * (L + 1) + by[("rms_norm_quant", f"M=4 K={HIDDEN} bf16")] * 2 * L
                 + by[("swiglu_quant", f"M=4 I={INTER} silu")] * L)
    def cache_ms(writer, attention):
        return (results[writer][0]["ms"] + results[attention][0]["ms"]) * L

    dense = cache_ms(*CACHE_KERNELS["int8"])
    paged = (results["paged_kv_scatter_decode"][0]["ms"] * L
             + results["paged_int8_attention_split"][0]["ms"] * L)
    for label, est in (("dense dynamic", rowquant + linears("qmatmul") + dense),
                       ("paged weight_only", linears("weight_only_matmul") + paged),
                       ("dense dynamic_int4",
                        rowquant + linears("w4a8_" + ops.resolve_w4a8_formulation()) + dense),
                       ("paged weight_only_int4", linears("wo4_split") + paged),
                       ("dense dynamic_int4 group",
                        rowquant + linears("w4a8_group") + dense),
                       ("dense dynamic fused", producers + linears("qmatmul") + dense),
                       ("dense dynamic k4v8", rowquant + linears("qmatmul")
                        + cache_ms(*KIVI_KERNELS["k4v8"])),
                       ("dense dynamic int4", rowquant + linears("qmatmul")
                        + cache_ms(*KIVI_KERNELS["int4"])),
                       ("dense dynamic k8v4", rowquant + linears("qmatmul")
                        + cache_ms(*CACHE_KERNELS["k8v4"]))):
        steps = sorted(stats[label]["decode_step_ms"])
        log(f"decode step, {label}: kernels at the measured shapes sum to {est:.3f} ms; "
            f"engine decode step median {steps[len(steps) // 2]:.3f} ms")
    # Gemma-2-9B: half the layers slide, half attend globally, at the ragged
    # decode lengths of phase 3
    gl, rq = G2_LAYERS, lambda k: by[("rowquant", f"M=4 K={k} bf16")]
    qm = lambda k, n: by[("qmatmul", f"M=4 K={k} N={n} bf16 out")]
    attn = {c["shape"].split(" B=")[0]: c["ms"] for c in results["int8_kv_attention"]}
    g2_rowquant = (rq(G2_HIDDEN) * (2 * gl + 1) + rq(G2_HEADS * G2_HEAD_DIM) * gl
                   + rq(G2_INTER) * gl)
    g2_linears = sum(qm(k, n) * count for (k, n), count in zip(
        G2_LINEAR_SHAPES, (gl, 2 * gl, gl, 2 * gl, gl, 1)))
    g2_cache = (results["kv_scatter_decode"][1]["ms"] * gl
                + (attn["gemma2 decode sliding"] + attn["gemma2 decode global"]) * gl / 2)
    steps = sorted(stats["gemma2_9b dense dynamic"]["decode_step_ms"])
    log(f"decode step, gemma2_9b dense dynamic: kernels at the measured shapes sum to "
        f"{g2_rowquant + g2_linears + g2_cache:.3f} ms (rowquant {g2_rowquant:.3f}, qmatmul "
        f"{g2_linears:.3f}, scatter and attention {g2_cache:.3f}); engine decode step median "
        f"{steps[len(steps) // 2]:.3f} ms; peak memory "
        f"{stats['gemma2_9b dense dynamic']['peak_gib']:.2f} GiB")
    # Mistral-7B over the ring: the 7B widths of its linears, the ring decode
    # of phase 3 on every layer
    mq = lambda k, n: by[("qmatmul", f"M=4 K={k} N={n} bf16 out")]
    m7_rowquant = rq_hidden * (3 * L + 1) + by[("rowquant", f"M=4 K={M7_INTER} bf16")] * L
    m7_linears = ((mq(HIDDEN, HIDDEN) + mq(HIDDEN, M7_KV * HEAD_DIM)) * 2 * L
                  + mq(HIDDEN, M7_INTER) * 2 * L + mq(M7_INTER, HIDDEN) * L + mq(HIDDEN, VOCAB))
    m7_attn = next(c["ms"] for c in results["int8_kv_attention"]
                   if c["shape"].startswith("ring decode B=")) * L
    steps = sorted(stats["mistral_7b ring"]["decode_step_ms"])
    log(f"decode step, mistral_7b ring dynamic: kernels at the measured shapes sum to "
        f"{m7_rowquant + m7_linears + m7_attn:.3f} ms (rowquant {m7_rowquant:.3f}, qmatmul "
        f"{m7_linears:.3f}, attention {m7_attn:.3f}); engine decode step median "
        f"{steps[len(steps) // 2]:.3f} ms; peak memory "
        f"{stats['mistral_7b ring']['peak_gib']:.2f} GiB")
    # GPT-OSS-20B: half the layers slide (window 128), half attend globally,
    # at the ragged decode lengths of phase 3; a decode step's 32 expert
    # slots make the experts' rowquant M = 32 and their products M = 1
    gq = lambda m, k, n: by[("qmatmul", f"M={m} K={k} N={n} bf16 out")]
    go_attn = {c["shape"].split(" B=")[0]: c["ms"] for c in results["int8_kv_attention"]}
    go_rowquant = (rq(GO_HIDDEN) * (GO_LAYERS + 1) + rq_hidden * GO_LAYERS
                   + by[("rowquant", f"M={GO_EXPERTS} K={GO_HIDDEN} bf16")] * 2 * GO_LAYERS)
    go_linears = (gq(4, *GO_LINEAR_SHAPES[0]) + 2 * gq(4, *GO_LINEAR_SHAPES[1])
                  + gq(4, *GO_LINEAR_SHAPES[2])) * GO_LAYERS + gq(4, *GO_LINEAR_SHAPES[3])
    go_experts = sum(gq(1, k, n) for k, n in GO_EXPERT_SHAPES) * GO_EXPERTS * GO_LAYERS
    go_cache = (results["kv_scatter_decode"][2]["ms"] * GO_LAYERS
                + (go_attn["gpt_oss decode sliding"] + go_attn["gpt_oss decode global"])
                * GO_LAYERS / 2)
    for path in ("gpt_oss_dense", "gpt_oss_k4v8", "gpt_oss_int4"):
        steps = sorted(stats[path]["decode_step_ms"])
        extra = (f"kernels at the measured shapes sum to "
                 f"{go_rowquant + go_linears + go_experts + go_cache:.3f} ms (rowquant "
                 f"{go_rowquant:.3f}, projections {go_linears:.3f}, experts {go_experts:.3f}, "
                 f"scatter and attention {go_cache:.3f}); " if path == "gpt_oss_dense" else "")
        log(f"decode step, {path}: {extra}engine decode step median "
            f"{steps[len(steps) // 2]:.3f} ms; peak memory {stats[path]['peak_gib']:.2f} GiB; "
            f"expert assignments dropped {stats[path]['dropped_share']:.4f}")
    # a reading, not a gate: the hybrid ring serves phase 17's prompts with
    # the same function, its sums in another order
    pairs = [(a, b) for o, r in zip(stats["gemma2_9b ring"]["outputs"],
                                    stats["gemma2_9b dense dynamic"]["outputs"])
             for a, b in zip(o, r)]
    steps = sorted(stats["gemma2_9b ring"]["decode_step_ms"])
    log(f"gemma2_9b hybrid ring: decode step median {steps[len(steps) // 2]:.3f} ms; "
        f"{sum(a == b for a, b in pairs)} of {len(pairs)} generated tokens equal to phase 17's "
        f"({sum(a == b for a, b in pairs) / len(pairs):.4f})")
    # a reading, not a gate: codes of the fused producers may move by one
    # step against the unfused path's, and greedy tokens with them
    pairs = [(a, b) for o, r in zip(stats["dense dynamic fused"]["outputs"],
                                    stats["dense dynamic"]["outputs"])
             for a, b in zip(o, r)]
    log(f"fused slice: {sum(a == b for a, b in pairs)} of {len(pairs)} generated tokens "
        f"equal to phase 4's ({sum(a == b for a, b in pairs) / len(pairs):.4f})")
    for kv_dtype in (*KIVI_KERNELS, "k8v4"):
        pairs = [(a, b) for o, r in zip(stats[f"dense dynamic {kv_dtype}"]["outputs"],
                                        stats["dense dynamic"]["outputs"])
                 for a, b in zip(o, r)]
        log(f"{kv_dtype} KV slice: {sum(a == b for a, b in pairs)} of {len(pairs)} generated "
            f"tokens equal to phase 4's ({sum(a == b for a, b in pairs) / len(pairs):.4f})")
    return kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 1
    try:
        from protoquant_tpu_torch import ops
        from protoquant_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repo root",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda:0")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
        log(card)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
            f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

        t0 = time.perf_counter()
        _build.lib(verbose=True)
        log(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
            f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s)")

        kernels = run_all(ops, args.seed, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:  # any phase failing fails the run, with its traceback
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
