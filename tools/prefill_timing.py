"""Device time of the prefill steps of the int4 and weight-only engine paths
of one checkout on the card.

    python3 tools/prefill_timing.py [--tree DIR] [--label NAME] [--layers N]
                                    [--paths weight_only:paged,dynamic:dense:int4,...]

Imports protoquant_tpu_torch from DIR (default: the checkout holding this
script) and builds Llama-2-7B at its widths and N layers (default 32) with
random weights from a seed, in "dynamic_int4" (W4A8, the dense int8 cache),
"weight_only_int4" and "weight_only" (int8 weights; both over the paged
int8 cache), or the paths ``--paths`` names as mode:layout, or
mode:layout:kv_dtype for a cache other than int8 (``dynamic:dense:k4v8``,
``dynamic:dense:int4``: the KIVI tiers). For each it serves 4
prompts of 512 tokens in prefill chunks of 256 once to warm up, then again
under torch.profiler until every prompt has been prefilled, and prints one
JSON line: the card, and for each path the prefill steps' mean wall time
(host clock around each step and a synchronize), device busy time (the sum
of the kernels' device time) and the largest kernels' device time, per step;
and the same for the DECODE_STEPS decode steps that follow (4 slots at
contexts of ~513 tokens). ``dynamic_int4`` runs the W4A8 formulation that
``W4A8_FORMULATION`` names (default two_level; the line records it).
To compare two checkouts, run it on each in turns (A, B, B, A) within one
call on one card.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = (("dynamic_int4", "dense"), ("weight_only_int4", "paged"), ("weight_only", "paged"))
PROMPTS, PROMPT_LEN, CHUNK = 4, 512, 256
DECODE_STEPS = 5  # decode steps profiled after the prefill
# tokens a request: every slot still decodes after the last prefill chunk
NEW_TOKENS = PROMPTS * PROMPT_LEN // CHUNK + DECODE_STEPS + 1


def prefill_steps(mode: str, layout: str, layers: int, dev, seed: int = 0,
                  kv_dtype: str = "int8") -> dict:
    from torch.profiler import ProfilerActivity, profile

    from protoquant_tpu_torch import Engine, EngineConfig, LlamaModel, ModelConfig

    cfg = dataclasses.replace(ModelConfig.llama2_7b(), num_hidden_layers=layers)
    model = LlamaModel(cfg, mode=mode, dtype=torch.bfloat16, device=dev).init_random_(seed)
    gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (2, PROMPTS, PROMPT_LEN), generator=gen)

    def engine():
        return Engine(model, EngineConfig(max_batch_size=PROMPTS, max_seq_len=1024,
                                          prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS),
                      kv_layout=layout, kv_dtype=kv_dtype)

    def profiled(more):
        """Steps while ``more()``, under the profiler: the wall times and
        the device's kernel rows."""
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            while more():
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
        return walls, [e for e in prof.key_averages() if e.device_type
                       == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]

    def summary(walls, rows):
        steps = len(walls)
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
        return {"steps": steps, "wall_ms_per_step": sum(walls) / steps,
                "busy_ms_per_step": sum(e.self_device_time_total for e in rows) / 1e3 / steps,
                "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / steps
                                            for e in top}}

    warm = engine()
    for p in prompts[0]:
        warm.add_request(p.tolist())
    warm.run()
    torch.cuda.synchronize()
    eng = engine()
    for p in prompts[1]:
        eng.add_request(p.tolist())
    out = {"layers": layers,
           **summary(*profiled(lambda: bool(eng.prefilling or eng.waiting)))}
    left = [DECODE_STEPS]

    def decoding():  # the next DECODE_STEPS steps: every slot decodes
        left[0] -= 1
        return left[0] >= 0 and eng.has_work()

    out["decode"] = summary(*profiled(decoding))
    del model, warm, eng
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--label", default="")
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--paths", default=",".join(f"{m}:{l}" for m, l in PATHS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("prefill_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    from protoquant_tpu_torch import ops

    line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(),
            "w4a8_formulation": ops.resolve_w4a8_formulation()}
    for path in args.paths.split(","):
        mode, layout, *kv = path.split(":")
        line[" ".join([mode, layout, *kv])] = prefill_steps(mode, layout, args.layers, dev,
                                                            kv_dtype=(kv or ["int8"])[0])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
