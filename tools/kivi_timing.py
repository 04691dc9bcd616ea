"""Time the KIVI cache updates (K4V8, Int4) of one checkout on the card.

    python3 tools/kivi_timing.py [--tree DIR] [--label NAME] [--ablate]

Imports protoquant_tpu_torch from DIR (default: the checkout holding this
script) and prints one JSON line: the card, and for each tier and each case
of ``chip_smoke.KIVI_UPDATE_CASES`` (decode at Llama-2-7B's and GPT-OSS-20B's
cache shapes, an insert-only step at both, prefill chunks of 256 at 7B from 0
and 300 and at GPT-OSS's shape) the ms a call:

- ``graph_ms``: device time, ``chip_smoke.bench`` (a CUDA graph of 20
  calls, CUDA events), where the call can be captured;
- ``eager_ms``: CUDA events around 20 calls launched one after another
  (``chip_smoke.bench_synced``), the host's launch and Python time
  included where it outruns the card.

The call is the tree's update where it takes the case: every decode, and a
prefill chunk where the tree's wrapper has a prefill route. A tree whose
caches still write a prefill chunk in plain PyTorch (``_prefill`` of its
KIVI cache) is timed through that method, eager only (its boolean masks
synchronise, so it cannot be captured). ``plain_eager_ms`` is the plain
version's eager time where the tree has it for the route; ``exact`` says
whether the call left all eight cache tensors equal to the plain version's.
To compare two checkouts, run it on each in turns (A, B, B, A) within one
call on one card:

    python3 tools/kivi_timing.py --tree scratch_tree/parent --label parent

``--ablate`` builds ``csrc/kivi_update.cu`` alone in each variant of
ABLATIONS (``-DPQ_KU_ABLATE``: 1 staging and tails alone, 2 codes by IEEE
division) into the checkout's ``_build/ablate/`` and prints, instead, each
variant's ``graph_ms`` and exactness at every case (the kernel itself as
variant "kernel", built the same way).
"""

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABLATIONS = {"kernel": [], "staging and tails alone": ["-DPQ_KU_ABLATE=1"],
             "IEEE division": ["-DPQ_KU_ABLATE=2"]}
ENTRIES = ("pq_k4v8_decode_update", "pq_kivi4_decode_update")


def ablation_libs(tree):
    """``kivi_update.cu`` built alone in each variant of ABLATIONS: {variant:
    library}."""
    import ctypes

    from protoquant_tpu_torch.ops import _build

    build = os.path.join(os.path.abspath(tree), "protoquant_tpu_torch", "_build", "ablate")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for i, (name, flags) in enumerate(ABLATIONS.items()):
        so = os.path.join(build, f"libpq_kivi_update_ablate_{i}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-I", str(_build.CSRC),
             str(_build.CSRC / "kivi_update.cu"), "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of kivi_update variant {name} failed:\n{log}")
        lib = ctypes.CDLL(so)
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--label", default="")
    parser.add_argument("--ablate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kivi_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # its cases and helpers, from this checkout

    sys.path.insert(0, os.path.abspath(args.tree))
    from protoquant_tpu_torch import ops
    from protoquant_tpu_torch.models import Int4KVCache, K4V8KVCache
    from protoquant_tpu_torch.ops import kv_scatter

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    has_prefill_route = hasattr(kv_scatter, "kivi_prefill_update_ref")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(),
            "prefill_route": has_prefill_route}
    G = cs.KIVI_G

    def time_cases(plain_too=True):
        out = {}
        for tier, cls in (("k4v8", K4V8KVCache), ("int4", Int4KVCache)):
            name = cs.KIVI_KERNELS[tier][0]
            writer, plain = getattr(ops, name), getattr(ops, name + "_ref")
            for label, KV, S, Dh, T, lens, advs, _ in cs.KIVI_UPDATE_CASES:
                B = len(lens)
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                adv = torch.tensor(advs, dtype=torch.int32, device=dev)
                rows = [torch.randint(-127, 128, (B, T, KV, Dh), generator=gen, device=dev,
                                      dtype=torch.int8) for _ in range(2)]
                scales = [torch.rand(B, T, KV, generator=gen, device=dev) * 0.02 + 1e-3
                          for _ in range(2)]
                k8, v8, ks, vs = *rows, *scales
                new = [t.transpose(1, 2) for t in (k8, ks, v8, vs)]
                base = cs._kivi_cache(gen, dev, tier, B, KV, S, Dh)
                cache = [t.clone() for t in base]
                row = {}
                if T == 1 or has_prefill_route:
                    call = lambda: writer(*cache, lengths, *new, group=G, adv=adv)
                    call()
                    ref = [t.clone() for t in base]
                    plain(*ref, lengths, *new, group=G, adv=adv)
                    torch.cuda.synchronize()
                    row["exact"] = all(torch.equal(x, y) for x, y in zip(cache, ref))
                    row["graph_ms"] = cs.bench([call])
                    row["eager_ms"] = cs.bench_synced([call], iters=20)
                    if T > 1 and plain_too:
                        row["plain_eager_ms"] = cs.bench_synced(
                            [lambda: plain(*ref, lengths, *new, group=G, adv=adv)])
                else:  # the tree's cache writes a prefill chunk in plain PyTorch
                    c = cls(*cache, lengths=lengths.clone(), group=G)
                    row["eager_ms"] = cs.bench_synced(
                        [lambda: c._prefill(k8, ks, v8, vs, adv)])
                out[f"{tier} {label} KV={KV} S={S} Dh={Dh} T={T} lengths={lens}"] = row
                del base, cache
                torch.cuda.empty_cache()
        return out

    if not args.ablate:
        line.update(time_cases())
    else:
        line["ablate_graph_ms"] = {}
        for variant, lib in ablation_libs(args.tree).items():
            kv_scatter._build.lib = lambda verbose=False, lib=lib: lib
            rows = time_cases(plain_too=False)
            line["ablate_graph_ms"][variant] = {k: (r["graph_ms"], r["exact"])
                                                for k, r in rows.items()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
