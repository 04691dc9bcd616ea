"""A/B timing of the row kernels (rowquant, swiglu_quant) on the card.

    python3 tools/rowquant_timing.py --extract REV --out DIR
    python3 tools/rowquant_timing.py --parent DIR [--sweep]
    python3 tools/rowquant_timing.py --sass

``--extract`` (in a git checkout) writes the row kernels' sources as they
were at commit REV (``git show REV:<path>`` of each of PARENT_FILES) into
DIR, for a later run on the card, whose copy of the checkout has no git.

On the card it builds this checkout's ``csrc/rowquant.cu`` and
``csrc/fused_quant.cu`` alone (into ``_build/row/``: seconds of nvcc) and
the parent's from DIR alone (into ``_build/row_parent/``; the parent's
entries take no plan: one block of 256 threads a row, the row staged as f32
in shared memory), and prints one JSON line: the card, and for each case of
``chip_smoke.ROWQUANT_CASES`` and ``chip_smoke.SWIGLU_CASES`` the parent's
and this checkout's device time a call (``chip_smoke.bench``: a CUDA graph
of 20 calls cycling through input copies larger than the L2), timed in
turns parent, change, change, parent, with each one's exactness against the
plain version (rowquant: codes and scales equal; swiglu_quant: the share of
codes that differ, and whether the scales are equal), the plan and the
bound.

``--sweep`` times, instead, this checkout's kernels at every plan (blocks a
row 1 to 8, the 16-byte vectors a thread 1, 2, 4 or 8 and the threads
that holds) at the decode and prefill shapes of SWEEP_SHAPES, labelled
blocks x threads x vectors, through
``ops.rowquant.rowquant_launch`` and ``ops.fused_quant.swiglu_quant_launch``,
each plan checked bit for bit against the plain version: the data the
plan's constants (``ops.rowquant``) come from.

``--sass`` prints, instead, each bf16 row kernel's SASS (``cuobjdump``
beside ``nvcc``): its instructions by opcode, a measure of what a code
costs (the IEEE division ``__fdiv_rn``: MUFU.RCP, its FFMA refinement and
the FCHK test and branch to its slow path).
"""

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_REL = "protoquant_tpu_torch/csrc"
PARENT_FILES = ("common.cuh", "rowquant.cu", "fused_quant.cu")
# the parent's entries (no plan): x, x_dtype, xq, sx, M, K, stream; gate,
# up, dtype, hq, sh, M, K, act, cast_dtype, stream
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {"pq_rowquant": [_P, _I, _P, _P, _I, _I, _P],
                     "pq_swiglu_quant": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P]}
ROW_ENTRIES = ("pq_rowquant", "pq_swiglu_quant", "pq_rms_norm_quant")
# --sweep: (inputs, M, K): rowquant (1) and swiglu_quant (2) at the decode
# rows of the 7B, Gemma-2 and GPT-OSS widths and the tp = 2 shard, and at
# prefill rows
SWEEP_SHAPES = tuple((1, m, k) for m in (1, 4, 8, 16, 32, 64)
                     for k in (2880, 4096, 5504, 11008, 14336)) + tuple(
    (2, m, k) for m in (1, 4, 8, 16, 32) for k in (2880, 5504, 11008, 14336)) + tuple(
    (i, m, k) for i in (1, 2) for m in (256, 1024) for k in (4096, 11008))
SWEEP_BLOCKS = (1, 2, 3, 4, 6, 8)


def extract(rev: str, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    for name in PARENT_FILES:
        src = subprocess.run(["git", "show", f"{rev}:{CSRC_REL}/{name}"], cwd=HERE, check=True,
                             capture_output=True).stdout
        with open(os.path.join(out, name), "wb") as f:
            f.write(src)


def build_alone(sources, include: str, name: str, signatures: dict) -> ctypes.CDLL:
    """``sources`` built into one library ``_build/<name>/lib<name>.so`` of
    this checkout, with ``include`` on the include path."""
    from protoquant_tpu_torch.ops import _build

    out = _build.BUILD_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
                           include, *map(str, sources), "-o", str(so)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of {name} failed:\n{log}")
    lines, entry, usage = log.splitlines(), "", []
    for ln in lines:  # each kernel's registers and spills, as ptxas -v prints them
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln or ("spill" in ln and " 0 bytes spill" not in ln):
            usage.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    print(f"[nvcc {name}]" + "".join("\n  " + u for u in usage), file=sys.stderr, flush=True)
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in signatures.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def use_checkout_alone() -> None:
    """This checkout's row kernels built alone and loaded as the wrappers'
    library (the other entries are absent from it)."""
    from protoquant_tpu_torch.ops import _build

    lib = build_alone([_build.CSRC / "rowquant.cu", _build.CSRC / "fused_quant.cu"],
                      str(_build.CSRC), "row",
                      {k: _build.SIGNATURES[k] for k in ROW_ENTRIES})
    _build.lib = lambda verbose=False: lib


def sass_counts() -> dict:
    """{kernel: {opcode: count}} of this checkout's bf16 row kernels, from
    cuobjdump -sass of the library use_checkout_alone built."""
    import collections
    import re

    from protoquant_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.BUILD_DIR / "row" / "librow.so")],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n")[0].strip()
        if "bfloat16" in name and "rms_norm" not in name:
            ops_ = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body)
            out[name] = dict(collections.Counter(o.split(".")[0] for o in ops_).most_common())
    return out


def ab_cases(cs, ops, parent, gen, dev) -> dict:
    """Every phase-3 case, parent and change in turns (A, B, B, A)."""
    from protoquant_tpu_torch.ops import _build

    bf, code = torch.bfloat16, _build.DTYPE_CODES[torch.bfloat16]
    out = {}

    def parent_rowquant(x):
        m, k = x.shape
        xq = torch.empty(m, k, dtype=torch.int8, device=dev)
        sx = torch.empty(m, dtype=torch.float32, device=dev)
        _build.check(parent.pq_rowquant(x.data_ptr(), code, xq.data_ptr(), sx.data_ptr(), m, k,
                                        _build.stream_ptr(dev)), "parent pq_rowquant")
        return xq, sx

    def parent_swiglu(g, u, act):
        m, k = g.shape
        hq = torch.empty(m, k, dtype=torch.int8, device=dev)
        sh = torch.empty(m, dtype=torch.float32, device=dev)
        _build.check(parent.pq_swiglu_quant(g.data_ptr(), u.data_ptr(), code, hq.data_ptr(),
                                            sh.data_ptr(), m, k, {"silu": 0, "gelu": 1}[act],
                                            code, _build.stream_ptr(dev)), "parent pq_swiglu_quant")
        return hq, sh

    def readings(got, ref):
        (q, s), (rq, rs) = got, ref
        torch.cuda.synchronize()
        return {"flip_share": (q != rq).float().mean().item(),
                "max_step": (q.int() - rq.int()).abs().max().item(),
                "scales_equal": bool(torch.equal(s, rs))}

    def turns(a, b):
        ta1, tb1, tb2, ta2 = cs.bench(a), cs.bench(b), cs.bench(b), cs.bench(a)
        return {"parent_ms": [ta1, ta2], "change_ms": [tb1, tb2]}

    for m, k in cs.ROWQUANT_CASES:
        xs = [torch.randn(m, k, generator=gen, device=dev).to(bf)
              for _ in range(cs.copies_for(m * k * 2))]
        ref = ops.rowquant_ref(xs[0])
        row = {"plan": cs.row_plan_of(m, k)._asdict(),
               "bound_ms": cs.bound_ms(m * k * 3 + 4 * m, 0, cs.INT8_OPS_PER_S)[0],
               "parent": readings(parent_rowquant(xs[0]), ref),
               "change": readings(ops.rowquant(xs[0]), ref)}
        row.update(turns([lambda x=x: parent_rowquant(x) for x in xs],
                         [lambda x=x: ops.rowquant(x) for x in xs]))
        out[f"rowquant M={m} K={k} bf16"] = row
        del xs
    for m, k, act in cs.SWIGLU_CASES:
        pairs = [tuple((torch.randn(m, k, generator=gen, device=dev) * 2).to(bf)
                       for _ in range(2)) for _ in range(cs.copies_for(4 * m * k))]
        ref = ops.swiglu_quant_ref(*pairs[0], act=act)
        row = {"plan": cs.row_plan_of(m, k)._asdict(),
               "bound_ms": cs.bound_ms(4 * m * k + m * k + 4 * m, 0, cs.INT8_OPS_PER_S)[0],
               "parent": readings(parent_swiglu(*pairs[0], act), ref),
               "change": readings(ops.swiglu_quant(*pairs[0], act=act), ref)}
        row.update(turns([lambda p=p: parent_swiglu(*p, act) for p in pairs],
                         [lambda p=p: ops.swiglu_quant(*p, act=act) for p in pairs]))
        out[f"swiglu_quant M={m} I={k} {act}"] = row
        del pairs
    return out


def sweep(cs, ops, gen, dev) -> dict:
    """Every plan at SWEEP_SHAPES: {shape: {"plan": the plan's, "ms":
    {"blocks x threads x vectors": ms}}}; a plan that is not bit for bit
    raises."""
    from protoquant_tpu_torch.ops.fused_quant import swiglu_quant_launch

    R = importlib.import_module("protoquant_tpu_torch.ops.rowquant")

    bf = torch.bfloat16
    out = {}
    for inputs, m, k in SWEEP_SHAPES:
        n = 2 if inputs == 1 else 4
        ins = [tuple(torch.randn(m, k, generator=gen, device=dev).to(bf) for _ in range(inputs))
               for _ in range(cs.copies_for(n * m * k))]
        if inputs == 1:
            ref = ops.rowquant_ref(*ins[0])
            launch = lambda t, plan: R.rowquant_launch(*t, plan)  # noqa: E731
        else:
            ref = ops.swiglu_quant_ref(*ins[0])
            launch = lambda t, plan: swiglu_quant_launch(*t, plan=plan)  # noqa: E731
        nvec, times = k // 8, {}
        for blocks in SWEEP_BLOCKS:
            share = -(-nvec // blocks)
            if blocks > 1 and (m * blocks > 16 * 132 or share < 16):
                continue
            for r in R.VECTORS:
                threads = max(32, (-(-share // r) + 31) // 32 * 32)
                if threads > R.MAX_THREADS[r] or (r > 1 and share < 32 * r // 2):
                    continue
                plan = R.RowPlan("rows" if blocks == 1 else "cluster", blocks, threads, r)
                q, s, _ = launch(ins[0], plan)
                torch.cuda.synchronize()
                if not (torch.equal(q, ref[0]) and torch.equal(s, ref[1])):
                    raise AssertionError(f"sweep inputs={inputs} M={m} K={k} {plan}: differs")
                times["x".join(map(str, plan[1:]))] = cs.bench(
                    [lambda t=t, plan=plan: launch(t, plan) for t in ins])
        plan = R.rowquant_plan(m, k, 2)
        best = min(times, key=times.get)
        out[f"{'rowquant' if inputs == 1 else 'swiglu_quant'} M={m} K={k}"] = {
            "plan": "x".join(map(str, plan[1:])), "best": best,
            "best_ms": times[best], "ms": times}
        del ins
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--extract", default=None, metavar="REV")
    parser.add_argument("--out", default=None)
    parser.add_argument("--parent", default=None)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args()
    if args.extract:
        extract(args.extract, args.out)
        return 0
    if not torch.cuda.is_available():
        print("rowquant_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # its cases and helpers, from this checkout

    from protoquant_tpu_torch import ops

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    line = {"card": smi.stdout.strip()}
    use_checkout_alone()
    if args.sass:
        line["sass"] = sass_counts()
    elif args.sweep:
        line["sweep"] = sweep(cs, ops, gen, dev)
    else:
        parent_dir = os.path.abspath(args.parent)
        parent = build_alone([os.path.join(parent_dir, f) for f in PARENT_FILES[1:]],
                             parent_dir, "row_parent", PARENT_SIGNATURES)
        line["cases"] = ab_cases(cs, ops, parent, gen, dev)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
