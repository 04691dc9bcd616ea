"""Time the int8 GEMM (qmatmul), the int4-weight GEMMs or the weight-only
int8 GEMM of one checkout on the card.

    python3 tools/gemm_timing.py [--tree DIR] [--label NAME] [--sweep]
    python3 tools/gemm_timing.py --int4 [--tree DIR] [--label NAME] [--ms 1,4,16,48,64,256,512]
                                 [--bodies two_level,split,group] [--sweep] [--plans]
                                 [--ablate]
    python3 tools/gemm_timing.py --wo [--tree DIR] [--label NAME] [--ms 1,4,16,32,48,256,512]
                                 [--sweep] [--plans] [--ablate]

    python3 tools/gemm_timing.py --ring [--tree DIR] [--label NAME] [--sweep] [--ablate]

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

With ``--int4`` it times the int4-weight GEMMs instead, through the
wrappers a model calls (so each checkout takes its own route):
``w4a8_two_level``, ``wo4_split`` and ``w4a8_group`` (or the bodies
``--bodies`` names), at Llama-2-7B's four projections (group 128) and M =
1, 4, 16, 48, 64, 256 and 512 (or ``--ms``), each beside its bound and a
library yardstick (two_level: ``torch._int_mm`` over the requantized int8
copy of W with the same epilogue, M padded to 32, and ``torch._int_mm``
alone; split: ``torch.matmul`` over a bf16 copy of the dequantized W;
group: none, no one call scales per group). ``--sweep`` (a checkout that
has the bodies' decode kernels) adds, at M = 1, 2, 4, 8, 16, 24, 32, 48 and
64, the tile kernel at its plan and, up to 32 rows, the decode kernel at
every split count (1 to 8; group's where its group sums fit a block), with
the clusters of each size the card holds at once: the data the thresholds
(``INT4_DECODE_MAX_M``, ``SPLIT_DECODE_MAX_M``, ``GROUP_DECODE_MAX_M``) and
the decode plans come from. ``--plans`` (a checkout with the TMA tile
kernels) times the tile kernels at every (tokens a tile, K splits) they
take, at M = 48, 64, 128, 256 and 512, with the clusters of each size the
card holds: the data ``int4_tile_plan``'s constants are fitted to.
``--ablate`` builds variants of the bodies' tile sources alone
(``-DPQ_I4T_ABLATE``: 1 no conversion of the codes, 2 loads alone, 3 split
and group without their group epilogue, 4 no loads, 5 two_level's per-code
requant instead of the table) and times them beside the built kernel at M =
48 and 256 at the plan; and variants of their decode sources
(``-DPQ_I4D_ABLATE``: two_level 1 the per-code requant instead of the
table, group 1 no group chain; 2 no conversion of the codes, 3 loads
alone), timed beside the built kernel at M = 4 at the plan's splits.

With ``--wo`` it times ``ops.weight_only_matmul`` instead, through the
wrapper (so each checkout takes its own route), at Llama-2-7B's four
projections and M = 1, 4, 16, 32, 48, 256 and 512 (or ``--ms``), each beside
its bound and ``torch.matmul`` over a bf16 copy of W. ``--sweep`` (a
checkout with the split-K decode kernel, ``ops.wo_matmul.weight_only_launch``)
adds, at M = 16, 24, 32, 48 and 64, the tile kernel at its plan and, up to
32 rows, the decode kernel at every split count with the clusters each
size the card holds: the data ``WO_DECODE_MAX_M`` comes from. ``--plans``
times the tile kernel at every (tokens a tile, K splits) it takes at M =
48, 64, 128, 256 and 512: the data ``WO_TILE_STAGE_US`` is fitted to.
``--ablate`` builds ``wo_tile.cu`` alone with ``-DPQ_I4T_ABLATE`` (1 no code
conversion, 2 loads alone, 4 no loads), timed at M = 48 and 256 at the
plan, and ``wo_decode.cu``
with ``-DPQ_WOD_ABLATE`` (1 no conversion, 2 loads alone, 3 no loads), timed
at M = 4 at the plan's splits.

With ``--ring`` it times the ring reduce-scatter matmul instead
(``ops.qmatmul_reduce_scatter_dma_all``, all ranks sharing the card, one
launch a call) at the eight shapes of ``chip_smoke.py``'s phase 27 (tp 2 and
4, Llama-2-7B's o_proj and down_proj, M 4 and 256), each beside its bound,
and, as a reading, ``torch._int_mm`` of the unsharded product (M padded to
32), through ``chip_smoke.bench_eager`` (launches behind a sleep: a call
cannot be captured in a CUDA graph). It builds ``collective_matmul.cu``
alone (into the checkout's ``_build/ring/``), so an A/B of two checkouts in
one call takes seconds of ``nvcc``, not minutes. A checkout with the split-K
ring (``ops.collective_matmul.ring_launch``) also reports each shape's plan;
``--sweep`` times it at every K split the card holds; ``--ablate`` builds
``collective_matmul.cu`` with ``-DPQ_RING_ABLATE`` (1 the prefill route's
tokens read from global memory, not staged; 2 no flags; 3 no hop; 4 loads
alone) into ``_build/ablate/`` and times each at the plan's split (or the
most splits its grid holds whole).
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
INT4_MS = (1, 4, 16, 48, 64, 256, 512)
INT4_BODIES = ("two_level", "split", "group")
INT4_SWEEP_MS = (1, 2, 4, 8, 16, 24, 32, 48, 64)
INT4_PLAN_MS = (48, 64, 128, 256, 512)
# the tile sources' variants, by -DPQ_I4T_ABLATE value, and the bodies each
# applies to
ABLATIONS = {1: ("no code conversion", INT4_BODIES), 2: ("loads alone", INT4_BODIES),
             3: ("no group epilogue", ("split", "group")), 4: ("no loads", INT4_BODIES),
             5: ("per-code requant, no table", ("two_level",))}
# the decode sources' variants, by -DPQ_I4D_ABLATE value: {body: label}
DECODE_ABLATIONS = {1: {"two_level": "per-code requant, no table", "group": "no group chain"},
                    2: dict.fromkeys(INT4_BODIES, "no code conversion"),
                    3: dict.fromkeys(INT4_BODIES, "loads alone")}
# each body's tile and decode sources, entries and wrapper
INT4_SOURCES = {"two_level": ("w4a8_tile.cu", "w4a8_decode.cu"),
                "split": ("wo4_tile.cu", "wo4_decode.cu"),
                "group": ("w4a8_group_tile.cu", "w4a8_group_decode.cu")}
INT4_ENTRIES = {"two_level": ("pq_w4a8_two_level", "pq_w4a8_two_level_decode"),
                "split": ("pq_wo4_split", "pq_wo4_split_decode"),
                "group": ("pq_w4a8_group_tile", "pq_w4a8_group_decode")}
WO_MS = (1, 4, 16, 32, 48, 256, 512)
WO_SWEEP_MS = (16, 24, 32, 48, 64)
WO_PLAN_MS = (48, 64, 128, 256, 512)
# the tile source's variants (-D flags) and the decode source's
WO_TILE_ABLATIONS = {"no code conversion": "-DPQ_I4T_ABLATE=1", "loads alone": "-DPQ_I4T_ABLATE=2",
                     "no loads": "-DPQ_I4T_ABLATE=4"}
WO_DECODE_ABLATIONS = {"no code conversion": "-DPQ_WOD_ABLATE=1",
                       "loads alone": "-DPQ_WOD_ABLATE=2", "no loads": "-DPQ_WOD_ABLATE=3"}
# the ring source's variants, by -DPQ_RING_ABLATE value
RING_ABLATIONS = {1: "prefill tokens from global, no staging", 2: "no flags", 3: "no hop",
                  4: "loads alone"}
RING_ENTRIES = ("pq_ring_qmatmul_rs", "pq_ring_qmatmul_rs_clusters")


def ring_build_alone():
    """Build and load only ``collective_matmul.cu`` of the imported
    checkout, into its ``_build/ring/``: the ring's entries, nothing else."""
    from protoquant_tpu_torch.ops import _build

    _build.BUILD_DIR = _build.BUILD_DIR / "ring"
    _build._sources = lambda: [_build.CSRC / "collective_matmul.cu"]
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items() if k in RING_ENTRIES}
    return _build.lib()


def ring_shapes(cs):
    """Phase 27's shapes: (tp, M, K, N)."""
    return [(tp, m, k, n) for tp in (2, 4) for k, n in cs.TP_SHAPES for m in (4, 256)]


def ring_times(cs, ops, gen, dev, sweep=False, ablate_tree=None):
    """{shape: ms} of the wrapper, with its bound, the ``torch._int_mm``
    reading and, for a split-K checkout, the plan, the sweep and the
    ablations."""
    from protoquant_tpu_torch.ops import _build

    C = importlib.import_module("protoquant_tpu_torch.ops.collective_matmul")
    split_k = hasattr(C, "ring_launch")
    libs = _ring_ablation_libs(ablate_tree) if ablate_tree else {}
    out = {"ms": {}, "int_mm_ms": {}, "bound_ms": {}, "plan": {}, "sweep_ms": {},
           "ablate_ms": {}}
    for tp, m, k, n in ring_shapes(cs):
        label = f"tp={tp} M={m} K={k} N={n}"
        copies = [cs._ring_operands(gen, dev, tp, m, k, n, True)
                  for _ in range(cs.copies_for(n * k))]
        out["ms"][label] = cs.bench_eager([lambda c=c: ops.qmatmul_reduce_scatter_dma_all(*c)
                                           for c in copies])
        xpad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
        xpad[:m] = torch.cat(copies[0][0], 1)
        full = [torch.cat(c[2], 1) for c in copies]
        out["int_mm_ms"][label] = cs.bench([lambda w=w: torch._int_mm(xpad, w.t())
                                            for w in full])
        out["bound_ms"][label] = cs.bound_ms(n * k + m * k + 4 * tp * (m + n) + 4 * m * n,
                                             2 * m * n * k, cs.INT8_OPS_PER_S)[0]
        if split_k:
            plan = C.ring_plan_of(copies[0][0], copies[0][2])
            clusters = C.ring_tiles(n // tp) * tp
            out["plan"][label] = {"route": C.ring_route(m), "k_splits": plan,
                                  "clusters": clusters, "blocks": clusters * plan}
            if sweep:
                held = C.ring_held(dev, C.ring_fragments(m), tp)
                steps = -(-(k // tp) // C.DECODE_STEP)
                out["sweep_ms"][label] = {
                    s: cs.bench_eager([lambda c=c, s=s: C.ring_launch(*c, k_splits=s)
                                       for c in copies])
                    for s in range(1, 9) if (s == 1 or s <= steps) and clusters <= held[s]}
            if libs:
                row = {"kernel": out["ms"][label]}
                for v, (lib, regs) in libs.items():
                    # the plan's split, or the most the variant's grid holds whole
                    held = ctypes.c_int(0)
                    splits = plan
                    while splits > 1:
                        _build.check(lib.pq_ring_qmatmul_rs_clusters(
                            C.ring_fragments(m), tp, splits, ctypes.byref(held)),
                            "ring ablation clusters")
                        if clusters <= held.value:
                            break
                        splits -= 1
                    state = C._RingState(dev, tp, C.ring_tiles(n // tp))
                    row[RING_ABLATIONS[v]] = cs.bench_eager([
                        lambda c=c, lib=lib, state=state, s=splits: _ring_call(lib, state, c, s,
                                                                               dev)
                        for c in copies])
                    row[RING_ABLATIONS[v] + " k_splits"] = splits
                out["ablate_ms"][label] = row
                out["ablate_registers"] = {RING_ABLATIONS[v]: regs for v, (_, regs) in
                                           libs.items()}
        del copies, full
    return {k: v for k, v in out.items() if v}


def _ring_ablation_libs(tree):
    """``collective_matmul.cu`` built alone with each ``-DPQ_RING_ABLATE``
    into the checkout's ``_build/ablate/``: {variant: (library, the ring
    kernels' registers as ptxas reports them)}."""
    from protoquant_tpu_torch.ops import _build

    build = os.path.join(os.path.abspath(tree), "protoquant_tpu_torch", "_build", "ablate")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for v in RING_ABLATIONS:
        so = os.path.join(build, f"libpq_ring_ablate_{v}.so")
        procs[v] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DPQ_RING_ABLATE={v}", "-Xptxas", "-v",
             "-shared", "-I", str(_build.CSRC), str(_build.CSRC / "collective_matmul.cu"),
             "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for v, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of ring ablation {v} failed:\n{log}")
        lib = ctypes.CDLL(so)
        for name in RING_ENTRIES:
            getattr(lib, name).argtypes = _build.SIGNATURES[name]
        regs, entry = {}, None
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "ring_kernel" in line else None
            elif entry and "Used " in line:
                regs[entry] = line.split("Used ")[1].split(",")[0]
                entry = None
        libs[v] = (lib, regs)
    return libs


def _ring_call(lib, state, operands, splits, dev):
    """One launch of an ablation library's ring, its flags in ``state``."""
    from protoquant_tpu_torch.ops import _build

    C = importlib.import_module("protoquant_tpu_torch.ops.collective_matmul")
    xqs, sxs, wqs, sws = operands
    tp, (m, k), n = len(xqs), xqs[0].shape, wqs[0].shape[0]
    out = torch.empty(tp, m, n // tp, dtype=torch.float32, device=dev)
    comm, epoch = state.slots(tp, m, n // tp), state.next_epoch()
    _build.check(lib.pq_ring_qmatmul_rs(
        C._ptrs(xqs), C._ptrs(sxs), C._ptrs(wqs), C._ptrs(sws), C._ptrs(out.unbind(0)),
        C._ptrs(comm.unbind(0)), C._ptrs(state.data.unbind(0)), C._ptrs(state.credit.unbind(0)),
        tp, 0, tp, m, n, k, C.ring_fragments(m), splits, epoch, _build.stream_ptr(dev)),
        "ring ablation")
    state.epoch = epoch


def int4_operands(cs, ops, gen, dev, m, k, n, group, copies):
    """Token rows (int8 with scales, and bf16) and ``copies`` int4 weights
    with their two-level (r16, scol)."""
    xq, sx = ops.rowquant_ref(torch.randn(m, k, generator=gen, device=dev))
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    ws = [(torch.randint(-128, 128, (n, k // 2), generator=gen, device=dev, dtype=torch.int8),
           torch.rand(n, k // group, generator=gen, device=dev) * 2e-3 + 1e-4)
          for _ in range(copies)]
    return xq, sx, x, ws, [ops.two_level_scales(sc) for _, sc in ws]


def int4_times(cs, ops, gen, dev, ms, bodies=INT4_BODIES):
    """ms of the bodies through their wrappers (and the route each took,
    where the wrapper counts routes), bounds and library yardsticks, by
    "M= K= N=" label."""
    from protoquant_tpu_torch.core import numerics

    bf, group = torch.bfloat16, cs.GROUP4
    wrappers = {"two_level": ops.w4a8_two_level, "split": ops.wo4_split,
                "group": ops.w4a8_group}
    rows = {}
    for m in ms:
        for k, n in cs.LINEAR_SHAPES:
            wbytes = n * k // 2 + 4 * n * (k // group)
            xq, sx, x, ws, tls = int4_operands(cs, ops, gen, dev, m, k, n, group,
                                               cs.copies_for(wbytes))
            calls = {
                "two_level": [lambda w=w, tl=tl: ops.w4a8_matmul(
                    xq, sx, *w, group, None, bf, "two_level", tl) for w, tl in zip(ws, tls)],
                "split": [lambda w=w: ops.weight_only_int4_matmul(
                    x, *w, group, None, bf) for w in ws],
                "group": [lambda w=w: ops.w4a8_matmul(
                    xq, sx, *w, group, None, bf, "group") for w in ws]}
            row = {}
            for body in bodies:
                row[body] = cs.bench(calls[body])
                routes = getattr(wrappers[body], "routes", None)
                if routes is not None:
                    before = dict(routes)
                    calls[body][0]()
                    row["route_" + body] = next(r for r, c in routes.items() if c != before[r])
            row.update({
                "bound_two_level": cs.bound_ms(m * k + 4 * m + wbytes + 4 * n + 2 * m * n,
                                               2 * m * n * k, cs.INT8_OPS_PER_S)[0],
                "bound_split": cs.bound_ms(2 * m * k + wbytes + 2 * m * n, 2 * m * n * k,
                                           cs.BF16_FLOPS_PER_S)[0],
                "bound_group": cs.bound_ms(m * k + 4 * m + wbytes + 2 * m * n, 2 * m * n * k,
                                           cs.INT8_OPS_PER_S)[0]})
            if not {"two_level", "split"} & set(bodies):
                rows[f"M={m} K={k} N={n}"] = row
                del ws, tls
                continue
            # library yardsticks over copies of W made beforehand
            xpad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
            xpad[:m] = xq
            sx16 = (sx * 0.0625)[:, None]
            w8s = []
            for (p, _), (r16, scol) in list(zip(ws, tls))[:cs.copies_for(n * k)]:
                q = numerics.unpack_int4(p, group).float().reshape(n, -1, group)
                w8s.append((torch.round(q * r16[:, :, None]).reshape(n, k).to(torch.int8), scol))
            row["library_two_level"] = cs.bench([
                lambda w8=w8, scol=scol: ((torch._int_mm(xpad, w8.t())[:m].float() * sx16)
                                          * scol).to(bf) for w8, scol in w8s])
            row["int_mm_two_level"] = cs.bench([lambda w8=w8: torch._int_mm(xpad, w8.t())
                                                for w8, _ in w8s])
            del w8s
            wd = [numerics.dequantize_int4(p, sc, group).to(bf)
                  for p, sc in ws[:cs.copies_for(2 * n * k)]]
            row["library_split"] = cs.bench([lambda w=w: torch.matmul(x, w.t()) for w in wd])
            del wd, ws, tls
            rows[f"M={m} K={k} N={n}"] = row
    return rows


def int4_sweep(cs, ops, gen, dev, bodies=INT4_BODIES):
    """The tile kernel and the decode kernel at every split count, by M,
    at the 7B shapes; with the plan and the clusters the card holds."""
    W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
    A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
    P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")

    bf, group = torch.bfloat16, cs.GROUP4
    out = {}
    for k, n in cs.LINEAR_SHAPES:
        wbytes = n * k // 2 + 4 * n * (k // group)
        for m in INT4_SWEEP_MS:
            xq, sx, x, ws, tls = int4_operands(cs, ops, gen, dev, m, k, n, group,
                                               cs.copies_for(wbytes))
            row = {}
            if "group" in bodies:
                held = A.group_decode_held(dev, min(m, 32), k, group)
                row.update({
                    "plan_splits_group": A.group_decode_plan(min(m, 32), n, k, group, held),
                    "clusters_held_group": held,
                    "tile_plan_group": W.int4_tile_plan(m, n, k, group, sms_of(dev), "group"),
                    "tile_group": cs.bench([lambda w=w: A.w4a8_group_launch(
                        xq, sx, *w, group, None, bf) for w in ws])})
                for splits in range(1, 9):
                    if m <= 32 and held[splits] > 0:  # the decode kernel takes up to 32 rows
                        row[f"decode_group_{splits}"] = cs.bench([
                            lambda w=w: A.w4a8_group_launch(xq, sx, *w, group, None, bf, splits)
                            for w in ws])
            if not {"two_level", "split"} & set(bodies):
                out[f"M={m} K={k} N={n}"] = row
                del ws, tls
                continue
            held = {body: W.int4_decode_held(f"pq_{body}_decode", dev, min(m, 32), group)
                    for body in ("w4a8_two_level", "wo4_split")}
            plan = W.int4_decode_plan(m, n, k, group, held["w4a8_two_level"])
            row.update({
                "plan_splits": plan,
                "plan_splits_wo4_split": W.int4_decode_plan(m, n, k, group, held["wo4_split"]),
                "clusters_held": held, "clusters_launched": -(-n // P.DECODE_ROWS),
                "tile_two_level": cs.bench([lambda w=w, tl=tl: A.w4a8_two_level_launch(
                    xq, sx, w[0], *tl, group, None, bf) for w, tl in zip(ws, tls)]),
                "tile_split": cs.bench([lambda w=w: W.wo4_split_launch(
                    x, *w, group, None, bf) for w in ws])})
            units, _ = W.int4_decode_units(k, group)
            for splits in range(1, 9):
                if m > 32 or splits > units:  # the decode kernels take up to 32 rows
                    continue
                row[f"decode_two_level_{splits}"] = cs.bench([
                    lambda w=w, tl=tl: A.w4a8_two_level_launch(
                        xq, sx, w[0], *tl, group, None, bf, splits) for w, tl in zip(ws, tls)])
                row[f"decode_split_{splits}"] = cs.bench([
                    lambda w=w: W.wo4_split_launch(x, *w, group, None, bf, splits) for w in ws])
            out[f"M={m} K={k} N={n}"] = row
            del ws, tls
    return out


def sms_of(dev) -> int:
    from protoquant_tpu_torch.ops.qmatmul import _sm_count

    return _sm_count(dev)


def int4_plans(cs, ops, gen, dev, bodies=INT4_BODIES):
    """The tile kernels at every (tokens a tile, K splits) they take,
    by M, at the 7B shapes, beside the plan's choice; and the clusters of
    each size the card holds (ms)."""
    W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
    P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")
    A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
    from protoquant_tpu_torch.ops import _build
    from protoquant_tpu_torch.ops.qmatmul import _sm_count

    bf, group, sms = torch.bfloat16, cs.GROUP4, _sm_count(dev)
    held = {}
    for splits in P.TILE_SPLITS:
        count = ctypes.c_int(0)
        _build.check(_build.lib().pq_int4_tile_clusters(splits, ctypes.byref(count)), "clusters")
        held[splits] = count.value
    out = {"clusters_held": held}
    for k, n in cs.LINEAR_SHAPES:
        wbytes = n * k // 2 + 4 * n * (k // group)
        units, _ = W.int4_decode_units(k, group)
        for m in INT4_PLAN_MS:
            xq, sx, x, ws, tls = int4_operands(cs, ops, gen, dev, m, k, n, group,
                                               cs.copies_for(wbytes))
            launch = {
                "two_level": lambda w, tl, plan: A.w4a8_two_level_launch(
                    xq, sx, w[0], *tl, group, None, bf, tile=plan),
                "split": lambda w, tl, plan: W.wo4_split_launch(x, *w, group, None, bf,
                                                                tile=plan),
                "group": lambda w, tl, plan: A.w4a8_group_launch(xq, sx, *w, group, None, bf,
                                                                 tile=plan)}
            row = {}
            for body in bodies:
                row["plan_" + body] = W.int4_tile_plan(m, n, k, group, sms, body)
                for tokens in W.INT4_TILE_TOKENS[body]:
                    for splits in W.INT4_TILE_SPLITS[body]:
                        if splits > units:
                            continue
                        plan = (tokens, splits)
                        row[f"{body} {tokens}x{splits}"] = cs.bench([
                            lambda w=w, tl=tl, plan=plan, body=body: launch[body](w, tl, plan)
                            for w, tl in zip(ws, tls)])
            out[f"M={m} K={k} N={n}"] = row
            del ws, tls
    return out


def _ablation_libs(tree, kind, variants, bodies):
    """Build each body's ``kind`` source ("tile" or "decode") alone with
    ``-DPQ_I4T_ABLATE`` / ``-DPQ_I4D_ABLATE`` = each variant into the
    checkout's ``_build/ablate/``: {(variant, body): library}, variant 0
    the built library."""
    from protoquant_tpu_torch.ops import _build

    build = os.path.join(os.path.abspath(tree), "protoquant_tpu_torch", "_build", "ablate")
    os.makedirs(build, exist_ok=True)
    flag = "-DPQ_I4T_ABLATE" if kind == "tile" else "-DPQ_I4D_ABLATE"
    slot = 0 if kind == "tile" else 1
    libs, procs = {}, {}
    for body in bodies:
        libs[(0, body)] = _build.lib()
        for v, applies in variants.items():
            if body not in applies:
                continue
            so = os.path.join(build, f"libpq_ablate_{kind}_{body}_{v}.so")
            procs[(v, body)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"{flag}={v}", "-shared", "-I",
                 str(_build.CSRC), str(_build.CSRC / INT4_SOURCES[body][slot]), "-o", so, "-ldl"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of ablation {key} failed:\n{log}")
        libs[key] = ctypes.CDLL(so)
        name = INT4_ENTRIES[key[1]][slot]
        getattr(libs[key], name).argtypes = _build.SIGNATURES[name]
    return libs


def _int4_entry_args(body, xq, sx, x, w, tl, y, code, m, n, k, group):
    """The pointers and sizes of a body's entry, before its plan."""
    if body == "two_level":
        ptrs = [xq.data_ptr(), sx.data_ptr(), w[0].data_ptr(), tl[0].data_ptr(), tl[1].data_ptr()]
    elif body == "group":
        ptrs = [xq.data_ptr(), sx.data_ptr(), w[0].data_ptr(), w[1].data_ptr()]
    else:
        ptrs = [x.data_ptr(), w[0].data_ptr(), w[1].data_ptr()]
    return ptrs + [None, y.data_ptr(), code, m, n, k, group]


def int4_ablate_decode(cs, ops, gen, dev, tree, bodies=INT4_BODIES):
    """The decode kernels built with one part left out, against the built
    kernel, at M = 4 and the plan's splits (ms)."""
    W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
    A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
    from protoquant_tpu_torch.ops import _build

    bf, group, m = torch.bfloat16, cs.GROUP4, 4
    libs = _ablation_libs(tree, "decode", DECODE_ABLATIONS, bodies)
    out = {}
    code = _build.DTYPE_CODES[bf]
    for k, n in cs.LINEAR_SHAPES:
        wbytes = n * k // 2 + 4 * n * (k // group)
        xq, sx, x, ws, tls = int4_operands(cs, ops, gen, dev, m, k, n, group,
                                           cs.copies_for(wbytes))
        plans = {body: (A.group_decode_plan(m, n, k, group, A.group_decode_held(dev, m, k, group))
                        if body == "group" else W.int4_decode_plan(m, n, k, group, W.int4_decode_held(
                            INT4_ENTRIES[body][1], dev, m, group))) for body in bodies}
        y = torch.empty(m, n, dtype=bf, device=dev)
        row = {"plan_splits": plans}
        for (v, body), lib in libs.items():
            fn = getattr(lib, INT4_ENTRIES[body][1])

            def call(w, tl, fn=fn, body=body):
                _build.check(fn(*_int4_entry_args(body, xq, sx, x, w, tl, y, code, m, n, k, group),
                                plans[body], _build.stream_ptr(dev)), body)

            label = "kernel" if v == 0 else DECODE_ABLATIONS[v][body]
            row[f"{body} {label}"] = cs.bench([lambda w=w, tl=tl, call=call: call(w, tl)
                                               for w, tl in zip(ws, tls)])
        out[f"M={m} K={k} N={n}"] = row
        del ws, tls
    return out


def int4_ablate(cs, ops, gen, dev, tree, bodies=INT4_BODIES):
    """The tile kernels built with one part left out, against the built
    kernel, at M = 48 and 256 and the plan (ms)."""
    W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
    from protoquant_tpu_torch.ops import _build

    bf, group = torch.bfloat16, cs.GROUP4
    libs = _ablation_libs(tree, "tile", {v: applies for v, (_, applies) in ABLATIONS.items()},
                          bodies)
    out = {}
    code = _build.DTYPE_CODES[bf]
    for m in (48, 256):
        for k, n in cs.LINEAR_SHAPES:
            wbytes = n * k // 2 + 4 * n * (k // group)
            xq, sx, x, ws, tls = int4_operands(cs, ops, gen, dev, m, k, n, group,
                                               cs.copies_for(wbytes))
            plans = {body: W.int4_tile_plan(m, n, k, group, sms_of(dev), body) for body in bodies}
            y = torch.empty(m, n, dtype=bf, device=dev)
            row = {"plans": plans}
            for (v, body), lib in libs.items():
                fn = getattr(lib, INT4_ENTRIES[body][0])

                def call(w, tl, fn=fn, body=body):
                    _build.check(fn(*_int4_entry_args(body, xq, sx, x, w, tl, y, code, m, n, k,
                                                      group),
                                    *plans[body], _build.stream_ptr(dev)), body)

                label = "kernel" if v == 0 else ABLATIONS[v][0]
                row[f"{body} {label}"] = cs.bench([lambda w=w, tl=tl, call=call: call(w, tl)
                                                   for w, tl in zip(ws, tls)])
            out[f"M={m} K={k} N={n}"] = row
            del ws, tls
    return out


def wo_operands(cs, gen, dev, m, k, n):
    """bf16 token rows, int8 weight copies larger than the L2 together, and
    scales."""
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    ws = [torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
          for _ in range(cs.copies_for(n * k))]
    return x, ws, torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4


def wo_times(cs, ops, gen, dev, ms):
    """ms of ops.weight_only_matmul, its bound and torch.matmul over a bf16
    copy of W, by "M= K= N=" label."""
    bf = torch.bfloat16
    rows = {}
    for m in ms:
        for k, n in cs.LINEAR_SHAPES:
            x, ws, sw = wo_operands(cs, gen, dev, m, k, n)
            row = {"ms": cs.bench([lambda w=w: ops.weight_only_matmul(x, w, sw, out_dtype=bf)
                                   for w in ws]),
                   "bound": cs.bound_ms(2 * m * k + n * k + 4 * n + 2 * m * n, 2 * m * n * k,
                                        cs.BF16_FLOPS_PER_S)[0]}
            if hasattr(ops.weight_only_matmul, "routes"):
                before = dict(ops.weight_only_matmul.routes)
                ops.weight_only_matmul(x, ws[0], sw, out_dtype=bf)
                row["route"] = next(r for r, c in ops.weight_only_matmul.routes.items()
                                    if c != before[r])
            wb = [w.to(bf) for w in ws[:cs.copies_for(2 * n * k)]]
            row["library"] = cs.bench([lambda w=w: torch.matmul(x, w.t()) for w in wb])
            del ws, wb
            rows[f"M={m} K={k} N={n}"] = row
    return rows


def wo_sweep(cs, gen, dev):
    """The tile kernel at its plan and the decode kernel at every split
    count, by M, at the 7B shapes; with the plans and the clusters held."""
    W = importlib.import_module("protoquant_tpu_torch.ops.wo_matmul")
    from protoquant_tpu_torch.ops.qmatmul import _sm_count

    bf, out = torch.bfloat16, {}
    for k, n in cs.LINEAR_SHAPES:
        for m in WO_SWEEP_MS:
            x, ws, sw = wo_operands(cs, gen, dev, m, k, n)
            plan = W.wo_tile_plan(m, n, k, _sm_count(dev))
            row = {"tile_plan": plan,
                   "tile": cs.bench([lambda w=w: W.weight_only_launch(x, w, sw, None, bf, tile=plan)
                                     for w in ws])}
            if m <= 32:  # the decode kernel takes up to 32 rows
                held = W.wo_decode_held(dev, m)
                row["held"], row["decode_plan"] = held, W.wo_decode_plan(1, n, k, held)
                for splits in range(1, 9):
                    row[f"decode_{splits}"] = cs.bench([
                        lambda w=w: W.weight_only_launch(x, w, sw, None, bf, splits) for w in ws])
            out[f"M={m} K={k} N={n}"] = row
            del ws
    return out


def wo_plans(cs, gen, dev):
    """The tile kernel at every (tokens a tile, K splits), by M, at the 7B
    shapes, beside the plan's choice (ms)."""
    W = importlib.import_module("protoquant_tpu_torch.ops.wo_matmul")
    from protoquant_tpu_torch.ops.qmatmul import _sm_count

    bf, out = torch.bfloat16, {}
    for k, n in cs.LINEAR_SHAPES:
        stages = -(-k // W.WO_TILE_STEP)
        for m in WO_PLAN_MS:
            x, ws, sw = wo_operands(cs, gen, dev, m, k, n)
            row = {"plan": W.wo_tile_plan(m, n, k, _sm_count(dev))}
            for tokens in W.WO_TILE_STAGE_US:
                for splits in (1, 2, 3, 4, 6, 8):
                    if splits <= stages:
                        row[f"{tokens}x{splits}"] = cs.bench([
                            lambda w=w, plan=(tokens, splits): W.weight_only_launch(
                                x, w, sw, None, bf, tile=plan) for w in ws])
            out[f"M={m} K={k} N={n}"] = row
            del ws
    return out


def wo_ablate(cs, gen, dev, tree):
    """The two kernels built with one part left out, against the built
    kernel: the decode kernel at M = 4 at the plan's splits, the tile kernel
    at M = 48 and 256 at the plan (ms)."""
    W = importlib.import_module("protoquant_tpu_torch.ops.wo_matmul")
    from protoquant_tpu_torch.ops import _build
    from protoquant_tpu_torch.ops.qmatmul import _sm_count

    build = os.path.join(os.path.abspath(tree), "protoquant_tpu_torch", "_build", "ablate")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for kind, src, variants in (("tile", "wo_tile.cu", WO_TILE_ABLATIONS),
                                ("decode", "wo_decode.cu", WO_DECODE_ABLATIONS)):
        for label, flag in variants.items():
            so = os.path.join(build, f"libpq_wo_{kind}_{flag[2:].replace('=', '_')}.so")
            procs[(kind, label)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, flag, "-shared", "-I", str(_build.CSRC),
                 str(_build.CSRC / src), "-o", so, "-ldl"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {("tile", "kernel"): _build.lib(), ("decode", "kernel"): _build.lib()}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of ablation {key} failed:\n{log}")
        libs[key] = ctypes.CDLL(so)
        name = f"pq_weight_only_{key[0]}"
        getattr(libs[key], name).argtypes = _build.SIGNATURES[name]
    bf = torch.bfloat16
    code, out = _build.DTYPE_CODES[bf], {}
    for m in (4, 48, 256):
        kind = "decode" if m == 4 else "tile"
        for k, n in cs.LINEAR_SHAPES:
            x, ws, sw = wo_operands(cs, gen, dev, m, k, n)
            tail = ([W.wo_decode_plan(m, n, k, W.wo_decode_held(dev, m))] if kind == "decode"
                    else list(W.wo_tile_plan(m, n, k, _sm_count(dev))))
            y = torch.empty(m, n, dtype=bf, device=dev)
            row = {"plan": tail}
            for (kd, label), lib in libs.items():
                if kd != kind:
                    continue
                fn = getattr(lib, f"pq_weight_only_{kind}")

                def call(w, fn=fn):
                    _build.check(fn(x.data_ptr(), w.data_ptr(), sw.data_ptr(), None, y.data_ptr(),
                                    code, m, n, k, *tail, _build.stream_ptr(dev)), "ablation")

                row[label] = cs.bench([lambda w=w, call=call: call(w) for w in ws])
            out[f"M={m} K={k} N={n}"] = row
            del ws
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--label", default="")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--int4", action="store_true")
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--plans", action="store_true")
    parser.add_argument("--wo", action="store_true")
    parser.add_argument("--ring", action="store_true")
    parser.add_argument("--ms", default=None)
    parser.add_argument("--bodies", default=",".join(INT4_BODIES))
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if args.ring:
        ring_build_alone()
        line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(),
                "ring": ring_times(cs, ops, gen, dev, args.sweep,
                                   args.tree if args.ablate else None)}
        print(json.dumps(line), flush=True)
        return 0
    if args.wo:
        ms = [int(v) for v in args.ms.split(",")] if args.ms else WO_MS
        line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(),
                "wo_ms": wo_times(cs, ops, gen, dev, ms)}
        if args.sweep:
            line["wo_sweep_ms"] = wo_sweep(cs, gen, dev)
        if args.plans:
            line["wo_plans_ms"] = wo_plans(cs, gen, dev)
        if args.ablate:
            line["wo_ablate_ms"] = wo_ablate(cs, gen, dev, args.tree)
        print(json.dumps(line), flush=True)
        return 0
    if args.int4:
        ms = [int(v) for v in args.ms.split(",")] if args.ms else INT4_MS
        bodies = tuple(args.bodies.split(","))
        line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(),
                "int4_ms": int4_times(cs, ops, gen, dev, ms, bodies)}
        if args.sweep:
            line["int4_sweep_ms"] = int4_sweep(cs, ops, gen, dev, bodies)
        if args.plans:
            line["int4_plans_ms"] = int4_plans(cs, ops, gen, dev, bodies)
        if args.ablate:
            line["int4_ablate_ms"] = int4_ablate(cs, ops, gen, dev, args.tree, bodies)
            line["int4_decode_ablate_ms"] = int4_ablate_decode(cs, ops, gen, dev, args.tree,
                                                               bodies)
        print(json.dumps(line), flush=True)
        return 0

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
    line = {"label": args.label, "tree": args.tree, "card": smi.stdout.strip(), "ms": times,
            "int_mm_ms": library, "bound_ms": bounds}
    if sweep:
        line["sweep_ms"] = sweep
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
