"""The row kernels' plan and their cut of a row (``rowquant``,
``csrc/rowquant.cu``; ``swiglu_quant``, ``csrc/fused_quant.cu``; both on
``csrc/row_quant.cuh``) spelled out in plain PyTorch, against the plain
versions and the JAX package.

* The plan (``ops.rowquant.rowquant_plan``, rowquant's and swiglu_quant's
  alike): for every M from 1 to 1024 and K from 1 to 57856 (the model
  widths among them) and every dtype, a plan the kernel takes: at most a
  portable cluster of
  blocks, threads a multiple of 32 within the register budget of the
  vectors a thread, the blocks holding every whole vector of the row, the
  grid within CUDA's; the slices of a row tile it exactly at every head
  (the elements before its first 16-byte boundary); few rows take the
  cluster route. The choices at the decode and prefill shapes are pinned.
* ``rowquant_parts_ref`` and ``swiglu_quant_parts_ref`` (each slice's
  maximum, the maximum of those, each slice quantized) equal
  ``rowquant_ref`` / ``swiglu_quant_ref`` bit for bit at every cut, head
  and dtype: all-zero rows (scale 1e-12), exact half-way ties, K 1 and odd K.
* Against the JAX package: the rowquant spelling equals the JAX contract
  (``protoquant_tpu.core.numerics.quantize_rowwise``) bit for bit, and
  ``protoquant_tpu.ops.rowquant(..., interpret=True)`` wherever that
  kernel's scale is on the contract; under jit XLA:CPU turns its
  ``amax / 127`` into a reciprocal multiply, one f32 ulp off in some rows
  (``tests/test_torch_ops.py``), and there the scales stay within one ulp
  and the codes within one step. The SwiGLU spelling meets
  ``test_swiglu_quant_ref_vs_jax``'s limits against
  ``fused_quant.swiglu_quant(..., interpret=True)``: scales within rtol
  1e-2, codes +-1 in under 5 %.
* A planted fault, the spelling with the slice that holds each row's
  maximum dropped, fails the same comparisons.
* The wrappers pass the plan to the C entry and count its route (the
  library stubbed, the tensors on the meta device).
Inputs are random arrays made with numpy from a seed.
"""

import importlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu import ops as jops
from protoquant_tpu.core import numerics as jnum
from protoquant_tpu.ops.fused_quant import swiglu_quant as j_swiglu_quant
from protoquant_tpu_torch import ops

R = importlib.import_module("protoquant_tpu_torch.ops.rowquant")
F = importlib.import_module("protoquant_tpu_torch.ops.fused_quant")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
MODEL_WIDTHS = (1024, 2048, 2880, 3584, 4096, 5504, 11008, 14336)
PLAN_MS = tuple(range(1, 65)) + (96, 128, 255, 256, 257, 512, 1000, 1023, 1024)
PLAN_KS = sorted(set(range(1, 65)) | set(MODEL_WIDTHS) | {4095, 4097, 11007, 57855, 57856}
                 | set(random.Random(0).sample(range(65, 57856), 150)))


def _plan_holds(k: int, itemsize: int, plan) -> bool:
    """``csrc/row_quant.cuh``'s rq_plan_ok: the plan the C entry runs."""
    nvec = k // (16 // itemsize)
    return (1 <= plan.blocks <= R.MAX_BLOCKS and plan.vectors in R.VECTORS
            and 32 <= plan.threads <= R.MAX_THREADS[plan.vectors] and plan.threads % 32 == 0
            and -(-nvec // plan.blocks) <= plan.threads * plan.vectors)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_covers_every_row(itemsize):
    v = 16 // itemsize
    for k in PLAN_KS:
        blocks_seen = set()
        for m in PLAN_MS:
            plan = R.rowquant_plan(m, k, itemsize)
            assert _plan_holds(k, itemsize, plan), (m, k, plan)
            assert plan.blocks <= R.MAX_BLOCKS and m * plan.blocks < 2**31 - 1
            assert plan.route == "rows" or m <= R.CLUSTER_MAX_M
            assert plan.route == "cluster" or plan.blocks == max(1, -(-(k // v) // R.BLOCK_VECTORS))
            blocks_seen.add(plan.blocks)
        for blocks in blocks_seen:
            for head in range(v):
                slices = R.row_slices(k, blocks, itemsize, head)
                assert len(slices) == blocks and slices[0][0] == 0 and slices[-1][1] == k
                assert all(a <= b for a, b in slices)
                assert all(b == a2 for (_, b), (a2, _) in zip(slices, slices[1:]))
                # the inner cuts fall on 16-byte boundaries of the row
                h = min(head, k)
                for _, cut in slices[:-1]:
                    assert (cut - h) % v == 0 and h <= cut <= k - (k - h) % v


# The plan at the decode (M 1, 4; GPT-OSS's experts M 32) and prefill (M
# 256) rows of the 7B, Gemma-2, Mistral and GPT-OSS widths, bf16: (route,
# blocks a row, threads, vectors a thread)
MODEL_PLANS = {
    (1, 4096): ("rows", 1, 512, 1), (4, 4096): ("rows", 1, 512, 1),
    (4, 2880): ("rows", 1, 384, 1), (32, 2880): ("rows", 1, 384, 1),
    (4, 3584): ("rows", 1, 448, 1), (4, 5504): ("cluster", 6, 128, 1),
    (1, 11008): ("cluster", 8, 192, 1), (4, 11008): ("cluster", 8, 192, 1),
    (4, 14336): ("cluster", 8, 224, 1), (256, 4096): ("rows", 1, 512, 1),
    (256, 11008): ("rows", 1, 704, 2), (256, 14336): ("rows", 1, 448, 4)}


def test_plan_at_the_model_shapes():
    """The choices at the model shapes, pinned (the sweep in PERF.md,
    tools/rowquant_timing.py --sweep)."""
    for (m, k), want in MODEL_PLANS.items():
        assert tuple(R.rowquant_plan(m, k, 2)) == want, (m, k)


def test_block_shape():
    for share in range(0, R.BLOCK_VECTORS + 1):
        threads, r = R.block_shape(share)
        assert threads % 32 == 0 and 32 <= threads <= R.MAX_THREADS[r]
        assert threads * r >= share and (r == 1 or share > R.MAX_THREADS[r // 2] * (r // 2))


def _rows(rng, shape, dtype, scale=2.0):
    """Random rows with an all-zero row and a row of exact half-way ties
    (values k + 1/2 times a power-of-two scale, whose maximum makes s a
    power of two over 127)."""
    x = rng.standard_normal(shape).astype(np.float32) * scale
    x2 = x.reshape(-1, shape[-1])
    x2[0] = 0.0
    if x2.shape[0] > 1:
        steps = rng.integers(-126, 127, shape[-1]) + 0.5
        steps[0] = 127.0
        x2[1] = steps / 64.0
    return torch.from_numpy(x).to(DTYPES[dtype])


SPELL_SHAPES = [(3, 1), (4, 7), (5, 8), (6, 37), (4, 4095), (3, 4096), (2, 3, 2880), (2, 11008)]


@pytest.mark.parametrize("blocks", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rowquant_parts_ref_exact(dtype, blocks):
    rng = np.random.default_rng(blocks)
    v = 16 // DTYPES[dtype].itemsize
    for shape in SPELL_SHAPES:
        x = _rows(rng, shape, dtype)
        rq, rs = ops.rowquant_ref(x)
        assert rs.reshape(-1)[0] == np.float32(1e-12)
        for head in range(v):
            plan = R.RowPlan("cluster", blocks, 32, 1)
            q, s = ops.rowquant_parts_ref(x, plan, head)
            assert torch.equal(q, rq) and torch.equal(s, rs), (shape, head)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype,cast", [("bfloat16", "bfloat16"), ("float32", "float32"),
                                        ("float16", "float16"), ("bfloat16", "float32"),
                                        ("float32", "bfloat16")])
def test_swiglu_quant_parts_ref_exact(dtype, cast, act):
    rng = np.random.default_rng(11)
    for shape in SPELL_SHAPES:
        gate, up = _rows(rng, shape, dtype), _rows(rng, shape, dtype)
        rq, rs = ops.swiglu_quant_ref(gate, up, act=act, cast_dtype=DTYPES[cast])
        for blocks in (1, 3, 8):
            for head in (0, 1):
                plan = R.RowPlan("cluster", blocks, 32, 1)
                q, s = ops.swiglu_quant_parts_ref(gate, up, plan, act=act,
                                                  cast_dtype=DTYPES[cast], head=head)
                assert torch.equal(q, rq) and torch.equal(s, rs), (shape, blocks, head)


def _jax_pair(x, dtype):
    j = jnp.asarray(x, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64), (3, 1), (7, 4095), (16, 2880), (2, 3, 1000)])
def test_rowquant_parts_ref_vs_jax(shape, dtype):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32) * 2
    jx, tx = _jax_pair(x, dtype)
    plan = R.rowquant_plan(int(np.prod(shape[:-1])), shape[-1], tx.element_size())
    tq, ts = (a.numpy() for a in ops.rowquant_parts_ref(tx, plan._replace(blocks=3), 1))
    # exact against the JAX package's contract ...
    cq, cs = map(np.asarray, jnum.quantize_rowwise(jx))
    np.testing.assert_array_equal(cq, tq)
    np.testing.assert_array_equal(cs, ts)
    # ... and against its interpret-mode kernel wherever that kernel's scale is
    jq, js = map(np.asarray, jops.rowquant(jx, interpret=True))
    np.testing.assert_array_max_ulp(js, ts, maxulp=1)
    same = js == ts
    np.testing.assert_array_equal(jq[same], tq[same])
    assert np.abs(jq.astype(np.int32) - tq.astype(np.int32)).max() <= 1


def _codes_close(q, q_ref, share):
    dq = np.abs(np.asarray(q, np.int32) - np.asarray(q_ref, np.int32))
    return dq.max() <= 1 and (dq != 0).mean() < share


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_quant_parts_ref_vs_jax(act):
    rng = np.random.default_rng(4)
    gj, gt = _jax_pair(rng.standard_normal((2, 21, 384)) * 2, "bfloat16")
    uj, ut = _jax_pair(rng.standard_normal((2, 21, 384)) * 2, "bfloat16")
    qj, sj = j_swiglu_quant(gj, uj, act=act, interpret=True)
    for blocks in (1, 3):
        qt, st = ops.swiglu_quant_parts_ref(gt, ut, R.RowPlan("cluster", blocks, 32, 1),
                                            act=act)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-2)
        assert _codes_close(qt.numpy(), qj, 0.05)


def _dropped(h, blocks, head=0):
    """The planted fault: the slice holding each row's maximum left out."""
    slices = R.row_slices(h.shape[-1], blocks, h.element_size(), head)
    maxima = R.part_maxima(h, slices)
    maxima.scatter_(-1, maxima.argmax(-1, keepdim=True), 0.0)
    return R.quantize_parts(h, maxima, slices)


@pytest.mark.parametrize("blocks", [1, 2, 8])
def test_dropped_slice_maximum_is_caught(blocks):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32)).to(torch.bfloat16)
    rq, rs = ops.rowquant_ref(x)
    q, s = _dropped(x, blocks)
    assert not torch.equal(q, rq) and not torch.equal(s, rs)
    g, u = (torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32) * 2)
            .to(torch.bfloat16) for _ in range(2))
    hq, hs = ops.swiglu_quant_ref(g, u)
    bq, bs = _dropped(F.swiglu(g, u), blocks)
    rel = ((bs - hs).abs() / hs).max().item()
    assert rel > 1e-2 or not _codes_close(bq.numpy(), hq.numpy(), 0.05)
    # against the JAX kernel too
    jq, js = map(np.asarray, jops.rowquant(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                           interpret=True))
    assert np.abs(jq.astype(np.int32) - q.numpy().astype(np.int32)).max() > 1


class _Lib:
    """A stand-in for the kernel library: records each call's plan."""

    def __init__(self):
        self.calls = []

    def pq_rowquant(self, *args):
        self.calls.append(("rowquant", args[6:9]))
        return 0

    def pq_swiglu_quant(self, *args):
        self.calls.append(("swiglu_quant", args[7:10]))
        return 0


def test_wrappers_pass_the_plan_and_count_its_route(monkeypatch):
    B = importlib.import_module("protoquant_tpu_torch.ops._build")
    lib = _Lib()
    monkeypatch.setattr(B, "lib", lambda verbose=False: lib)
    monkeypatch.setattr(B, "stream_ptr", lambda dev: 0)
    ops.reset_launch_counts()
    shapes = [(1, 11008), (4, 4096), (256, 4096), (1024, 11008), (2, 3, 2880), (0, 64)]
    for shape in shapes:
        x = torch.empty(*shape, dtype=torch.bfloat16, device="meta")
        xq, sx = ops.rowquant(x)
        assert xq.shape == x.shape and xq.dtype == torch.int8 and sx.shape == x.shape[:-1]
        hq, hs = ops.swiglu_quant(x, x)
        assert hq.shape == x.shape and hs.shape == x.shape[:-1]
    want = {"rowquant": {"cluster": 0, "rows": 0}, "swiglu_quant": {"cluster": 0, "rows": 0}}
    for shape in shapes[:-1]:  # no launch for no rows
        m, k = int(np.prod(shape[:-1])), shape[-1]
        for name in ("rowquant", "swiglu_quant"):
            plan = R.rowquant_plan(m, k, 2)
            want[name][plan.route] += 1
            assert (name, tuple(plan[1:])) in lib.calls
    assert len(lib.calls) == 2 * (len(shapes) - 1)
    for name in want:
        fn = getattr(ops, name)
        assert fn.routes == want[name] and fn.launches == len(shapes) - 1
        for route, count in want[name].items():
            assert ops.route_counts()[f"{name}_{route}"] == count
    ops.reset_launch_counts()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.empty(2, R.MAX_K + 1, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="outside"):
        ops.rowquant(x)
    with pytest.raises(ValueError, match="outside"):
        ops.swiglu_quant(x, x)
    with pytest.raises(TypeError, match="unsupported dtype"):
        ops.rowquant(torch.empty(2, 8, dtype=torch.int32, device="meta"))
