"""The CUDA kernels of protoquant_tpu_torch against their plain versions, on
the card. Every test here skips without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
Exact: rowquant, qmatmul, the dense and paged decode scatters. The row
kernels, rowquant and swiglu_quant (``csrc/row_quant.cuh``): both routes
(a row over a cluster, a block a row) at M 1-1024 and K 1-57856, every
dtype, rows on and off a 16-byte boundary (swiglu_quant within its JAX
limits), bit for bit across two calls and in a CUDA graph, routes counted,
plans the kernel cannot run refused. Attention,
dense and paged: ATOL (f32 q and output; the two sum in different orders).
The decode GEMM (split K over a cluster) exact at M 1 to 64 and at every
split; the tile GEMM (TMA and wgmma, every M past DECODE_MAX_M) exact at
the model shapes, at 65 to 1024 rows, ragged N and K, every tile height and
split, with and without a bias in every output type, bit for bit across two
calls and in a CUDA graph; the paged split decode as the paged attention, at page and split
edges, at batch 9 and 32, bit for bit across two calls and in a CUDA graph.
The weight-only product: ``ops.weight_only_tolerance`` (exact products, an
f32 sum in another order, then one ulp of the output type). The int4
products, split and legacy: ``ops.weight_only_int4_tolerance`` (the same
products, f32 sums in another order). W4A8, two_level and group: exact,
and the two-level (r16, scol) made on the card equal the CPU's. The fused
producers, ``rms_norm_quant`` and ``swiglu_quant``: codes equal or +-1 (the
norm's in under 1e-3 of the elements, scales within rtol 1e-6; the gate's in
under 5 %, scales within rtol 1e-2), what the JAX package demands of its
kernels. ``dequant``: exact. The KIVI updates (K4V8, Int4), both routes
(decode, prefill) at the 7B, GPT-OSS and BLOOM shapes and in a CUDA graph:
exact on all eight cache tensors; the KIVI attentions: ATOL in f32, 2^-7 of the
largest output in bf16. The mixed K8V4 writer: exact on all four cache
tensors; the mixed attention as the KIVI ones. The split-S KIVI decode:
the same tolerances at split boundaries, with dead splits below a window and
with only the tail live, and bit for bit across two calls and in a CUDA
graph; the split-S int8 and K8V4 decode likewise, with ring positions,
StreamingLLM sinks, ALiBi and learned sinks, at batch 9 and 32. The
prefill kernel (bf16 tensor cores) at every q dtype and variant: against
its bf16-lane spelling (``dense_attention_tiles_ref``) within TIGHT, against
the plain version within ATOL (f32 q: three bf16 terms) or 2^-7 of the
largest output, bit for bit across two calls and in a CUDA graph; its KIVI
instances (the K4V8 and Int4 prefill chunks and the decodes the split
design does not take) the same, against ``kivi_attention_tiles_ref``. The learned-sink variants
(GPT-OSS) as their attentions; a tiny GPT-OSS on the card against the same
model on the CPU: logits within 2^-7 of their scale, at least 0.9 of the
engine's greedy tokens equal (an int8 activation code on a rounding
boundary may move a step, and a near-tied token with it). The ring
reduce-scatter matmul (B19): exact, with unit scales and with real ones,
over one launch for all ranks and over the per-rank call on a mesh whose
ranks share the card, also over back-to-back calls of changing M (the
flags' epochs); every route and K split the card holds, at the 7B and
ragged shapes; a grid the card cannot hold whole raises; routes counted.
"""

import importlib

import pytest
import torch

from protoquant_tpu_torch import ops
from protoquant_tpu_torch.core import numerics

ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rowquant_and_qmatmul_exact(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(37, 4096, generator=g, device=cuda).to(dtype)
    xq, sx = ops.rowquant(x)
    rq, rs = ops.rowquant_ref(x)
    assert torch.equal(xq, rq) and torch.equal(sx, rs)
    wq, sw = numerics.quantize_channelwise(
        torch.randn(1000, 4096, generator=g, device=cuda), dim=1)
    bias = torch.randn(1000, generator=g, device=cuda)
    for b in (None, bias):
        y = ops.qmatmul(xq, wq, sx, sw, b, out_dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(y, ops.qmatmul_ref(xq, wq, sx, sw, b, out_dtype=dtype))


# The row kernels (rowquant, swiglu_quant): every route at these rows and
# widths, every dtype, rows that start on and off a 16-byte boundary.
ROW_MS = (1, 2, 3, 4, 7, 8, 16, 31, 32, 33, 64, 255, 256, 1024)
ROW_KS = (1, 7, 8, 2880, 4095, 4096, 11008, 14336, 57856)
ROW_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _row_plans(m, k, itemsize):
    """The plan's own plan and one of each route: "rows" (the fewest
    blocks a row, as at prefill) and "cluster" (at least 2 blocks a row,
    even where a block holds no whole vector)."""
    R = importlib.import_module("protoquant_tpu_torch.ops.rowquant")
    nvec = k // (16 // itemsize)
    own = R.rowquant_plan(m, k, itemsize)
    rows = max(1, -(-nvec // R.BLOCK_VECTORS))
    cluster = max(2, rows, min(R.MAX_BLOCKS, -(-nvec // R.CLUSTER_SHARE)))
    share = -(-nvec // rows)  # the rows route with 4 vectors a thread
    return [own, R.RowPlan("rows", rows, max(32, -(-share // 128) * 32), 4),
            R.RowPlan("cluster", cluster, *R.block_shape(-(-nvec // cluster)))]


def _row_inputs(g, cuda, m, k, dtype, offset):
    """An [m, k] view starting ``offset`` elements into a fresh buffer."""
    base = (torch.randn(m * k + 8, generator=g, device=cuda) * 2).to(dtype)
    return base[offset:offset + m * k].view(m, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", ROW_KS)
@pytest.mark.parametrize("m", ROW_MS)
def test_rowquant_every_route_exact(cuda, m, k):
    R = importlib.import_module("protoquant_tpu_torch.ops.rowquant")
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k)
    for dtype in ROW_DTYPES:
        for offset in (0, 1):
            x = _row_inputs(g, cuda, m, k, dtype, offset)
            rq, rs = ops.rowquant_ref(x)
            for plan in _row_plans(m, k, x.element_size()):
                xq, sx, _ = R.rowquant_launch(x, plan)
                torch.cuda.synchronize()
                assert torch.equal(xq, rq) and torch.equal(sx, rs), (dtype, offset, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("k", ROW_KS)
@pytest.mark.parametrize("m", ROW_MS)
def test_swiglu_quant_every_route_vs_plain(cuda, m, k):
    """Every route within the JAX package's limits (codes +-1 in under 5 %,
    scales within rtol 1e-2), gate and up each on or off a 16-byte
    boundary, SiLU and GELU, cast to the input dtype."""
    F = importlib.import_module("protoquant_tpu_torch.ops.fused_quant")
    g = torch.Generator(device=cuda).manual_seed(m * 5 + k)
    for dtype in ROW_DTYPES:
        for (og, ou), act in zip(((0, 0), (1, 1), (1, 0)), ("silu", "gelu", "silu")):
            gate = _row_inputs(g, cuda, m, k, dtype, og)
            up = _row_inputs(g, cuda, m, k, dtype, ou)
            rq, rs = ops.swiglu_quant_ref(gate, up, act=act, cast_dtype=dtype)
            for plan in _row_plans(m, k, gate.element_size()):
                q, s, _ = F.swiglu_quant_launch(gate, up, act=act, cast_dtype=dtype, plan=plan)
                torch.cuda.synchronize()
                torch.testing.assert_close(s, rs, rtol=1e-2, atol=0)
                _codes_close(q, rq, 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(4, 11008), (1, 4096), (256, 4096), (3, 4095)])
def test_row_kernels_bitwise_and_cuda_graph(cuda, m, k):
    """Each route: two calls give the same bits, and the call captured in a
    CUDA graph and replayed gives the eager call's bits."""
    R = importlib.import_module("protoquant_tpu_torch.ops.rowquant")
    F = importlib.import_module("protoquant_tpu_torch.ops.fused_quant")
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x, up = (torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    for plan in _row_plans(m, k, 2)[1:]:
        for call in (lambda: R.rowquant_launch(x, plan)[:2],
                     lambda: F.swiglu_quant_launch(x, up, plan=plan)[:2]):
            first, second = call(), call()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = call()
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(captured, first)), plan
    assert torch.equal(ops.rowquant(x)[0], ops.rowquant_ref(x)[0])


@pytest.mark.cuda
def test_row_routes_add_up_to_launches(cuda):
    """The wrappers count a launch once, on the route their plan names, and
    never for the plain version or a CPU tensor; a plan the kernel cannot
    run is refused."""
    R = importlib.import_module("protoquant_tpu_torch.ops.rowquant")
    g = torch.Generator(device=cuda).manual_seed(3)
    ops.reset_launch_counts()
    for m, k in ((1, 11008), (4, 4096), (4, 1024), (256, 4096), (1024, 11008)):
        x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
        ops.rowquant(x)
        ops.swiglu_quant(x, x)
        ops.rowquant_ref(x)
        ops.rowquant(x.cpu())
        ops.swiglu_quant(x.cpu(), x.cpu())
    routes = ops.route_counts()
    for name in ("rowquant", "swiglu_quant"):
        fn = getattr(ops, name)
        assert routes[f"{name}_cluster"] + routes[f"{name}_rows"] == fn.launches == 5
        assert routes[f"{name}_cluster"] > 0 and routes[f"{name}_rows"] > 0
    x = torch.zeros(2, 4096, dtype=torch.bfloat16, device=cuda)
    for plan in (R.RowPlan("rows", 1, 32, 1), R.RowPlan("rows", 1, 64, 3),
                 R.RowPlan("rows", 1, 64, 8), R.RowPlan("cluster", 9, 32, 4),
                 R.RowPlan("rows", 1, 1024, 4), R.RowPlan("rows", 1, 48, 2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            R.rowquant_launch(x, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (65, 80, 130), (3, 11008, 72)])
def test_qmatmul_ragged_edges_exact(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=cuda)
    sw = torch.rand(n, generator=g, device=cuda)
    y = ops.qmatmul(xq, wq, sx, sw)
    torch.cuda.synchronize()
    assert torch.equal(y, ops.qmatmul_ref(xq, wq, sx, sw))



@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 7, 8, 9, 16, 17, 31, 32, 33, 47, 48, 63, 64, 65,
                               128])
def test_qmatmul_decode_exact_around_the_threshold(cuda, m, out_dtype):
    """M from 1 to 128 around DECODE_MAX_M (32: the decode kernel up to 32
    rows, the tile kernel from 33), ragged N (1000) and K (4096 + 16: a
    ragged last step), with and without a bias: equal to the plain version
    bit for bit, through the kernel the route names."""
    from protoquant_tpu_torch.ops.qmatmul import DECODE_MAX_M

    g = torch.Generator(device=cuda).manual_seed(m)
    k, n = 4096 + 16, 1000
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=cuda) * 1e-2 + 1e-4
    sw = torch.rand(n, generator=g, device=cuda) * 1e-2 + 1e-4
    bias = torch.randn(n, generator=g, device=cuda)
    for b in (None, bias):
        ops.reset_launch_counts()
        y = ops.qmatmul(xq, wq, sx, sw, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(y, ops.qmatmul_ref(xq, wq, sx, sw, b, out_dtype=out_dtype))
        route = "decode" if m <= DECODE_MAX_M else "tile"
        assert ops.qmatmul.routes == {"decode": int(route == "decode"),
                                      "tile": int(route == "tile")}


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (4, 80, 130), (5, 2880, 5760), (8, 11008, 72),
                                   (64, 4096, 4096), (3, 256, 4097)])
def test_qmatmul_decode_every_split_exact(cuda, m, k, n):
    """The decode kernel at every cluster size the K steps allow (1, 2, 4,
    8), ragged N and K: every split gives the plain version's bits; a
    split count the kernel does not take raises."""
    from protoquant_tpu_torch.ops.qmatmul import DECODE_STEP, qmatmul_launch

    g = torch.Generator(device=cuda).manual_seed(k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=cuda)
    sw = torch.rand(n, generator=g, device=cuda)
    bias = torch.randn(n, generator=g, device=cuda)
    want = ops.qmatmul_ref(xq, wq, sx, sw, bias, out_dtype=torch.bfloat16)
    steps = -(-k // DECODE_STEP)
    for splits in (1, 2, 4, 8):
        if splits > steps:
            with pytest.raises(RuntimeError, match="pq_qmatmul_decode"):
                qmatmul_launch(xq, wq, sx, sw, bias, torch.bfloat16, splits)
            continue
        y = qmatmul_launch(xq, wq, sx, sw, bias, torch.bfloat16, splits)
        torch.cuda.synchronize()
        assert torch.equal(y, want), splits
    with pytest.raises(RuntimeError, match="pq_qmatmul_decode"):
        qmatmul_launch(xq, wq, sx, sw, bias, torch.bfloat16, 3)


@pytest.mark.cuda
def test_qmatmul_decode_bitwise_and_cuda_graph(cuda):
    """Two calls give the same bits; the call captured in a CUDA graph and
    replayed gives the eager call's bits (no state kept between calls)."""
    g = torch.Generator(device=cuda).manual_seed(151)
    xq = torch.randint(-127, 128, (4, 4096), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (11008, 4096), generator=g, device=cuda, dtype=torch.int8)
    sx, sw = torch.rand(4, generator=g, device=cuda), torch.rand(11008, generator=g, device=cuda)
    call = lambda: ops.qmatmul(xq, wq, sx, sw, out_dtype=torch.bfloat16)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    assert ops.route_counts()["qmatmul_decode"] == 1


def _tile_operands(cuda, seed, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=cuda) * 1e-2 + 1e-4
    sw = torch.rand(n, generator=g, device=cuda) * 1e-2 + 1e-4
    bias = torch.randn(n, generator=g, device=cuda)
    return xq, wq, sx, sw, bias


def _tile_exact(xq, wq, sx, sw, bias, dtypes):
    """Every call through the tile route, bit for bit with the plain version,
    with and without the bias."""
    for out_dtype in dtypes:
        for b in (None, bias):
            before = ops.qmatmul.routes["tile"]
            y = ops.qmatmul(xq, wq, sx, sw, b, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert ops.qmatmul.routes["tile"] == before + 1
            want = ops.qmatmul_ref(xq, wq, sx, sw, b, out_dtype=out_dtype)
            assert torch.equal(y, want), (out_dtype, b is None)


ALL_OUT = (torch.float32, torch.bfloat16, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 4096, 11008), (256, 4096, 4096), (256, 11008, 4096),
                                   (256, 4096, 32000), (80, 2880, 5760), (80, 2880, 2880),
                                   (512, 3584, 14336), (512, 14336, 3584), (128, 4096, 11008)])
def test_qmatmul_tile_exact_at_model_shapes(cuda, m, k, n):
    """The tile kernel (TMA + wgmma) at the prefill shapes of Llama-2-7B,
    GPT-OSS-20B's experts and Gemma-2-9B, every output type, with and
    without a bias: the plain version's bits."""
    _tile_exact(*_tile_operands(cuda, m + k + n, m, k, n), ALL_OUT)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [65, 80, 128, 129, 200, 257, 512, 1024])
def test_qmatmul_tile_exact_by_rows(cuda, m):
    """Row counts at and across the 128- and 256-row tiles (65 and 257: a
    nearly empty last tile), ragged N (1000) and K (4096 + 16)."""
    _tile_exact(*_tile_operands(cuda, m, m, 4096 + 16, 1000), ALL_OUT)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 80, 4112])
@pytest.mark.parametrize("m,n", [(65, 130), (200, 131), (300, 8)])
def test_qmatmul_tile_ragged_edges_exact(cuda, m, k, n):
    """K of one partial 128-byte step (16, 80) and a ragged last step
    (4112), N not a multiple of 128 (odd too), M across the tile edges."""
    _tile_exact(*_tile_operands(cuda, k * n, m, k, n), ALL_OUT)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(80, 2880, 1000), (256, 4112, 4096), (300, 1024, 130)])
def test_qmatmul_tile_every_plan_exact(cuda, m, k, n):
    """Both tile heights and every K split the steps allow (1, 2, 4) give
    the plain version's bits; a plan the kernel does not take raises."""
    from protoquant_tpu_torch.ops.qmatmul import TILE_STEP, qmatmul_launch

    xq, wq, sx, sw, bias = _tile_operands(cuda, 7 * m + k, m, k, n)
    want = ops.qmatmul_ref(xq, wq, sx, sw, bias, out_dtype=torch.bfloat16)
    steps = -(-k // TILE_STEP)
    for bm in (128, 256):
        for splits in (1, 2, 4):
            if splits > steps:
                continue
            y = qmatmul_launch(xq, wq, sx, sw, bias, torch.bfloat16, tile=(bm, splits))
            torch.cuda.synchronize()
            assert torch.equal(y, want), (bm, splits)
    for bad in ((64, 1), (128, 3), (256, 8)):
        with pytest.raises(RuntimeError, match="pq_qmatmul"):
            qmatmul_launch(xq, wq, sx, sw, bias, torch.bfloat16, tile=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 4096, 11008), (256, 4096, 4096)])
def test_qmatmul_tile_bitwise_and_cuda_graph(cuda, m, k, n):
    """Two calls give the same bits; the call captured in a CUDA graph and
    replayed gives the eager call's bits (one launch, with and without a K
    split, nothing kept between calls)."""
    xq, wq, sx, sw, _ = _tile_operands(cuda, 152, m, k, n)
    call = lambda: ops.qmatmul(xq, wq, sx, sw, out_dtype=torch.bfloat16)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    assert ops.route_counts()["qmatmul_tile"] == 1


@pytest.mark.cuda
def test_qmatmul_tile_rejects_misaligned_operands(cuda):
    """TMA reads from 16-byte aligned addresses: an operand that starts off
    that alignment raises before any launch."""
    m, k, n = 128, 256, 256
    xq, wq, sx, sw, _ = _tile_operands(cuda, 3, m, k, n)
    for which in ("x", "w"):
        rows = m if which == "x" else n
        buf = torch.zeros(rows * k + 8, dtype=torch.int8, device=cuda)
        off = buf[8:].view(rows, k)
        with pytest.raises(ValueError, match="16-byte aligned"):
            if which == "x":
                ops.qmatmul(off, wq, sx, sw)
            else:
                ops.qmatmul(xq, off, sx, sw)

@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    xq = torch.zeros(4, 24, dtype=torch.int8, device=cuda)
    wq = torch.zeros(8, 24, dtype=torch.int8, device=cuda)
    s4, s8 = torch.ones(4, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.qmatmul(xq, wq, s4, s8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.qmatmul(torch.zeros(4, 32, dtype=torch.int8, device=cuda),
                    torch.zeros(32, 8, dtype=torch.int8, device=cuda).t(), s4, s8)
    with pytest.raises(ValueError, match="head_dim"):
        q = torch.zeros(1, 1, 2, 48, device=cuda)
        kq = torch.zeros(1, 2, 8, 48, dtype=torch.int8, device=cuda)
        s = torch.ones(1, 2, 8, device=cuda)
        ops.int8_kv_attention(q, kq, s, kq, s, torch.zeros(1, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("group,T,head_dim", [(1, 1, 128), (2, 5, 128), (4, 33, 64), (1, 3, 256)])
def test_scatter_and_attention_vs_plain(cuda, group, T, head_dim):
    g = torch.Generator(device=cuda).manual_seed(group * 100 + T)
    B, KV, S, Dh = 3, 4, 96, head_dim
    kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=g, device=cuda,
                       dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2
    vs = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2
    lengths = torch.tensor([0, 40, S], dtype=torch.int32, device=cuda)  # one full
    k8 = torch.randint_like(kq[:, :, :1], -127, 128)
    ksn = torch.rand(B, KV, 1, generator=g, device=cuda)
    a = [t.clone() for t in (kq, ks, vq, vs)]
    b = [t.clone() for t in (kq, ks, vq, vs)]
    ops.kv_scatter_decode(*a, lengths, k8, ksn, k8, ksn)
    ops.kv_scatter_decode_ref(*b, lengths, k8, ksn, k8, ksn)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=cuda)
    lengths = torch.tensor([0, 40, S - T], dtype=torch.int32, device=cuda)
    out = ops.int8_kv_attention(q, kq, ks, vq, vs, lengths)
    ref = ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_counters_count_kernel_launches_only(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 64, device=cuda)
    xq, sx = ops.rowquant(x)
    ops.rowquant_ref(x)
    ops.rowquant(x.cpu())
    assert ops.launch_counts()["rowquant"] == 1
    routes = ops.route_counts()
    assert routes["rowquant_cluster"] + routes["rowquant_rows"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (4, 4096, 4096), (5, 80, 130),
                                   (17, 11008, 72), (256, 4096, 200)])
def test_weight_only_matmul_vs_plain(cuda, m, k, n, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sw = torch.rand(n, generator=g, device=cuda) * 1e-2
    bias = torch.randn(n, generator=g, device=cuda)
    for b in (None, bias):
        y = ops.weight_only_matmul(x, wq, sw, b, out_dtype=out_dtype)
        ref = ops.weight_only_matmul_ref(x, wq, sw, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert y.dtype == out_dtype and y.shape == (m, n)
        tol = ops.weight_only_tolerance(x, wq, sw, ref)
        assert ((y.float() - ref.float()).abs() <= tol).all()


def _pools(g, dev, P, KV, ps, Dh):
    kq = torch.randint(-127, 128, (P, KV, ps, Dh), generator=g, device=dev, dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = torch.rand(P, KV, 1, ps, generator=g, device=dev) * 1e-2 + 1e-3
    vs = torch.rand(P, KV, 1, ps, generator=g, device=dev) * 1e-2 + 1e-3
    return kq, ks, vq, vs


def _table(g, B, maxP, P):
    """Shuffled page chains (row 1 unmapped) over pages 0 .. P - 2."""
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
    pt = perm[:B * maxP].reshape(B, maxP).to(torch.int32)
    pt[1] = -1
    return pt


@pytest.mark.cuda
@pytest.mark.parametrize("ps,head_dim", [(16, 128), (128, 128), (8, 64)])
def test_paged_scatter_vs_plain(cuda, ps, head_dim):
    g = torch.Generator(device=cuda).manual_seed(ps)
    B, KV, maxP = 4, 3, 4
    P = B * maxP + 2
    pools = _pools(g, cuda, P, KV, ps, head_dim)
    pt = _table(g, B, maxP, P).to(cuda)
    # row 1 unmapped; row 2 past the window (lands on the trash page at
    # another offset than row 1); rows 0 and 3 on a page boundary and inside
    lengths = torch.tensor([ps, 3, maxP * ps + 5, 2 * ps + 1], dtype=torch.int32, device=cuda)
    k8 = torch.randint(-127, 128, (B, KV, 1, head_dim), generator=g, device=cuda,
                       dtype=torch.int8)
    v8 = torch.randint_like(k8, -127, 128)
    ksn = torch.rand(B, KV, 1, generator=g, device=cuda)
    vsn = torch.rand(B, KV, 1, generator=g, device=cuda)
    a = [t.clone() for t in pools]
    b = [t.clone() for t in pools]
    ops.paged_kv_scatter_decode(*a, pt, lengths, k8, ksn, v8, vsn)
    ops.paged_kv_scatter_decode_ref(*b, pt, lengths, k8, ksn, v8, vsn)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[0][P - 1, :, 3], k8[1, :, 0])  # unmapped -> trash page


@pytest.mark.cuda
@pytest.mark.parametrize("group,ps,head_dim,dtype", [
    (1, 128, 128, torch.float32), (4, 16, 128, torch.float32),
    (2, 8, 64, torch.float32), (8, 32, 256, torch.float32),
    (1, 128, 128, torch.bfloat16)])
def test_paged_attention_vs_plain(cuda, group, ps, head_dim, dtype):
    g = torch.Generator(device=cuda).manual_seed(group * 31 + ps)
    B, KV, maxP = 4, 2, 6
    P = B * maxP + 2
    pools = _pools(g, cuda, P, KV, ps, head_dim)
    pt = _table(g, B, maxP, P).to(cuda)
    # page boundaries: the last key of a page, the first of the next, a
    # full table
    lengths = torch.tensor([ps - 1, 0, ps, maxP * ps - 1], dtype=torch.int32, device=cuda)
    q = torch.randn(B, 1, KV * group, head_dim, generator=g, device=cuda).to(dtype)
    out = ops.paged_int8_attention(q, *pools, pt, lengths)
    ref = ops.paged_int8_attention_ref(q, *pools, pt, lengths)
    torch.cuda.synchronize()
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)



def _paged_case(g, dev, B, KV, group, ps, Dh, lens, maxP):
    P = B * maxP + 2
    pools = _pools(g, dev, P, KV, ps, Dh)
    pt = _table(g, B, maxP, P).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, KV * group, Dh, generator=g, device=dev)
    return q, pools, pt, lengths


def _paged_check(q, pools, pt, lengths, route, **kw):
    """The wrapper against its plain version; ``route`` the kernel it must
    have taken ("split" or "walk")."""
    ops.reset_launch_counts()
    out = ops.paged_int8_attention(q, *pools, pt, lengths, **kw)
    ref = ops.paged_int8_attention_ref(q, *pools, pt, lengths, **kw)
    torch.cuda.synchronize()
    assert ops.paged_int8_attention.routes == {"split": int(route == "split"),
                                               "walk": int(route == "walk")}
    atol = ATOL if q.dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("group,ps,head_dim,dtype", [
    (1, 128, 128, torch.float32), (4, 16, 128, torch.float32),
    (2, 8, 64, torch.float32), (8, 32, 256, torch.float32),
    (1, 128, 128, torch.bfloat16), (8, 16, 64, torch.bfloat16), (4, 256, 256, torch.float32)])
def test_paged_split_vs_plain(cuda, group, ps, head_dim, dtype, alibi):
    """test_paged_attention_vs_plain's grid and two more, lengths at page and
    split edges (the last key of a page, the first of the next, a split's
    last and first, a full table): every call whose rows fit a split block
    takes the split kernel through the table, G 8 at Dh 256 the page walk."""
    from protoquant_tpu_torch.models.llama import alibi_slopes
    from protoquant_tpu_torch.ops.paged_attention import paged_split_plan

    maxP = max(6, 384 // ps)
    lens = [ps - 1, 0, ps, 127, 128, maxP * ps - 1]
    g = torch.Generator(device=cuda).manual_seed(group * 37 + ps + head_dim)
    q, pools, pt, lengths = _paged_case(g, cuda, 6, 2, group, ps, head_dim, lens, maxP)
    kw = {"alibi_slopes": alibi_slopes(2 * group).to(cuda)} if alibi else {}
    route = "walk" if paged_split_plan(2 * group, 2, maxP, ps, head_dim) is None else "split"
    assert (route == "walk") == (group == 8 and head_dim == 256)
    _paged_check(q.to(dtype), pools, pt, lengths, route, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [9, 32])
def test_paged_split_large_batch_vs_plain(cuda, B):
    """A 7B paged decode (KV 32, Dh 128, 128-key pages over 1024 positions)
    at batch 9 and 32, bf16."""
    lens = ([63, 700, 1023, 255, 0, 128, 511, 900, 1000] * 4)[:B]
    g = torch.Generator(device=cuda).manual_seed(131 + B)
    q, pools, pt, lengths = _paged_case(g, cuda, B, 32, 1, 128, 128, lens, 8)
    _paged_check(q.to(torch.bfloat16), pools, pt, lengths, "split")


@pytest.mark.cuda
def test_paged_split_plan_matches_the_library(cuda):
    """The wrapper's plan in Python is the library's (pq_paged_split_plan)."""
    import ctypes

    from protoquant_tpu_torch.ops import _build
    from protoquant_tpu_torch.ops.paged_attention import paged_split_plan

    for Dh in (64, 128, 256):
        for group in (1, 2, 4, 8, 16):
            for maxP, ps in ((8, 128), (3, 8), (40, 16), (2, 256), (4096, 128)):
                span = ctypes.c_int(0)
                n = _build.lib().pq_paged_split_plan(2 * group, 2, maxP, ps, Dh,
                                                     ctypes.byref(span))
                want = (span.value, n) if n else None
                assert paged_split_plan(2 * group, 2, maxP, ps, Dh) == want


@pytest.mark.cuda
def test_paged_split_bitwise_and_cuda_graph(cuda):
    """Two calls give the same bits; the call captured in a CUDA graph and
    replayed gives the eager call's bits, and counts one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(141)
    q, pools, pt, lengths = _paged_case(g, cuda, 4, 32, 1, 128, 128, [63, 700, 1023, 255], 8)
    q = q.to(torch.bfloat16)
    call = lambda: ops.paged_int8_attention(q, *pools, pt, lengths)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    assert ops.launch_counts()["paged_int8_attention"] == 1
    assert ops.route_counts()["paged_int8_attention_split"] == 1

@pytest.mark.cuda
def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    wq = torch.zeros(8, 32, dtype=torch.int8, device=cuda)
    sw = torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.weight_only_matmul(torch.zeros(2, 32, device=cuda), wq, sw)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.weight_only_matmul(torch.zeros(2, 24, dtype=torch.bfloat16, device=cuda),
                               torch.zeros(8, 24, dtype=torch.int8, device=cuda), sw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.weight_only_matmul(torch.zeros(2, 32, dtype=torch.bfloat16, device=cuda),
                               torch.zeros(32, 8, dtype=torch.int8, device=cuda).t(), sw)
    kq, ks, vq, vs = (t.to(cuda) for t in (
        torch.zeros(3, 2, 8, 64, dtype=torch.int8), torch.ones(3, 2, 1, 8),
        torch.zeros(3, 2, 8, 64, dtype=torch.int8), torch.ones(3, 2, 1, 8)))
    pt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    lengths = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="decode only"):
        ops.paged_int8_attention(torch.zeros(1, 2, 2, 64, device=cuda), kq, ks, vq, vs,
                                 pt, lengths)
    with pytest.raises(TypeError, match="int32"):
        ops.paged_int8_attention(torch.zeros(1, 1, 2, 64, device=cuda), kq, ks, vq, vs,
                                 pt.long(), lengths)
    k8 = torch.zeros(1, 2, 1, 64, dtype=torch.int8, device=cuda)
    s1 = torch.ones(1, 2, 1, device=cuda)
    with pytest.raises(ValueError, match="tensors on"):
        ops.paged_kv_scatter_decode(kq, ks, vq, vs, pt, lengths.cpu(), k8, s1, k8, s1)


@pytest.mark.cuda
def test_new_counters_count_kernel_launches_only(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 64, device=cuda).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (8, 64), dtype=torch.int8, device=cuda)
    sw = torch.rand(8, device=cuda)
    ops.weight_only_matmul(x, wq, sw)
    ops.weight_only_matmul_ref(x, wq, sw)
    ops.weight_only_matmul(x.cpu(), wq.cpu(), sw.cpu())
    pools = [t.to(cuda) for t in (torch.zeros(3, 2, 8, 64, dtype=torch.int8),
                                  torch.ones(3, 2, 1, 8),
                                  torch.zeros(3, 2, 8, 64, dtype=torch.int8),
                                  torch.ones(3, 2, 1, 8))]
    pt = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([3], dtype=torch.int32, device=cuda)
    q = torch.randn(1, 1, 2, 64, device=cuda)
    ops.paged_int8_attention(q, *pools, pt, lengths)
    ops.paged_int8_attention_ref(q, *pools, pt, lengths)
    k8 = torch.zeros(1, 2, 1, 64, dtype=torch.int8, device=cuda)
    s1 = torch.ones(1, 2, 1, device=cuda)
    ops.paged_kv_scatter_decode(*pools, pt, lengths, k8, s1, k8, s1)
    ops.paged_kv_scatter_decode_ref(*pools, pt, lengths, k8, s1, k8, s1)
    counts = ops.launch_counts()
    assert (counts["weight_only_matmul"], counts["paged_int8_attention"],
            counts["paged_kv_scatter_decode"]) == (1, 1, 1)


def _int4_weight(g, dev, n, k, group):
    """Random packed bytes (every code in [-8, 7]) and scales [N, K/group]."""
    packed = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand(n, k // group, generator=g, device=dev) * 1e-2 + 1e-4
    return packed, scales


INT4_SHAPES = [(1, 64, 8, 32), (4, 4096, 4096, 128), (5, 96, 130, 32), (3, 11008, 72, 128),
               (33, 320, 130, 64), (256, 4096, 200, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", ["split", "legacy"])
@pytest.mark.parametrize("m,k,n,group", INT4_SHAPES)
def test_wo4_vs_plain(cuda, m, k, n, group, formulation):
    g = torch.Generator(device=cuda).manual_seed(m * 13 + n)
    x = torch.randn(m, k, generator=g, device=cuda)
    x = x.to(torch.bfloat16) if formulation == "split" else x
    packed, scales = _int4_weight(g, cuda, n, k, group)
    bias = torch.randn(n, generator=g, device=cuda)
    for out_dtype in (torch.float32, torch.bfloat16):
        for b in (None, bias):
            y = ops.weight_only_int4_matmul(x, packed, scales, group, b, out_dtype, formulation)
            ref = ops.weight_only_int4_matmul_ref(x, packed, scales, group, b, out_dtype,
                                                  formulation)
            torch.cuda.synchronize()
            assert y.dtype == out_dtype and y.shape == (m, n)
            tol = ops.weight_only_int4_tolerance(x, packed, scales, group, ref, formulation)
            assert ((y.float() - ref.float()).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", ["two_level", "group"])
@pytest.mark.parametrize("m,k,n,group", INT4_SHAPES)
def test_w4a8_exact(cuda, m, k, n, group, formulation):
    """Each body through the route its wrapper names for M (group: the
    decode kernel up to GROUP_DECODE_MAX_M rows, the tile kernel above)."""
    g = torch.Generator(device=cuda).manual_seed(m * 17 + n)
    xq, sx = ops.rowquant(torch.randn(m, k, generator=g, device=cuda))
    packed, scales = _int4_weight(g, cuda, n, k, group)
    bias = torch.randn(n, generator=g, device=cuda)
    wrapper = getattr(ops, f"w4a8_{formulation}")
    top = 32 if formulation == "two_level" else importlib.import_module(
        "protoquant_tpu_torch.ops.w4a8_matmul").GROUP_DECODE_MAX_M
    for out_dtype in (torch.float32, torch.bfloat16):
        for b in (None, bias):
            ops.reset_launch_counts()
            y = ops.w4a8_matmul(xq, sx, packed, scales, group, b, out_dtype, formulation)
            ref = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, b, out_dtype, formulation)
            torch.cuda.synchronize()
            assert wrapper.routes["decode" if m <= top else "tile"] == 1
            assert y.dtype == out_dtype and y.shape == (m, n)
            assert torch.equal(y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4096, 4096), (4096, 11008), (32000, 4096)])
def test_two_level_scales_on_card_bitwise(cuda, n, k):
    """r16 and scol made on the card equal the plain version's on the CPU
    (true division on both)."""
    g = torch.Generator(device=cuda).manual_seed(n + k)
    scales = torch.rand(n, k // 128, generator=g, device=cuda) * 3e-2 + 1e-6
    r16, scol = ops.two_level_scales(scales)
    r16_cpu, scol_cpu = ops.two_level_scales(scales.cpu())
    assert torch.equal(r16.cpu(), r16_cpu) and torch.equal(scol.cpu(), scol_cpu)


@pytest.mark.cuda
def test_int4_wrappers_reject_what_the_kernels_do_not_take(cuda):
    packed = torch.zeros(8, 32, dtype=torch.int8, device=cuda)
    scales = torch.ones(8, 2, device=cuda)
    x = torch.zeros(2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.weight_only_int4_matmul(x.float(), packed, scales, 32)
    with pytest.raises(ValueError, match="must be one of"):
        ops.weight_only_int4_matmul(x, packed, torch.ones(8, 4, device=cuda), 16)
    with pytest.raises(ValueError, match="shapes"):
        ops.weight_only_int4_matmul(x, packed, torch.ones(8, 3, device=cuda), 32)
    xq = torch.zeros(2, 64, dtype=torch.int8, device=cuda)
    sx = torch.ones(2, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        ops.w4a8_matmul(xq.float(), sx, packed, scales, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.w4a8_matmul(xq, sx, torch.zeros(32, 8, dtype=torch.int8, device=cuda).t(),
                        scales, 32)
    with pytest.raises(ValueError, match="tensors on"):
        ops.w4a8_matmul(xq, sx, packed, scales.cpu(), 32, formulation="group")


@pytest.mark.cuda
def test_int4_counters_count_each_body(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 64, device=cuda).to(torch.bfloat16)
    packed = torch.randint(-128, 128, (8, 32), dtype=torch.int8, device=cuda)
    scales = torch.rand(8, 2, device=cuda)
    ops.weight_only_int4_matmul(x, packed, scales, 32)
    ops.weight_only_int4_matmul(x, packed, scales, 32, formulation="legacy")
    ops.weight_only_int4_matmul(x, packed, scales, 32, formulation="legacy")
    ops.weight_only_int4_matmul_ref(x, packed, scales, 32)
    xq, sx = ops.rowquant_ref(x)
    ops.w4a8_matmul(xq, sx, packed, scales, 32, formulation="two_level")
    ops.w4a8_matmul(xq, sx, packed, scales, 32, formulation="group")
    ops.w4a8_matmul_ref(xq, sx, packed, scales, 32, formulation="group")
    ops.w4a8_matmul(xq.cpu(), sx.cpu(), packed.cpu(), scales.cpu(), 32)
    counts = ops.launch_counts()
    assert (counts["wo4_split"], counts["wo4_legacy"], counts["w4a8_two_level"],
            counts["w4a8_group"]) == (1, 2, 1, 1)


def _codes_close(q, ref, share):
    dq = (q.int() - ref.int()).abs()
    assert dq.max().item() <= 1
    assert (dq != 0).float().mean().item() < share


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cast", [(torch.bfloat16, torch.bfloat16),
                                        (torch.float32, torch.float32),
                                        (torch.float16, torch.bfloat16),
                                        (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("m,k", [(1, 64), (4, 4096), (37, 4100), (256, 4096)])
def test_rms_norm_quant_vs_plain(cuda, m, k, dtype, cast):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = (torch.randn(m, k, generator=g, device=cuda) * 2).to(dtype)
    w = torch.rand(k, generator=g, device=cuda) + 0.5
    q, s = ops.rms_norm_quant(x, w, eps=1e-5, cast_dtype=cast)
    rq, rs = ops.rms_norm_quant_ref(x, w, eps=1e-5, cast_dtype=cast)
    torch.cuda.synchronize()
    assert q.shape == x.shape and s.shape == (m,)
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=0)
    _codes_close(q, rq, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype,cast", [(torch.bfloat16, torch.bfloat16),
                                        (torch.float32, torch.float32),
                                        (torch.float16, torch.float16)])
@pytest.mark.parametrize("m,k", [(1, 24), (4, 11008), (9, 1000), (256, 11008)])
def test_swiglu_quant_vs_plain(cuda, m, k, dtype, cast, act):
    g = torch.Generator(device=cuda).manual_seed(m * 3 + k)
    gate = (torch.randn(m, k, generator=g, device=cuda) * 2).to(dtype)
    up = (torch.randn(m, k, generator=g, device=cuda) * 2).to(dtype)
    q, s = ops.swiglu_quant(gate, up, act=act, cast_dtype=cast)
    rq, rs = ops.swiglu_quant_ref(gate, up, act=act, cast_dtype=cast)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, rs, rtol=1e-2, atol=0)
    _codes_close(q, rq, 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("m,n", [(1, 7), (3, 5), (40, 200), (4096, 11008)])
def test_dequant_exact(cuda, m, n, axis, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(m + n + axis)
    q = torch.randint(-127, 128, (m, n), generator=g, device=cuda, dtype=torch.int8)
    s = torch.rand(n if axis == 0 else m, generator=g, device=cuda) * 0.05 + 1e-3
    out = ops.dequant(q, s, axis, out_dtype)
    torch.cuda.synchronize()
    assert out.dtype == out_dtype and out.shape == (m, n)
    assert torch.equal(out, ops.dequant_ref(q, s, axis, out_dtype))
    # an unaligned view: 16-byte loads need the copy the wrapper makes
    tail = q.reshape(-1)[3:3 + (m * n - 3) // n * n].reshape(-1, n)
    if tail.shape[0]:
        st = s if axis == 0 else s[1:tail.shape[0] + 1]  # an unaligned scale view too
        assert torch.equal(ops.dequant(tail, st, axis, out_dtype),
                           ops.dequant_ref(tail, st, axis, out_dtype))


@pytest.mark.cuda
def test_fused_wrappers_reject_and_count(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 64, device=cuda).to(torch.bfloat16)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="w shape"):
        ops.rms_norm_quant(x, torch.ones(63, device=cuda), eps=1e-5)
    with pytest.raises(TypeError, match="cast_dtype"):
        ops.rms_norm_quant(x, w, eps=1e-5, cast_dtype=torch.int8)
    with pytest.raises(TypeError, match="must be one of"):
        ops.swiglu_quant(x, x.float())
    with pytest.raises(ValueError, match="tensors on"):
        ops.rms_norm_quant(x, w.cpu(), eps=1e-5)
    ops.rms_norm_quant(x, w, eps=1e-5)
    ops.rms_norm_quant_ref(x, w, eps=1e-5)
    ops.swiglu_quant(x, x)
    ops.swiglu_quant(x.cpu(), x.cpu())
    q = torch.zeros(2, 64, dtype=torch.int8, device=cuda)
    ops.dequant(q, torch.ones(64, device=cuda), 0)
    ops.dequant_ref(q, torch.ones(64, device=cuda), 0)
    counts = ops.launch_counts()
    assert (counts["rms_norm_quant"], counts["swiglu_quant"], counts["dequant"]) == (1, 1, 1)
    routes = ops.route_counts()
    assert routes["swiglu_quant_cluster"] + routes["swiglu_quant_rows"] == 1


# -- the KIVI caches: decode writers (exact) and attentions (ATOL) ---------------

KIVI = {"k4v8": ("k4v8_decode_update", "k4v8_attention"),
        "int4": ("kivi4_decode_update", "int4_kv_attention")}


def _kivi_cache(g, dev, tier, B, KV, S, Dh, G):
    """Random KIVI cache tensors: every packed byte and tail code drawn."""
    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def sc(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 1e-2 + 1e-3

    v = (i8(B, KV, S // 2, Dh), sc(B, KV, 2, S // 2)) if tier == "int4" else (
        i8(B, KV, S, Dh), sc(B, KV, S))
    return [i8(B, KV, S // 2, Dh), sc(B, KV, S // G, Dh), *v, i8(B, KV, 2 * G, Dh),
            sc(B, KV, 2 * G), i8(B, KV, 2 * G, Dh), sc(B, KV, 2 * G)]


def _mirror_v(cache, new_lengths, G):
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


@pytest.mark.cuda
@pytest.mark.parametrize("G,head_dim", [(16, 64), (64, 128), (8, 32)])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_decode_update_exact(cuda, tier, G, head_dim):
    g = torch.Generator(device=cuda).manual_seed(G + head_dim)
    S, KV = 8 * G, 3
    # no flush, the flush of chunk 0, of the last chunk, at capacity, idle
    lens = [G - 2, G - 1, S - 1, S, 2 * G - 1]
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    adv = torch.tensor([1, 1, 1, 1, 0], dtype=torch.int32, device=cuda)
    k8 = torch.randint(-127, 128, (B, KV, 1, head_dim), generator=g, device=cuda,
                       dtype=torch.int8)
    v8 = torch.randint_like(k8, -127, 128)
    ksn = torch.rand(B, KV, 1, generator=g, device=cuda) * 1e-2 + 1e-3
    vsn = torch.rand(B, KV, 1, generator=g, device=cuda) * 1e-2 + 1e-3
    base = _kivi_cache(g, cuda, tier, B, KV, S, head_dim, G)
    a = [t.clone() for t in base]
    b = [t.clone() for t in base]
    writer, _ = KIVI[tier]
    getattr(ops, writer)(*a, lengths, k8, ksn, v8, vsn, group=G, adv=adv)
    getattr(ops, writer + "_ref")(*b, lengths, k8, ksn, v8, vsn, group=G, adv=adv)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    assert not torch.equal(a[0][1], base[0][1]) and torch.equal(a[0][0], base[0][0])



# (KV, S, Dh) of the models a KIVI cache serves: Llama-2-7B, GPT-OSS-20B
# (S as in its KIVI runs), BLOOM-560m
KIVI_SHAPES = {"7b": (32, 1024, 128), "gpt_oss": (8, 2048, 64), "bloom": (16, 2048, 64)}


def _kivi_new_rows(g, dev, B, KV, T, Dh):
    """New rows as the cache hands them over: [B, T, KV, ...] tensors seen
    as [B, KV, T, ...] views."""
    k8 = torch.randint(-127, 128, (B, T, KV, Dh), generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint_like(k8, -127, 128)
    ks = torch.rand(B, T, KV, generator=g, device=dev) * 1e-2 + 1e-3
    vs = torch.rand(B, T, KV, generator=g, device=dev) * 1e-2 + 1e-3
    return [t.transpose(1, 2) for t in (k8, ks, v8, vs)]


def _kivi_update_case(g, dev, tier, shape, T, G=64):
    """Rows at lengths 0, 10, 63, 300, S - 20, S (at capacity) and 127, the
    fourth padded (adv < T; 0 at T = 1), the last idle (adv 0); the cache
    and the new rows random."""
    KV, S, Dh = KIVI_SHAPES[shape]
    lens = [0, 10, 63, 300, S - 20, S, 127]
    advs = [T, T, T, T // 2 if T > 1 else 0, T, T, 0]
    B = len(lens)
    cache = _kivi_cache(g, dev, tier, B, KV, S, Dh, G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    adv = torch.tensor(advs, dtype=torch.int32, device=dev)
    return cache, lengths, adv, _kivi_new_rows(g, dev, B, KV, T, Dh)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 256, 300])
@pytest.mark.parametrize("shape", list(KIVI_SHAPES))
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_update_routes_exact(cuda, tier, shape, T):
    """Both routes of both KIVI updates (decode at T = 1, prefill above)
    against their plain versions, all eight tensors bit for bit, at the
    model shapes: chunks flushed from old tail rows and new rows, T past 2G,
    an idle row, a padded row, writes past S, a row at capacity; one launch
    a call, counted on its route."""
    g = torch.Generator(device=cuda).manual_seed(T + len(shape))
    cache, lengths, adv, new = _kivi_update_case(g, cuda, tier, shape, T)
    a = [t.clone() for t in cache]
    b = [t.clone() for t in cache]
    name = KIVI[tier][0]
    ops.reset_launch_counts()
    getattr(ops, name)(*a, lengths, *new, group=64, adv=adv)
    getattr(ops, name + "_ref")(*b, lengths, *new, group=64, adv=adv)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    assert not torch.equal(a[0], cache[0])  # some chunk flushed
    route = "decode" if T == 1 else "prefill"
    assert ops.route_counts()[f"{name}_{route}"] == 1 and ops.launch_counts()[name] == 1


@pytest.mark.cuda
def test_kivi_update_division_is_ieee(cuda):
    """The update kernel's branch-free division gives IEEE division's bits
    (``__fdiv_rn``) over every f32 significand of the divisor in [1, 2) and
    dividends that are int8 codes times per-token scales of many
    magnitudes."""
    from protoquant_tpu_torch.ops.kv_scatter import kivi_div_check

    g = torch.Generator(device=cuda).manual_seed(5)
    codes = torch.arange(-127, 128, device=cuda, dtype=torch.float32)
    ts = torch.cat([torch.tensor([1e-12, 3.7e-7, 0.013, 1.7, 250.0], device=cuda),
                    torch.rand(3, generator=g, device=cuda) * 0.05])
    xs = (codes[:, None] * ts[None, :]).flatten().contiguous()
    assert kivi_div_check(xs) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 256])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_update_cuda_graph(cuda, tier, T):
    """A KIVI update captured in a CUDA graph and replayed on the same
    cache contents gives the eager call's bits, on either route."""
    g = torch.Generator(device=cuda).manual_seed(171 + T)
    cache, lengths, adv, new = _kivi_update_case(g, cuda, tier, "7b", T)
    fn = getattr(ops, KIVI[tier][0])
    eager = [t.clone() for t in cache]
    fn(*eager, lengths, *new, group=64, adv=adv)
    captured = [t.clone() for t in cache]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*captured, lengths, *new, group=64, adv=adv)
    for t, c in zip(captured, cache):
        t.copy_(c)
    graph.replay()
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(captured, eager)):
        assert torch.equal(x, y), i


@pytest.mark.cuda
@pytest.mark.parametrize("group,T,head_dim,dtype", [
    (1, 1, 128, torch.float32), (4, 1, 128, torch.float32), (2, 5, 64, torch.float32),
    (1, 33, 128, torch.float32), (2, 3, 256, torch.float32), (1, 1, 128, torch.bfloat16)])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_attention_vs_plain(cuda, tier, group, T, head_dim, dtype):
    """Against the plain version; a call the split design does not take
    (more rows a kv head than a split block holds: T 33 at Dh 128, T 3 at
    Dh 256) goes to the prefill kernel and is also held to its bf16-lane
    spelling within TIGHT, two calls giving the same bits."""
    from protoquant_tpu_torch.ops import attention as A

    g = torch.Generator(device=cuda).manual_seed(group * 7 + T)
    G, S, KV = 16, 128, 2
    lens = [0, 15, 40, S - T]
    B = len(lens)
    cache = _kivi_cache(g, cuda, tier, B, KV, S, head_dim, G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    new_lengths = lengths + T
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, G)
    q = torch.randn(B, T, KV * group, head_dim, generator=g, device=cuda).to(dtype)
    _, attn = KIVI[tier]
    fn = getattr(ops, attn)
    prefill = A.kivi_split_plan(T, KV * group, KV, S, head_dim, G) is None
    ops.reset_launch_counts()
    out = fn(q, *cache, lengths, new_lengths, group=G)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, group=G)
    torch.cuda.synchronize()
    assert fn.routes["prefill" if prefill else "split"] == 1
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    if prefill:
        _kivi_tiles_check(tier, q, cache, lengths, new_lengths, out, dict(group=G))
        assert torch.equal(fn(q, *cache, lengths, new_lengths, group=G), out)


def _kivi_tiles_check(tier, q, cache, lengths, new_lengths, out, kw):
    """The KIVI prefill kernel's output ``out`` against its bf16-lane
    spelling (``kivi_attention_tiles_ref``) within TIGHT; mass: the plain
    version over |v|."""
    from protoquant_tpu_torch.ops import attention as A

    tiles = A.kivi_attention_tiles_ref(q, *cache, lengths, new_lengths, v4=tier == "int4", **kw)
    G = kw["group"]
    kq, kchs, vq, vs, kt, kts, vt, vts = cache
    k = A.kivi_dequant_k(kq, kchs, kt, kts, new_lengths, G)
    v = (A.kivi_dequant_v4(vq, vs, vt, vts, new_lengths, G) if tier == "int4"
         else vq.float() * vs[..., None])
    ones = torch.ones(k.shape[:3], device=k.device)
    variants = {key: val for key, val in kw.items() if key != "group"}
    mass = A.int8_kv_attention_ref(q.float(), k, ones, v.abs(), ones, lengths, **variants)
    out, tiles = out.float(), tiles.float()
    ulp, share = TIGHT[q.dtype]
    tight = ulp * tiles.abs() + share * mass + 1e-6
    assert ((out - tiles).abs() <= tight).all(), ((out - tiles).abs() - tight).max().item()


# (label, T, group, S, Dh, G, lengths, variants): prefill chunks over the KIVI
# caches crossing chunk boundaries and the frontier at Llama's group 1 and
# G 16, GPT-OSS's group 8 with learned sinks and a window, Gemma-2's window,
# scale and softcap at Dh 256 with G 8 (q drawn large so the cap bites),
# BLOOM's ALiBi with G 4 (scale rows read from global memory), a G of 96
# that does not tile, and a padded chunk reaching past S (Dh 32)
KIVI_PREFILL_CASES = [
    ("full", 130, 1, 512, 128, 16, [0, 300], {}),
    ("gqa8 sinks window", 70, 8, 512, 64, 64, [20, 400], {"window": 100, "learned": True}),
    ("window softcap", 100, 2, 512, 256, 8, [0, 300],
     {"window": 40, "scale": 0.0625, "softcap": 8.0}),
    ("alibi small G", 70, 1, 512, 64, 4, [37, 290], {"alibi": True}),
    ("G 96", 70, 2, 768, 64, 96, [100, 500], {}),
    ("past S", 100, 2, 256, 32, 16, [246, 100], {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
@pytest.mark.parametrize("case", KIVI_PREFILL_CASES, ids=[c[0] for c in KIVI_PREFILL_CASES])
def test_kivi_prefill_vs_tiles_and_plain(cuda, case, tier, dtype):
    """Every KIVI variant at every q dtype on the prefill kernel: against
    the bf16-lane spelling within TIGHT, against the plain version within
    ATOL (f32) or 2^-7 of the largest output; two calls give the same bits;
    the calls are counted under the "prefill" route."""
    from protoquant_tpu_torch.models.llama import alibi_slopes
    from protoquant_tpu_torch.ops import attention as A

    label, T, group, S, Dh, G, lens, variants = case
    g = torch.Generator(device=cuda).manual_seed(151 + T + Dh + G)
    B, KV, H = len(lens), 2, 2 * group
    cache = _kivi_cache(g, cuda, tier, B, KV, S, Dh, G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    new_lengths = lengths + T
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, G)
    kw = {k: v for k, v in variants.items() if k not in ("alibi", "learned")}
    gain = 8.0 if kw.get("softcap") else 1.0
    q = (torch.randn(B, T, H, Dh, generator=g, device=cuda) * gain).to(dtype)
    if variants.get("alibi"):
        kw["alibi_slopes"] = alibi_slopes(H).to(cuda)
    if variants.get("learned"):
        kw["sink_logits"] = torch.randn(H, generator=g, device=cuda) * 2
    kw["group"] = G
    assert A.kivi_split_plan(T, H, KV, S, Dh, G) is None
    _, attn = KIVI[tier]
    fn = getattr(ops, attn)
    ops.reset_launch_counts()
    out = fn(q, *cache, lengths, new_lengths, **kw)
    again = fn(q, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert fn.routes == {"split": 0, "prefill": 2}
    assert ops.route_counts()[attn + "_prefill"] == 2
    _kivi_tiles_check(tier, q, cache, lengths, new_lengths, out, kw)
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_prefill_cuda_graph_and_alignment(cuda, tier):
    """A KIVI prefill call captured in a CUDA graph and replayed gives the
    eager call's bits; a packed K whose address is not 16-byte aligned is
    refused before launch."""
    g = torch.Generator(device=cuda).manual_seed(161)
    G, S, KV, T = 64, 1024, 4, 256
    cache = _kivi_cache(g, cuda, tier, 2, KV, S, 128, G)
    lengths = torch.tensor([10, 300], dtype=torch.int32, device=cuda)
    new_lengths = lengths + T
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, G)
    q = torch.randn(2, T, KV, 128, generator=g, device=cuda).to(torch.bfloat16)
    fn = getattr(ops, KIVI[tier][1])
    eager = fn(q, *cache, lengths, new_lengths, group=G)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(q, *cache, lengths, new_lengths, group=G)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    kq = cache[0]
    shifted = torch.empty(kq.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(kq.shape)
    shifted.copy_(kq)
    with pytest.raises(ValueError, match="16-byte"):
        fn(q, shifted, *cache[1:], lengths, new_lengths, group=G)


@pytest.mark.cuda
def test_kivi_wrappers_reject_and_count(cuda):
    ops.reset_launch_counts()
    g = torch.Generator(device=cuda).manual_seed(0)
    cache = _kivi_cache(g, cuda, "int4", 1, 2, 32, 64, 8)
    lengths = torch.tensor([5], dtype=torch.int32, device=cuda)
    q = torch.randn(1, 1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.int4_kv_attention(torch.randn(1, 1, 2, 48, device=cuda), *cache, lengths,
                              lengths + 1, group=8)
    with pytest.raises(ValueError, match="vq shape"):  # an Int4 cache is no K4V8 cache
        ops.k4v8_attention(q, *cache, lengths, lengths + 1, group=8)
    with pytest.raises(TypeError, match="int32"):
        ops.int4_kv_attention(q, *cache, lengths.long(), lengths + 1, group=8)
    ops.int4_kv_attention(q, *cache, lengths, lengths + 1, group=8)
    ops.int4_kv_attention_ref(q, *cache, lengths, lengths + 1, group=8)
    k8 = torch.zeros(1, 2, 1, 64, dtype=torch.int8, device=cuda)
    s1 = torch.ones(1, 2, 1, device=cuda)
    ops.kivi4_decode_update(*cache, lengths, k8, s1, k8, s1, group=8)
    ops.kivi4_decode_update([t.cpu() for t in cache][0], *[t.cpu() for t in cache][1:],
                            lengths.cpu(), k8.cpu(), s1.cpu(), k8.cpu(), s1.cpu(), group=8)
    counts = ops.launch_counts()
    assert (counts["int4_kv_attention"], counts["kivi4_decode_update"]) == (1, 1)


# -- the split-S KIVI decode (csrc/kivi_split.cuh): against the plain versions -----

SPLIT_G, SPLIT_S = 64, 1024
# head dim -> GQA group of the decode rows (GPT-OSS's 8 at 64, Llama's 1 at
# 128, Gemma-2's 2 at 256)
SPLIT_GROUPS = {64: 8, 128: 1, 256: 2}


def _split_case(g, dev, tier, Dh, lens, T=1, KV=2, group=None):
    """q (f32), a KIVI cache with its V tail mirrored, and the lengths before
    and after the step, for a call that takes the split design."""
    group = SPLIT_GROUPS[Dh] if group is None else group
    B = len(lens)
    cache = _kivi_cache(g, dev, tier, B, KV, SPLIT_S, Dh, SPLIT_G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    new_lengths = lengths + T
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, SPLIT_G)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=dev)
    from protoquant_tpu_torch.ops.attention import kivi_split_plan
    assert kivi_split_plan(T, KV * group, KV, SPLIT_S, Dh, SPLIT_G) is not None
    return q, cache, lengths, new_lengths


def _split_lengths(Dh):
    """0, G - 1, G, a split - 1, a split, S - 1 and S (the last one's row
    sees every key, its own position past the capacity)."""
    from protoquant_tpu_torch.ops.attention import kivi_split_plan
    span, _ = kivi_split_plan(1, SPLIT_GROUPS[Dh], 1, SPLIT_S, Dh, SPLIT_G)
    return [0, SPLIT_G - 1, SPLIT_G, span - 1, span, SPLIT_S - 1, SPLIT_S]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_split_boundaries_vs_plain(cuda, tier, head_dim, dtype):
    g = torch.Generator(device=cuda).manual_seed(head_dim + 3)
    q, cache, lengths, new_lengths = _split_case(g, cuda, tier, head_dim,
                                                 _split_lengths(head_dim))
    q = q.to(dtype)
    _, attn = KIVI[tier]
    out = getattr(ops, attn)(q, *cache, lengths, new_lengths, group=SPLIT_G)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, group=SPLIT_G)
    torch.cuda.synchronize()
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_split_window_dead_splits_vs_plain(cuda, tier, T):
    """A window of 100 at lengths 900 to 1020: splits 0 to 2 (keys below 768)
    are wholly below every row's window; with softcap and scale."""
    g = torch.Generator(device=cuda).manual_seed(T + 21)
    q, cache, lengths, new_lengths = _split_case(g, cuda, tier, 128, [900, 1000, 1020 - T],
                                                 T=T, group=2)
    _, attn = KIVI[tier]
    kw = dict(group=SPLIT_G, window=100, scale=0.1, softcap=5.0)
    out = getattr(ops, attn)(q * 4, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q * 4, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_split_sinks_tail_only_vs_plain(cuda, tier, alibi):
    """Learned sinks where only the tail split is live: a window of 8 at
    lengths 10 to 40 past a chunk boundary sees tail positions alone."""
    from protoquant_tpu_torch.models.llama import alibi_slopes

    g = torch.Generator(device=cuda).manual_seed(31 + alibi)
    q, cache, lengths, new_lengths = _split_case(g, cuda, tier, 64, [74, 266, 650, 1000])
    H = q.shape[2]
    _, attn = KIVI[tier]
    kw = dict(group=SPLIT_G, window=8,
              sink_logits=torch.randn(H, generator=g, device=cuda) * 2,
              alibi_slopes=alibi_slopes(H).to(cuda) if alibi else None)
    out = getattr(ops, attn)(q, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_split_large_batch_vs_plain(cuda, tier):
    """A 7B decode at batch 9 (B KV = 288 blocks a split, more than twice
    the SMs) takes the split design too; with a window and learned sinks."""
    g = torch.Generator(device=cuda).manual_seed(43)
    lens = [63, 700, 1023, 255, 0, 128, 511, 900, SPLIT_S - 1]
    q, cache, lengths, new_lengths = _split_case(g, cuda, tier, 128, lens, KV=32)
    _, attn = KIVI[tier]
    kw = dict(group=SPLIT_G, window=300,
              sink_logits=torch.randn(q.shape[2], generator=g, device=cuda))
    out = getattr(ops, attn)(q, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,group,G", [(128, 1, 4), (256, 8, 64), (64, 1, 96)])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_one_pass_decode_vs_plain(cuda, tier, Dh, group, G):
    """The decodes the split design cannot take go to the prefill kernel: a
    chunk G below 8, more rows a kv head than a split block holds (8 at Dh
    256), a G that neither divides nor is divided by the tile (96 at Dh 64);
    with a window and learned sinks, at batch 9."""
    from protoquant_tpu_torch.ops.attention import kivi_split_plan

    g = torch.Generator(device=cuda).manual_seed(Dh + group + G)
    S, KV = 8 * G if G > 8 else 256, 4
    assert kivi_split_plan(1, KV * group, KV, S, Dh, G) is None
    lens = [0, 1, G - 1, G, 2 * G + 3, S // 2, S - 2, S - 1, S]
    B = len(lens)
    cache = _kivi_cache(g, cuda, tier, B, KV, S, Dh, G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    new_lengths = lengths + 1
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, G)
    q = torch.randn(B, 1, KV * group, Dh, generator=g, device=cuda)
    _, attn = KIVI[tier]
    kw = dict(group=G, window=S // 3,
              sink_logits=torch.randn(KV * group, generator=g, device=cuda))
    out = getattr(ops, attn)(q, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_split_bitwise_and_cuda_graph(cuda, tier):
    """Two calls give the same bits; the call captured in a CUDA graph and
    replayed gives the eager call's bits, and counts one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(41)
    q, cache, lengths, new_lengths = _split_case(g, cuda, tier, 128, [63, 700, 1023, 255],
                                                 KV=32)
    q = q.to(torch.bfloat16)
    _, attn = KIVI[tier]
    fn = getattr(ops, attn)
    sinks = torch.randn(q.shape[2], generator=g, device=cuda)
    call = lambda: fn(q, *cache, lengths, new_lengths, group=SPLIT_G, sink_logits=sinks)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    assert ops.launch_counts()[attn] == 1


# -- the mixed K8V4 cache: decode writer (exact) and attention (ATOL) ------------


def _mixed_cache(g, dev, B, KV, S, Dh):
    """Random K8V4 cache tensors (kq, ks, vq, vs): every packed V byte drawn."""
    kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=g, device=dev, dtype=torch.int8)
    vq = torch.randint(-128, 128, (B, KV, S // 2, Dh), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(B, KV, S, generator=g, device=dev) * 1e-2 + 1e-3
    vs = torch.rand(B, KV, 2, S // 2, generator=g, device=dev) * 1e-2 + 1e-3
    return [kq, ks, vq, vs]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 128])
def test_mixed_scatter_exact(cuda, head_dim):
    g = torch.Generator(device=cuda).manual_seed(head_dim)
    B, KV, S = 6, 3, 96
    # even, odd, the last position, at capacity and past it (dropped), zero
    lengths = torch.tensor([10, 11, S - 1, S, S + 3, 0], dtype=torch.int32, device=cuda)
    base = _mixed_cache(g, cuda, B, KV, S, head_dim)
    k8 = torch.randint(-127, 128, (B, KV, 1, head_dim), generator=g, device=cuda,
                       dtype=torch.int8)
    v4 = torch.randint(-7, 8, (B, KV, 1, head_dim), generator=g, device=cuda,
                       dtype=torch.int8)
    ksn = torch.rand(B, KV, 1, generator=g, device=cuda)
    vsn = torch.rand(B, KV, 1, generator=g, device=cuda)
    a = [t.clone() for t in base]
    b = [t.clone() for t in base]
    ops.kv_mixed_scatter_decode(*a, lengths, k8, ksn, v4, vsn)
    ops.kv_mixed_scatter_decode_ref(*b, lengths, k8, ksn, v4, vsn)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    for r in (3, 4):  # rows at or past S: nothing written
        assert all(torch.equal(x[r], y[r]) for x, y in zip(a, base))
    # row 0 (even) changed only low nibbles of its V byte row, row 1 only high ones
    assert torch.equal(a[2][0, :, 5] & -16, base[2][0, :, 5] & -16)
    assert torch.equal(a[2][1, :, 5] & 15, base[2][1, :, 5] & 15)


@pytest.mark.cuda
@pytest.mark.parametrize("group,T,head_dim,dtype", [
    (1, 1, 128, torch.float32), (4, 1, 128, torch.float32), (2, 5, 64, torch.float32),
    (1, 33, 128, torch.float32), (2, 3, 256, torch.float32), (1, 40, 32, torch.float32),
    (1, 1, 128, torch.bfloat16)])
def test_mixed_attention_vs_plain(cuda, group, T, head_dim, dtype):
    g = torch.Generator(device=cuda).manual_seed(group * 11 + T)
    S, KV = 96, 2
    # an empty row, odd and even lengths, a chunk ending at S, and for
    # T > 1 a chunk that reaches past S
    lens = [0, 15, 40, S - T] + ([S - T // 2] if T > 1 else [])
    B = len(lens)
    cache = _mixed_cache(g, cuda, B, KV, S, head_dim)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn(B, T, KV * group, head_dim, generator=g, device=cuda).to(dtype)
    out = ops.mixed_kv_attention(q, *cache, lengths)
    ref = ops.mixed_kv_attention_ref(q, *cache, lengths)
    torch.cuda.synchronize()
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_mixed_wrappers_reject_and_count(cuda):
    ops.reset_launch_counts()
    g = torch.Generator(device=cuda).manual_seed(0)
    kq, ks, vq, vs = _mixed_cache(g, cuda, 1, 2, 32, 64)
    lengths = torch.tensor([5], dtype=torch.int32, device=cuda)
    q = torch.randn(1, 1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        c48 = _mixed_cache(g, cuda, 1, 2, 32, 48)
        ops.mixed_kv_attention(torch.randn(1, 1, 2, 48, device=cuda), *c48, lengths)
    with pytest.raises(ValueError, match="scale or length"):  # an int8 cache's V scales
        ops.mixed_kv_attention(q, kq, ks, vq, ks, lengths)
    with pytest.raises(ValueError, match="vs cache"):  # an int8 cache's V
        ops.mixed_kv_attention(q, kq, ks, kq, vs, lengths)
    with pytest.raises(TypeError, match="int32"):
        ops.mixed_kv_attention(q, kq, ks, vq, vs, lengths.long())
    k8 = torch.zeros(1, 2, 1, 64, dtype=torch.int8, device=cuda)
    s1 = torch.ones(1, 2, 1, device=cuda)
    with pytest.raises(ValueError, match="vs shape"):
        ops.kv_mixed_scatter_decode(kq, ks, vq, ks, lengths, k8, s1, k8, s1)
    with pytest.raises(TypeError, match="int8"):
        ops.kv_mixed_scatter_decode(kq, ks, vq, vs, lengths, k8, s1, k8.float(), s1)
    with pytest.raises(ValueError, match="tensors on"):
        ops.kv_mixed_scatter_decode(kq, ks, vq, vs, lengths.cpu(), k8, s1, k8, s1)
    ops.mixed_kv_attention(q, kq, ks, vq, vs, lengths)
    ops.mixed_kv_attention_ref(q, kq, ks, vq, vs, lengths)
    ops.kv_mixed_scatter_decode(kq, ks, vq, vs, lengths, k8, s1, k8, s1)
    ops.kv_mixed_scatter_decode(*(t.cpu() for t in (kq, ks, vq, vs, lengths, k8, s1, k8, s1)))
    counts = ops.launch_counts()
    assert (counts["mixed_kv_attention"], counts["kv_mixed_scatter_decode"]) == (1, 1)
    assert counts["int8_kv_attention"] == counts["kv_scatter_decode"] == 0


# -- the split-S int8 and K8V4 decode (csrc/attn_split.cuh): against the plain versions --

# head dim -> GQA group of the decode rows (4 at 32, GPT-OSS's 8 at 64,
# Llama's 1 at 128, Gemma-2's 2 at 256)
DENSE_GROUPS = {32: 4, 64: 8, 128: 1, 256: 2}
DENSE_S = 1024


def _dense_case(g, dev, kind, Dh, lens, T=1, KV=2, group=None, S=DENSE_S):
    """q (f32), an int8 or K8V4 cache and the lengths before the step, for a
    call that takes the split design."""
    from protoquant_tpu_torch.ops.attention import attn_split_plan

    group = DENSE_GROUPS[Dh] if group is None else group
    B = len(lens)
    if kind == "int8":
        kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=g, device=dev, dtype=torch.int8)
        vq = torch.randint_like(kq, -127, 128)
        ks = torch.rand(B, KV, S, generator=g, device=dev) * 1e-2 + 1e-3
        vs = torch.rand(B, KV, S, generator=g, device=dev) * 1e-2 + 1e-3
        cache = [kq, ks, vq, vs]
    else:
        cache = _mixed_cache(g, dev, B, KV, S, Dh)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=dev)
    assert attn_split_plan(T, KV * group, KV, S, Dh) is not None
    return q, cache, lengths


DENSE = {"int8": "int8_kv_attention", "k8v4": "mixed_kv_attention"}


def _dense_check(kind, q, cache, lengths, **kw):
    name = DENSE[kind]
    out = getattr(ops, name)(q, *cache, lengths, **kw)
    ref = getattr(ops, name + "_ref")(q, *cache, lengths, **kw)
    torch.cuda.synchronize()
    atol = ATOL if q.dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_attn_split_boundaries_vs_plain(cuda, kind, head_dim, dtype):
    """Lengths 0, a split - 1, a split, twice a split - 1, S - 1 and S (the
    last row's position past the capacity: it sees every key)."""
    from protoquant_tpu_torch.ops.attention import attn_split_plan

    span, _ = attn_split_plan(1, DENSE_GROUPS[head_dim], 1, DENSE_S, head_dim)
    lens = [0, span - 1, span, 2 * span - 1, DENSE_S - 1, DENSE_S]
    g = torch.Generator(device=cuda).manual_seed(head_dim + 7)
    q, cache, lengths = _dense_case(g, cuda, kind, head_dim, lens)
    _dense_check(kind, q.to(dtype), cache, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2])
def test_attn_split_window_dead_splits_vs_plain(cuda, T):
    """A window of 100 at lengths 900 to 1020: the splits below 768 are wholly
    below every row's window; with softcap and scale (Gemma-2's variants).
    The grid covers the window alone (2 splits of 128, not 8), but not
    where StreamingLLM sinks or ring positions come with the window."""
    from protoquant_tpu_torch.ops.attention import attn_split_plan

    assert attn_split_plan(T, 4, 2, DENSE_S, 128, window=100) == (128, 2)
    assert attn_split_plan(T, 4, 2, DENSE_S, 128, window=100, sinks=4) == (128, 8)
    assert attn_split_plan(T, 4, 2, DENSE_S, 128, window=100, ring=True) == (128, 8)
    assert attn_split_plan(T, 4, 2, DENSE_S, 128, window=5000) == (128, 8)
    g = torch.Generator(device=cuda).manual_seed(T + 51)
    q, cache, lengths = _dense_case(g, cuda, "int8", 128, [900, 1000, 1020 - T], T=T, group=2)
    _dense_check("int8", q * 4, cache, lengths, window=100, scale=0.1, softcap=5.0)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [700, 4096])
def test_attn_split_window_grid_in_one_wave_vs_plain(cuda, window):
    """Rows that have filled their windows, so many that their splits of 128
    would not fit one wave of the card: the kernel takes a longer span (at
    7B's KV = 32 with B = 8, window 700 over S 1024, and at Gemma-2's B = 4,
    KV = 8, Dh 256, window 4096 over S 8192), also with one short row among
    them."""
    B, KV, Dh, group, S = (8, 32, 128, 1, DENSE_S) if window < 1000 else (4, 8, 256, 2, 8192)
    full = [window, window + 191, S - 300, S - 1, window + 5, window + 64, S - 2, S - 128][:B]
    for lens in (full, [full[0], 3] + full[2:]):
        g = torch.Generator(device=cuda).manual_seed(121 + window + lens[1])
        q, cache, lengths = _dense_case(g, cuda, "int8", Dh, lens, KV=KV, group=group, S=S)
        _dense_check("int8", q.to(torch.bfloat16), cache, lengths, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("sinks", [0, 4])
def test_attn_split_ring_vs_plain(cuda, sinks, alibi):
    """A ring of 544 columns (window 256, chunk 256 and 32 of rounding):
    rows inside it (columns never written), at its wrap and wrapped many
    times, with StreamingLLM sinks and ALiBi, 4 rows a kv head (Mistral)."""
    from protoquant_tpu_torch.models import ring_positions
    from protoquant_tpu_torch.models.llama import alibi_slopes

    C, W = 544, 256
    lens = [30, C - sinks - 1, C - sinks, 5000]
    g = torch.Generator(device=cuda).manual_seed(61 + sinks + alibi)
    q, cache, lengths = _dense_case(g, cuda, "int8", 128, lens, group=4, S=C)
    cache[1][:, :, :sinks] *= 10.0  # the sinks draw attention
    kw = dict(window=W, k_positions=ring_positions(lengths + 1, C, sinks), sinks=sinks)
    if alibi:
        kw["alibi_slopes"] = alibi_slopes(q.shape[2]).to(cuda)
    _dense_check("int8", q, cache, lengths, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [40, 300])
def test_attn_split_sinks_on_contiguous_cache_vs_plain(cuda, window):
    """StreamingLLM sinks over a contiguous cache stay visible (as the XLA
    formulation keeps them): the split holding them is walked though the
    window lies splits above it; 70 sinks and the window's first keys share
    a split at the short lengths."""
    g = torch.Generator(device=cuda).manual_seed(71 + window)
    q, cache, lengths = _dense_case(g, cuda, "int8", 64, [0, 100, 300, 700, 1023])
    cache[1][:, :, :70] *= 10.0
    out, ref = _dense_check("int8", q, cache, lengths, window=window, sinks=70)
    dropped = ops.int8_kv_attention_ref(q, *cache, lengths, window=window)
    assert (dropped - ref).abs().max() > 10 * ATOL  # the sinks bite


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_attn_split_learned_sinks_one_split_live_vs_plain(cuda, kind):
    """GPT-OSS's learned sinks (int8) where a window of 8 leaves one split
    live a row; K8V4 (no sinks) with a score scale over the same lengths."""
    g = torch.Generator(device=cuda).manual_seed(81)
    q, cache, lengths = _dense_case(g, cuda, kind, 64, [3, 255, 260, 700, 1023])
    if kind == "int8":
        kw = dict(window=8, sink_logits=torch.randn(q.shape[2], generator=g, device=cuda) * 2)
    else:
        kw = dict(scale=0.1)
    _dense_check(kind, q, cache, lengths, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [9, 32])
@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_attn_split_large_batch_vs_plain(cuda, kind, B):
    """A 7B decode at batch 9 and 32 (B KV more than twice the SMs): the
    split design at any batch."""
    g = torch.Generator(device=cuda).manual_seed(91 + B)
    lens = ([63, 700, 1023, 255, 0, 128, 511, 900, DENSE_S - 1] * 4)[:B]
    q, cache, lengths = _dense_case(g, cuda, kind, 128, lens, KV=32)
    _dense_check(kind, q.to(torch.bfloat16), cache, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_attn_split_bitwise_and_cuda_graph(cuda, kind):
    """Two calls give the same bits; the call captured in a CUDA graph and
    replayed gives the eager call's bits, and counts one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(101)
    q, cache, lengths = _dense_case(g, cuda, kind, 128, [63, 700, 1023, 255], KV=32)
    q = q.to(torch.bfloat16)
    fn = getattr(ops, DENSE[kind])
    kw = {"window": 300, "sink_logits": torch.randn(q.shape[2], generator=g, device=cuda)
          } if kind == "int8" else {"scale": 0.1}
    call = lambda: fn(q, *cache, lengths, **kw)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    assert ops.launch_counts()[DENSE[kind]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_attn_prefill_takes_the_one_pass_kernel(cuda, kind):
    """A prefill chunk of 256 (more rows a kv head than a split block holds)
    goes to the prefill kernel (csrc/attn_prefill.cuh) in one launch; the
    plan says so, and the wrapper counts it under its "prefill" route."""
    from protoquant_tpu_torch.ops.attention import attn_split_plan

    g = torch.Generator(device=cuda).manual_seed(111)
    assert attn_split_plan(256, 2, 2, DENSE_S, 128) is None
    q, cache, lengths = _dense_case(g, cuda, kind, 128, [300, 700], T=1)
    q = torch.randn(2, 256, 2, 128, generator=g, device=cuda)
    ops.reset_launch_counts()
    _dense_check(kind, q, cache, lengths)
    assert getattr(ops, DENSE[kind]).routes == {"split": 0, "prefill": 1}
    assert ops.route_counts()[DENSE[kind] + "_prefill"] == 1


# -- the prefill kernel (csrc/attn_prefill.cuh): bf16 tensor cores ---------------

# (label, kind, T, group, S, Dh, lengths, variants): full causal at Llama's
# group 1 and GPT-OSS's 8, a window whose edge falls inside a block with
# Gemma-2's scale and softcap at Dh 256 (q drawn large so the cap bites),
# Mistral's ring with StreamingLLM sinks and ALiBi, sinks over a contiguous
# cache (two tiles of them), learned sinks with a window of 8, K8V4 with its
# score scale, and padded chunks whose last rows reach past S (Dh 32, and
# K8V4 at Dh 256 with an odd length)
PREFILL_CASES = [
    ("full", "int8", 130, 1, 512, 128, [0, 300], {}),
    ("gqa8", "int8", 70, 8, 512, 64, [20, 400], {}),
    ("window softcap", "int8", 100, 2, 512, 256, [0, 300],
     {"window": 40, "scale": 0.0625, "softcap": 8.0}),
    ("ring", "int8", 70, 4, 256, 128, [30, 3000],
     {"window": 128, "sinks": 4, "alibi": True, "ring": True}),
    ("streaming sinks", "int8", 70, 2, 320, 64, [200, 250],
     {"window": 40, "sinks": 70, "alibi": True}),
    ("learned sinks", "int8", 70, 8, 256, 64, [20, 150], {"window": 8, "learned": True}),
    ("k8v4 scale", "k8v4", 70, 2, 512, 128, [3, 255], {"scale": 0.1}),
    ("past S", "int8", 100, 2, 256, 32, [246, 100], {}),
    ("k8v4 past S", "k8v4", 40, 2, 256, 256, [249, 30], {}),
]
# the kernel against its bf16-lane spelling (dense_attention_tiles_ref at the
# kernel's terms: p * vs in 3 bf16 terms, q in 1 to 3): the two differ by
# f32 sums in another order, and the output may take the other neighbour
# in bf16 (one ulp: at most 2^-7 of it) or f16 (2^-10). mass: sum_c |p vs
# v| / l, the plain version over |v|.
TIGHT = {torch.bfloat16: (2.0**-7, 2.0**-16), torch.float16: (2.0**-10, 2.0**-16),
         torch.float32: (0.0, 2.0**-16)}


def _prefill_case(g, dev, kind, T, group, S, Dh, lens, variants, dtype):
    """q (``dtype``), the cache (sinks' scales x10), the lengths and the
    wrapper's keywords of one PREFILL_CASES row."""
    from protoquant_tpu_torch.models import ring_positions
    from protoquant_tpu_torch.models.llama import alibi_slopes

    B, KV, H = len(lens), 2, 2 * group
    if kind == "int8":
        kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=g, device=dev, dtype=torch.int8)
        vq = torch.randint_like(kq, -127, 128)
        ks = torch.rand(B, KV, S, generator=g, device=dev) * 1e-2 + 1e-3
        vs = torch.rand(B, KV, S, generator=g, device=dev) * 1e-2 + 1e-3
        cache = [kq, ks, vq, vs]
    else:
        cache = _mixed_cache(g, dev, B, KV, S, Dh)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = {k: v for k, v in variants.items() if k not in ("alibi", "learned", "ring")}
    cache[1][:, :, :kw.get("sinks", 0)] *= 10.0
    gain = 8.0 if kw.get("softcap") else 1.0
    q = (torch.randn(B, T, H, Dh, generator=g, device=dev) * gain).to(dtype)
    if variants.get("alibi"):
        kw["alibi_slopes"] = alibi_slopes(H).to(dev)
    if variants.get("learned"):
        kw["sink_logits"] = torch.randn(H, generator=g, device=dev) * 2
    if variants.get("ring"):
        kw["k_positions"] = ring_positions(lengths + T, S, kw["sinks"])
    return q, cache, lengths, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_attn_prefill_vs_tiles_and_plain(cuda, case, dtype):
    """Every variant at every q dtype: the kernel against its bf16-lane
    spelling within TIGHT, against the plain version within ATOL (f32) or
    2^-7 of the largest output; two calls give the same bits; the call is
    counted under the "prefill" route."""
    from protoquant_tpu_torch.ops import attention as A

    label, kind, T, group, S, Dh, lens, variants = case
    g = torch.Generator(device=cuda).manual_seed(131 + T + Dh)
    q, cache, lengths, kw = _prefill_case(g, cuda, kind, T, group, S, Dh, lens, variants, dtype)
    assert A.attn_split_plan(T, q.shape[2], 2, S, Dh, kw.get("window", 0), kw.get("sinks", 0),
                             "k_positions" in kw) is None
    fn = getattr(ops, DENSE[kind])
    ops.reset_launch_counts()
    out = fn(q, *cache, lengths, **kw)
    again = fn(q, *cache, lengths, **kw)
    ref = getattr(ops, DENSE[kind] + "_ref")(q, *cache, lengths, **kw)
    tiles = A.dense_attention_tiles_ref(q, *cache, lengths, v4=kind == "k8v4", **kw)
    kq, ks, vq, vs = cache
    if kind == "k8v4":
        vq, vs = A.unpack_v4(vq, vs)
    mass = A.int8_kv_attention_ref(q.float(), kq, ks, vq.abs(), vs, lengths, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert fn.routes == {"split": 0, "prefill": 2}
    out, ref, tiles = out.float(), ref.float(), tiles.float()
    ulp, share = TIGHT[dtype]
    tight = ulp * tiles.abs() + share * mass + 1e-6
    assert ((out - tiles).abs() <= tight).all(), ((out - tiles).abs() - tight).max().item()
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.abs().max().item()
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_attn_prefill_cuda_graph_and_alignment(cuda, kind):
    """A prefill call captured in a CUDA graph and replayed gives the eager
    call's bits (no workspace, no host sync); a cache whose payload is not
    16-byte aligned is refused before launch."""
    g = torch.Generator(device=cuda).manual_seed(141)
    q, cache, lengths, kw = _prefill_case(g, cuda, kind, 130, 4, 512, 128, [10, 300],
                                          {"scale": 0.1}, torch.bfloat16)
    fn = getattr(ops, DENSE[kind])
    eager = fn(q, *cache, lengths, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(q, *cache, lengths, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    kq = cache[0]
    shifted = torch.empty(kq.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(kq.shape)
    shifted.copy_(kq)
    with pytest.raises(ValueError, match="16-byte"):
        fn(q, shifted, *cache[1:], lengths, **kw)


# -- the sliding-window, score-scale and softcap variants (Gemma-2 heads) --------

# (T, window, scale, softcap): decode with a window across tiles, a prefill
# chunk whose rows' windows are disjoint (window < T), the score scale
# alone, and Gemma-2's three together
VARIANTS = [(1, 40, 0.0, 0.0), (9, 3, 0.0, 0.0), (1, 0, 0.0625, 0.0), (5, 50, 0.0625, 8.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,window,scale,softcap", VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_variants_vs_plain(cuda, T, window, scale, softcap, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + window)
    B, KV, group, S, Dh = 4, 2, 2, 192, 256
    kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=g, device=cuda, dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2 + 1e-3
    vs = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2 + 1e-3
    lengths = torch.tensor([0, 37, 130, S - T], dtype=torch.int32, device=cuda)
    # q large enough that the scores pass the softcap
    q = (torch.randn(B, T, KV * group, Dh, generator=g, device=cuda) * 8).to(dtype)
    kw = dict(window=window, scale=scale, softcap=softcap)
    out = ops.int8_kv_attention(q, kq, ks, vq, vs, lengths, **kw)
    ref = ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, **kw)
    torch.cuda.synchronize()
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,window,scale,softcap", VARIANTS)
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_attention_variants_vs_plain(cuda, tier, T, window, scale, softcap):
    g = torch.Generator(device=cuda).manual_seed(T + window + 1)
    G, S, KV, group, Dh = 16, 128, 2, 2, 256
    lens = [0, 15, 70, S - T]
    B = len(lens)
    cache = _kivi_cache(g, cuda, tier, B, KV, S, Dh, G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    new_lengths = lengths + T
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, G)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=cuda) * 8
    _, attn = KIVI[tier]
    kw = dict(group=G, window=window, scale=scale, softcap=softcap)
    out = getattr(ops, attn)(q, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 6])
def test_mixed_attention_scale_vs_plain(cuda, T):
    g = torch.Generator(device=cuda).manual_seed(T + 3)
    S, KV, Dh = 96, 2, 128
    cache = _mixed_cache(g, cuda, 3, KV, S, Dh)
    lengths = torch.tensor([0, 41, S - T], dtype=torch.int32, device=cuda)
    q = torch.randn(3, T, 2 * KV, Dh, generator=g, device=cuda)
    out = ops.mixed_kv_attention(q, *cache, lengths, scale=0.1)
    ref = ops.mixed_kv_attention_ref(q, *cache, lengths, scale=0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


# -- the ring-position, StreamingLLM-sink and ALiBi variants (Mistral, BLOOM) ----


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("sinks,T", [(0, 1), (0, 7), (4, 1), (4, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_ring_positions_vs_plain(cuda, sinks, T, alibi, dtype):
    """A ring of 256 columns, window 128: rows never wrapped (columns never
    written), wrapped once and many times."""
    from protoquant_tpu_torch.models import ring_positions
    from protoquant_tpu_torch.models.llama import alibi_slopes

    g = torch.Generator(device=cuda).manual_seed(sinks * 10 + T)
    B, KV, group, C, Dh, W = 4, 2, 2, 256, 128, 128
    kq = torch.randint(-127, 128, (B, KV, C, Dh), generator=g, device=cuda, dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = torch.rand(B, KV, C, generator=g, device=cuda) * 1e-2 + 1e-3
    vs = torch.rand(B, KV, C, generator=g, device=cuda) * 1e-2 + 1e-3
    lengths = torch.tensor([0, 30, 300, 5000], dtype=torch.int32, device=cuda)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=cuda).to(dtype)
    kw = dict(window=W, k_positions=ring_positions(lengths + T, C, sinks), sinks=sinks)
    if alibi:
        kw["alibi_slopes"] = alibi_slopes(KV * group).to(cuda)
    out = ops.int8_kv_attention(q, kq, ks, vq, vs, lengths, **kw)
    ref = ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, **kw)
    torch.cuda.synchronize()
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,window,sinks,alibi", [
    (1, 0, 0, True), (5, 0, 0, True), (1, 40, 4, False), (9, 3, 4, True),
    (1, 50, 70, False), (6, 50, 70, True)])
def test_attention_sinks_and_alibi_vs_plain(cuda, T, window, sinks, alibi):
    """ALiBi full-causal and windowed; StreamingLLM sinks over a contiguous
    cache, which the kernel keeps visible while it skips the tiles below
    the window (70 sinks span two 64-key tiles)."""
    from protoquant_tpu_torch.models.llama import alibi_slopes

    g = torch.Generator(device=cuda).manual_seed(T + window + sinks)
    B, KV, group, S, Dh = 4, 2, 2, 320, 64
    kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=g, device=cuda, dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2 + 1e-3
    vs = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2 + 1e-3
    lengths = torch.tensor([0, 37, 200, S - T], dtype=torch.int32, device=cuda)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=cuda)
    kw = dict(window=window, sinks=sinks,
              alibi_slopes=alibi_slopes(KV * group).to(cuda) if alibi else None)
    out = ops.int8_kv_attention(q, kq, ks, vq, vs, lengths, **kw)
    ref = ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("group,ps,head_dim", [(1, 128, 64), (2, 16, 128), (4, 8, 64)])
def test_paged_attention_alibi_vs_plain(cuda, group, ps, head_dim):
    from protoquant_tpu_torch.models.llama import alibi_slopes

    g = torch.Generator(device=cuda).manual_seed(group * 13 + ps)
    B, KV, maxP = 4, 2, 6
    P = B * maxP + 2
    pools = _pools(g, cuda, P, KV, ps, head_dim)
    pt = _table(g, B, maxP, P).to(cuda)
    lengths = torch.tensor([ps - 1, 0, ps, maxP * ps - 1], dtype=torch.int32, device=cuda)
    q = torch.randn(B, 1, KV * group, head_dim, generator=g, device=cuda)
    slopes = alibi_slopes(KV * group).to(cuda)
    out = ops.paged_int8_attention(q, *pools, pt, lengths, alibi_slopes=slopes)
    ref = ops.paged_int8_attention_ref(q, *pools, pt, lengths, alibi_slopes=slopes)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,window", [(1, 0), (5, 0), (1, 40), (9, 3)])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_attention_alibi_vs_plain(cuda, tier, T, window):
    from protoquant_tpu_torch.models.llama import alibi_slopes

    g = torch.Generator(device=cuda).manual_seed(T + window + 5)
    G, S, KV, group, Dh = 16, 128, 2, 2, 64
    lens = [0, 15, 70, S - T]
    B = len(lens)
    cache = _kivi_cache(g, cuda, tier, B, KV, S, Dh, G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    new_lengths = lengths + T
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, G)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=cuda)
    _, attn = KIVI[tier]
    kw = dict(group=G, window=window, alibi_slopes=alibi_slopes(KV * group).to(cuda))
    out = getattr(ops, attn)(q, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_variant_wrappers_reject_what_the_kernels_do_not_take(cuda):
    B, KV, S, Dh = 1, 2, 64, 64
    q = torch.randn(B, 1, 4, Dh, device=cuda)
    kq = torch.zeros(B, KV, S, Dh, dtype=torch.int8, device=cuda)
    s = torch.ones(B, KV, S, device=cuda)
    lengths = torch.zeros(B, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k_positions"):
        ops.int8_kv_attention(q, kq, s, kq, s, lengths, window=8,
                              k_positions=torch.zeros(B, S, device=cuda))  # not int32
    with pytest.raises(ValueError, match="alibi_slopes"):
        ops.int8_kv_attention(q, kq, s, kq, s, lengths, alibi_slopes=torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="tensors on"):
        ops.int8_kv_attention(q, kq, s, kq, s, lengths, alibi_slopes=torch.ones(4))
    pools = (torch.zeros(3, KV, 8, Dh, dtype=torch.int8, device=cuda),
             torch.ones(3, KV, 1, 8, device=cuda))
    pt = torch.zeros(B, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="alibi_slopes"):
        ops.paged_int8_attention(q, *pools, *pools, pt, lengths,
                                 alibi_slopes=torch.ones(4, dtype=torch.float64, device=cuda))
    sl = torch.randn(4, device=cuda)
    with pytest.raises(ValueError, match="sink_logits"):
        ops.int8_kv_attention(q, kq, s, kq, s, lengths, sink_logits=sl[:2])
    with pytest.raises(TypeError, match="sink_logits"):
        ops.int8_kv_attention(q, kq, s, kq, s, lengths, sink_logits=sl.double())
    with pytest.raises(NotImplementedError):  # the JAX paged attention takes no sinks
        ops.paged_int8_attention(q, *pools, *pools, pt, lengths, sink_logits=sl)
    torch.testing.assert_close(  # learned sinks are ported: the kernel holds its plain version
        ops.int8_kv_attention(q, kq, s, kq, s, lengths, sink_logits=sl),
        ops.int8_kv_attention_ref(q, kq, s, kq, s, lengths, sink_logits=sl), atol=ATOL, rtol=0)


# -- learned sinks (GPT-OSS: group 8, Dh 64) ----------------------------------------

# (T, window): decode full causal and windowed across tiles, prefill chunks
# full causal and with disjoint windows
SINK_CASES = [(1, 0), (1, 40), (7, 0), (9, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,window", SINK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_learned_sinks_vs_plain(cuda, T, window, dtype):
    """Sinks drawn N(0, 4): some rows put most of their mass on the sink;
    a row of length 0 sees one key beside it."""
    g = torch.Generator(device=cuda).manual_seed(T + window + 11)
    B, KV, group, S, Dh = 4, 2, 8, 256, 64
    kq = torch.randint(-127, 128, (B, KV, S, Dh), generator=g, device=cuda, dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2 + 1e-3
    vs = torch.rand(B, KV, S, generator=g, device=cuda) * 1e-2 + 1e-3
    lengths = torch.tensor([0, 37, 130, S - T], dtype=torch.int32, device=cuda)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=cuda).to(dtype)
    sl = torch.randn(KV * group, generator=g, device=cuda) * 4
    kw = dict(window=window, sink_logits=sl)
    out = ops.int8_kv_attention(q, kq, ks, vq, vs, lengths, **kw)
    ref = ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, **kw)
    torch.cuda.synchronize()
    atol = ATOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    plain = ops.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, window=window)
    assert (plain.float() - ref.float()).abs().max() > 10 * atol  # the sinks bite


@pytest.mark.cuda
@pytest.mark.parametrize("T,window", SINK_CASES)
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_kivi_attention_learned_sinks_vs_plain(cuda, tier, T, window):
    g = torch.Generator(device=cuda).manual_seed(T + window + 13)
    G, S, KV, group, Dh = 16, 128, 2, 8, 64
    lens = [0, 15, 70, S - T]
    B = len(lens)
    cache = _kivi_cache(g, cuda, tier, B, KV, S, Dh, G)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    new_lengths = lengths + T
    if tier == "k4v8":
        _mirror_v(cache, new_lengths, G)
    q = torch.randn(B, T, KV * group, Dh, generator=g, device=cuda) * 0.2
    _, attn = KIVI[tier]
    kw = dict(group=G, window=window, sink_logits=torch.randn(KV * group, generator=g,
                                                               device=cuda) * 4)
    out = getattr(ops, attn)(q, *cache, lengths, new_lengths, **kw)
    ref = getattr(ops, attn + "_ref")(q, *cache, lengths, new_lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "k4v8", "int4"])
def test_tiny_gpt_oss_on_card(cuda, kv):
    """A 2-layer GPT-OSS (learned sinks, yarn, the gpt_oss MoE, window 8 on
    layer 0) served on the card, with the CPU model's weights: its logits
    equal the CPU model's within 2^-7 of their scale, the tier's attention
    and the qmatmul kernel launch, and at least 0.9 of the engine's greedy
    tokens equal the CPU engine's (the kernels sum in other orders, so an
    int8 activation code on a rounding boundary may move a step and a
    near-tied token with it, as in chip_smoke.py's agreements)."""
    from protoquant_tpu_torch import Engine, EngineConfig, LlamaModel, ModelConfig
    from protoquant_tpu_torch.models import kv_cache as tkv

    tkv.INT4_KV_GROUP, old_group = 16, tkv.INT4_KV_GROUP
    try:
        cfg = ModelConfig(
            vocab_size=96, hidden_size=128, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=16, num_key_value_heads=2, max_position_embeddings=256,
            head_dim_override=64, sliding_window=8, alternating_sliding_window=True,
            attention_bias=True, attention_out_bias=True, learned_attention_sinks=True,
            num_local_experts=8, num_experts_per_tok=2, moe_variant="gpt_oss",
            moe_router_bias=True, moe_softmax_after_topk=True, rope_scaling_type="yarn",
            rope_scaling_factor=32.0, rope_scaling_truncate=False,
            rope_scaling_original_max_position_embeddings=32)
        cpu = LlamaModel(cfg, "dynamic", torch.float32, device="cpu").init_random_(0)
        for layer in cpu.layers:
            layer.self_attn.sinks.copy_(torch.linspace(-2, 3, 16))
        card = LlamaModel(cfg, "dynamic", torch.float32, device=cuda)
        card.load_state_dict(cpu.state_dict())
        models = {"cpu": cpu, "cuda": card}
        tokens = torch.randint(1, 96, (2, 20), generator=torch.Generator().manual_seed(0))
        ref = models["cpu"](tokens)
        out = models["cuda"](tokens.to(cuda)).cpu()
        torch.testing.assert_close(out, ref, atol=2.0**-7 * ref.abs().max().item(), rtol=0)
        prompts = [[int(t) for t in tokens[0, :n]] for n in (5, 20, 13)]
        kw = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=16, max_new_tokens=8)
        outs = {}
        for dev, m in models.items():
            ops.reset_launch_counts()
            e = Engine(m, EngineConfig(**kw), kv_dtype=kv)
            rids = [e.add_request(p) for p in prompts]
            res = e.run()
            outs[dev] = [res[r] for r in rids]
        counts = ops.launch_counts()
        attn = {"int8": "int8_kv_attention", "k4v8": "k4v8_attention",
                "int4": "int4_kv_attention"}[kv]
        assert counts[attn] > 0 and counts["qmatmul"] > 0
        pairs = [(a, b) for o, r in zip(outs["cuda"], outs["cpu"]) for a, b in zip(o, r)]
        assert len(pairs) == 24 and sum(a == b for a, b in pairs) >= 0.9 * len(pairs)
    finally:
        tkv.INT4_KV_GROUP = old_group


def _ring_operands(g, dev, tp, M, K, N, real):
    ks = K // tp
    xq = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
    sx = (torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3 if real
          else torch.ones(M, device=dev))
    sw = (torch.rand(N, generator=g, device=dev) * 0.02 + 5e-4 if real
          else torch.ones(N, device=dev))
    return ([xq[:, r * ks:(r + 1) * ks].contiguous() for r in range(tp)], [sx] * tp,
            [wq[:, r * ks:(r + 1) * ks].contiguous() for r in range(tp)], [sw] * tp)


def _ring_splits(dev, tp, m, k, n):
    """Every K split (1 to 8 blocks a cluster) whose grid the card holds
    whole for these operands, each split at least one 64-byte step."""
    from protoquant_tpu_torch.ops import collective_matmul as C

    held = C.ring_held(dev, C.ring_fragments(m), tp)
    clusters = C.ring_tiles(n // tp) * tp
    steps = -(-(k // tp) // 64)
    return [s for s in range(1, 9) if (s == 1 or s <= steps) and clusters <= held[s]]


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 4096), (256, 11008, 4096), (3, 128, 192)])
def test_ring_reduce_scatter_exact(cuda, tp, real, m, k, n):
    from protoquant_tpu_torch.ops.collective_matmul import ring_route

    g = torch.Generator(device=cuda).manual_seed(tp * 7 + m)
    ops_in = _ring_operands(g, cuda, tp, m, k, n, real)
    ops.reset_launch_counts()
    got = ops.qmatmul_reduce_scatter_dma_all(*ops_in)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qmatmul_reduce_scatter_dma"] == 1
    assert ops.qmatmul_reduce_scatter_dma.routes == {
        "decode": int(ring_route(m) == "decode"), "prefill": int(ring_route(m) == "prefill")}
    want = ops.qmatmul_reduce_scatter_dma_all_ref(*ops_in)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 4096), (4, 11008, 4096), (256, 4096, 4096),
                                   (256, 11008, 4096), (3, 128, 192), (40, 128, 192),
                                   (5, 128, 36), (40, 128, 36)])
def test_ring_every_split_exact(cuda, tp, m, k, n):
    """Both routes at every K split the card holds, with unit and real
    scales: bit for bit the plain version (int32 sums are exact in any
    split), and the plan's split among them. N = 36 gives chunks of 18 and
    9 columns, whose partials move 4 bytes at a time."""
    from protoquant_tpu_torch.ops import collective_matmul as C

    g = torch.Generator(device=cuda).manual_seed(tp * 11 + m)
    splits = _ring_splits(cuda, tp, m, k, n)
    for real in (False, True):
        ops_in = _ring_operands(g, cuda, tp, m, k, n, real)
        assert C.ring_plan_of(ops_in[0], ops_in[2]) in splits
        want = ops.qmatmul_reduce_scatter_dma_all_ref(*ops_in)
        for s in splits:
            got = C.ring_launch(*ops_in, k_splits=s)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (real, s)


@pytest.mark.cuda
def test_ring_grid_the_card_cannot_hold_raises(cuda):
    """One cluster more than the card holds at once: the planned call
    raises before launch, a forced split is refused by CUDA (a
    cooperative launch), and the next call is served."""
    from protoquant_tpu_torch.ops import collective_matmul as C

    tp, m, k = 2, 1, 32
    tiles = C.ring_held(cuda, C.ring_fragments(m), tp)[1] // tp + 1
    n = tp * 64 * tiles
    g = torch.Generator(device=cuda).manual_seed(5)
    ops_in = _ring_operands(g, cuda, tp, m, k, n, True)
    assert C.ring_plan_of(ops_in[0], ops_in[2]) is None
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="cannot all be resident"):
        ops.qmatmul_reduce_scatter_dma_all(*ops_in)
    with pytest.raises(RuntimeError, match="pq_ring_qmatmul_rs"):
        C.ring_launch(*ops_in, k_splits=1)
    assert ops.launch_counts()["qmatmul_reduce_scatter_dma"] == 0
    ok = _ring_operands(g, cuda, tp, 4, 1024, 2048, True)
    got = ops.qmatmul_reduce_scatter_dma_all(*ok)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b)
               for a, b in zip(got, ops.qmatmul_reduce_scatter_dma_all_ref(*ok)))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 9, 17, 33])
def test_ring_launches_the_instance_it_is_given(cuda, m):
    """The C entry launches the instance the wrapper names (mf fragments
    of 8 tokens) and refuses a decode instance too small for M: every
    instance that holds M is exact, the prefill one at any M; the
    wrapper's count is that of the instance it passed."""
    from protoquant_tpu_torch.ops import collective_matmul as C

    tp, k, n = 2, 1024, 2048
    g = torch.Generator(device=cuda).manual_seed(m)
    ops_in = _ring_operands(g, cuda, tp, m, k, n, True)
    want = ops.qmatmul_reduce_scatter_dma_all_ref(*ops_in)
    for mf in (1, 2, 4, 8):
        if mf < 8 and m > 8 * mf:
            with pytest.raises(RuntimeError, match="pq_ring_qmatmul_rs"):
                C.ring_launch(*ops_in, mf=mf)
            continue
        got = C.ring_launch(*ops_in, mf=mf)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), mf
    ops.reset_launch_counts()
    ops.qmatmul_reduce_scatter_dma_all(*ops_in)
    route = C.fragments_route(C.ring_fragments(m))
    assert ops.qmatmul_reduce_scatter_dma.routes == {
        "decode": int(route == "decode"), "prefill": int(route == "prefill")}


@pytest.mark.cuda
def test_ring_back_to_back_mixed_tp_and_routes(cuda):
    """300 calls enqueued without a synchronize, tp 2 and 4 in turn, M
    from 1 to 256 (both routes), each exact and counted once on its route."""
    from protoquant_tpu_torch.ops.collective_matmul import ring_route

    g = torch.Generator(device=cuda).manual_seed(17)
    ms = torch.randint(1, 257, (300,), generator=torch.Generator().manual_seed(17)).tolist()
    cases = [_ring_operands(g, cuda, (2, 4)[i % 2], m, 1024, 2048, True)
             for i, m in enumerate(ms)]
    ops.reset_launch_counts()
    outs = [ops.qmatmul_reduce_scatter_dma_all(*c) for c in cases]
    torch.cuda.synchronize()
    for c, out in zip(cases, outs):
        assert all(torch.equal(a, b)
                   for a, b in zip(out, ops.qmatmul_reduce_scatter_dma_all_ref(*c)))
    routes = [ring_route(m) for m in ms]
    assert ops.qmatmul_reduce_scatter_dma.routes == {
        "decode": routes.count("decode"), "prefill": routes.count("prefill")}
    assert routes.count("decode") > 0 and routes.count("prefill") > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_ring_reduce_scatter_back_to_back(cuda, tp):
    """200 calls of M from 1 to 256, enqueued without a synchronize, each
    exact: no call reads a flag or a slot of another."""
    from protoquant_tpu_torch.parallel import make_mesh
    from protoquant_tpu_torch.utils import MeshConfig

    g = torch.Generator(device=cuda).manual_seed(tp)
    ms = torch.randint(1, 257, (200,), generator=torch.Generator().manual_seed(tp)).tolist()
    cases = [_ring_operands(g, cuda, tp, m, 1024, 2048, True) for m in ms]
    outs = [ops.qmatmul_reduce_scatter_dma_all(*c) for c in cases]
    torch.cuda.synchronize()
    for c, out in zip(cases, outs):
        assert all(torch.equal(a, b)
                   for a, b in zip(out, ops.qmatmul_reduce_scatter_dma_all_ref(*c)))
    # the per-rank call, ranks as threads sharing the card: one launch a call
    mesh = make_mesh(MeshConfig(tp=tp), [cuda] * tp)
    ops.reset_launch_counts()
    for c in cases[:20]:
        got = mesh.run(lambda r: ops.qmatmul_reduce_scatter_dma(
            c[0][r], c[1][r], c[2][r], c[3][r], mesh.group))
        want = ops.qmatmul_reduce_scatter_dma_all_ref(*c)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["qmatmul_reduce_scatter_dma"] == 20
