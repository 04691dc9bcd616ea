"""The int4-weight decode GEMMs (``csrc/w4a8_decode.cu``,
``csrc/w4a8_group_decode.cu``, ``csrc/wo4_decode.cu``) against their plain
versions, on the card. Every test here skips without one.

This file imports nothing of JAX:
``python -m pytest tests/test_torch_int4_decode_cuda.py --noconftest -q``.
W4A8 two_level: equal to ``w4a8_matmul_ref(..., "two_level")`` bit for bit
(the int32 sums are exact in any order and the epilogue runs once, on the
whole sum). W4A8 group: equal to ``w4a8_matmul_ref(..., "group")`` and to
its split-K spelling bit for bit (each split's exact int32 group sums, one
chain over all of them in order). The split body: within ``ops.weight_only_int4_tolerance`` of its
plain version (the same products, f32 sums in another order). Both at the
Llama-2-7B shapes, ragged N and K, every group, with and without a bias, f32
and bf16 out, at M 1, 4, 16 and the body's threshold, through the route the
wrapper names; every split count the kernel takes; two calls and a CUDA
graph replay bit for bit.
"""

import importlib

import pytest
import torch

from protoquant_tpu_torch import ops

W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")
A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")

# (K, N, group): Llama-2-7B's q/k/v/o, gate/up, down and lm_head at group
# 128; a ragged N and K at every group (96: three groups of 32 in one and a
# half steps; 320: five of 64; 11008: 86 of 128, split unevenly; 768: three
# of 256)
MODEL_SHAPES = [(4096, 4096, 128), (4096, 11008, 128), (11008, 4096, 128), (4096, 32000, 128)]
RAGGED_SHAPES = [(96, 130, 32), (320, 130, 64), (11008, 72, 128), (768, 130, 256),
                 (4096, 1000, 32), (4096, 1000, 64), (4096, 1000, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _weight(g, dev, n, k, group):
    """Random packed bytes (every code in [-8, 7]) and scales [N, K/group]."""
    packed = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand(n, k // group, generator=g, device=dev) * 1e-2 + 1e-4
    return packed, scales


def _two_level_case(cuda, m, k, n, group):
    g = torch.Generator(device=cuda).manual_seed(m * 31 + k + n)
    xq, sx = ops.rowquant(torch.randn(m, k, generator=g, device=cuda))
    packed, scales = _weight(g, cuda, n, k, group)
    return xq, sx, packed, scales, torch.randn(n, generator=g, device=cuda)


def _split_case(cuda, m, k, n, group):
    g = torch.Generator(device=cuda).manual_seed(m * 37 + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    packed, scales = _weight(g, cuda, n, k, group)
    return x, packed, scales, torch.randn(n, generator=g, device=cuda)


def _threshold(formulation):
    """The largest M the body's wrapper routes to its decode kernel."""
    return {"split": W.SPLIT_DECODE_MAX_M, "two_level": W.INT4_DECODE_MAX_M,
            "group": A.GROUP_DECODE_MAX_M}[formulation]


def _decode_ms(formulation):
    return tuple(sorted({1, 4, 16, _threshold(formulation)}))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,group", MODEL_SHAPES + RAGGED_SHAPES)
def test_two_level_decode_exact(cuda, k, n, group):
    for m in _decode_ms("two_level"):
        xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
        for out_dtype in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                ops.reset_launch_counts()
                y = ops.w4a8_matmul(xq, sx, packed, scales, group, b, out_dtype, "two_level")
                ref = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, b, out_dtype,
                                          "two_level")
                torch.cuda.synchronize()
                assert ops.w4a8_two_level.routes == {"decode": 1, "tile": 0}
                assert y.dtype == out_dtype and y.shape == (m, n)
                assert torch.equal(y, ref), (m, out_dtype, b is None)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,group", MODEL_SHAPES + RAGGED_SHAPES)
def test_group_decode_exact(cuda, k, n, group):
    """The group body through its decode route: the plain version's bits
    and its split-K spelling's at the plan's splits, codes -8 and 7 among
    the random bytes."""
    for m in _decode_ms("group"):
        xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
        splits = A.group_decode_plan(m, n, k, group, A.group_decode_held(cuda, m, k, group))
        for out_dtype in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                ops.reset_launch_counts()
                y = ops.w4a8_matmul(xq, sx, packed, scales, group, b, out_dtype, "group")
                ref = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, b, out_dtype, "group")
                spelled = ops.w4a8_group_splitk_ref(xq, sx, packed, scales, group, b, out_dtype,
                                                    splits)
                torch.cuda.synchronize()
                assert ops.w4a8_group.routes == {"decode": 1, "tile": 0}
                assert y.dtype == out_dtype and y.shape == (m, n)
                assert torch.equal(y, ref) and torch.equal(y, spelled), (m, out_dtype, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,group", MODEL_SHAPES + RAGGED_SHAPES)
def test_split_decode_within_tolerance(cuda, k, n, group):
    for m in _decode_ms("split"):
        x, packed, scales, bias = _split_case(cuda, m, k, n, group)
        for out_dtype in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                ops.reset_launch_counts()
                y = ops.weight_only_int4_matmul(x, packed, scales, group, b, out_dtype)
                ref = ops.weight_only_int4_matmul_ref(x, packed, scales, group, b, out_dtype)
                torch.cuda.synchronize()
                assert ops.wo4_split.routes == {"decode": 1, "tile": 0}
                assert y.dtype == out_dtype and y.shape == (m, n)
                tol = ops.weight_only_int4_tolerance(x, packed, scales, group, ref)
                assert ((y.float() - ref.float()).abs() <= tol).all(), (m, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", ["two_level", "split", "group"])
def test_routes_around_the_threshold(cuda, formulation):
    """M up to the body's threshold takes the decode kernel, one row more
    the tile kernel; both right."""
    k, n, group = 4096, 1000, 128
    for m in (_threshold(formulation), _threshold(formulation) + 1):
        ops.reset_launch_counts()
        if formulation != "split":
            xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
            y = ops.w4a8_matmul(xq, sx, packed, scales, group, bias, torch.bfloat16, formulation)
            assert torch.equal(y, ops.w4a8_matmul_ref(xq, sx, packed, scales, group, bias,
                                                      torch.bfloat16, formulation))
            routes = getattr(ops, f"w4a8_{formulation}").routes
        else:
            x, packed, scales, bias = _split_case(cuda, m, k, n, group)
            y = ops.weight_only_int4_matmul(x, packed, scales, group, bias)
            ref = ops.weight_only_int4_matmul_ref(x, packed, scales, group, bias)
            tol = ops.weight_only_int4_tolerance(x, packed, scales, group, ref)
            assert ((y.float() - ref.float()).abs() <= tol).all()
            routes = ops.wo4_split.routes
        route = "decode" if m <= _threshold(formulation) else "tile"
        assert routes == {"decode": int(route == "decode"), "tile": int(route == "tile")}


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [(1, 64, 8, 32), (4, 96, 130, 32), (5, 2880, 5760, 64),
                                         (8, 11008, 72, 128), (16, 4096, 4096, 256),
                                         (32, 4096 + 256, 200, 128)])
def test_decode_every_split(cuda, m, k, n, group):
    """The decode kernels at every cluster size the units of K allow (1 to
    8): two_level and group give the plain version's bits at each, split
    lies within the tolerance and equals its own spelling's sums within it;
    a split count the kernels do not take raises."""
    xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
    r16, scol = ops.two_level_scales(scales)
    want = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, bias, torch.float32, "two_level")
    want_group = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, bias, torch.float32)
    x, xp, xs, xb = _split_case(cuda, m, k, n, group)
    ref = ops.weight_only_int4_matmul_ref(x, xp, xs, group, xb, torch.float32)
    tol = ops.weight_only_int4_tolerance(x, xp, xs, group, ref)
    units, _ = W.int4_decode_units(k, group)
    for splits in range(1, 9):
        if splits > units:
            with pytest.raises(RuntimeError, match="pq_w4a8_two_level_decode"):
                A.w4a8_two_level_launch(xq, sx, packed, r16, scol, group, bias,
                                        torch.float32, splits)
            with pytest.raises(RuntimeError, match="pq_wo4_split_decode"):
                W.wo4_split_launch(x, xp, xs, group, xb, torch.float32, splits)
            with pytest.raises(RuntimeError, match="pq_w4a8_group_decode"):
                A.w4a8_group_launch(xq, sx, packed, scales, group, bias, torch.float32, splits)
            continue
        if A.group_decode_smem(m, k, group, splits) > A.GROUP_DECODE_SMEM:
            with pytest.raises(RuntimeError, match="pq_w4a8_group_decode"):
                A.w4a8_group_launch(xq, sx, packed, scales, group, bias, torch.float32, splits)
        else:
            yg = A.w4a8_group_launch(xq, sx, packed, scales, group, bias, torch.float32, splits)
            torch.cuda.synchronize()
            assert torch.equal(yg, want_group), splits
        y = A.w4a8_two_level_launch(xq, sx, packed, r16, scol, group, bias, torch.float32, splits)
        z = W.wo4_split_launch(x, xp, xs, group, xb, torch.float32, splits)
        spelled = ops.wo4_split_splitk_ref(x, xp, xs, group, xb, torch.float32, splits)
        torch.cuda.synchronize()
        assert torch.equal(y, want), splits
        assert ((z - ref).abs() <= tol).all(), splits
        assert ((z - spelled).abs() <= tol).all(), splits
    for splits in (0, 9):
        with pytest.raises(RuntimeError, match="pq_w4a8_two_level_decode"):
            A.w4a8_two_level_launch(xq, sx, packed, r16, scol, group, bias, torch.float32,
                                    splits)
        with pytest.raises(RuntimeError, match="pq_w4a8_group_decode"):
            A.w4a8_group_launch(xq, sx, packed, scales, group, bias, torch.float32, splits)


@pytest.mark.cuda
def test_decode_bitwise_and_cuda_graph(cuda):
    """Two calls give the same bits, and a call captured in a CUDA graph
    and replayed gives the eager call's bits (nothing kept between calls),
    for the three bodies, through the decode route."""
    m, k, n, group = 4, 4096, 11008, 128
    xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
    tl = ops.two_level_scales(scales)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    calls = (lambda: ops.w4a8_matmul(xq, sx, packed, scales, group, bias, torch.bfloat16,
                                     "two_level", tl),
             lambda: ops.w4a8_matmul(xq, sx, packed, scales, group, bias, torch.bfloat16),
             lambda: ops.weight_only_int4_matmul(x, packed, scales, group, bias))
    for call in calls:
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
        counts = ops.route_counts()
        assert (counts["w4a8_two_level_decode"] + counts["w4a8_group_decode"]
                + counts["wo4_split_decode"]) == 1


@pytest.mark.cuda
def test_decode_cluster_occupancy(cuda):
    """The library answers how many clusters of each size the card holds
    at once (cudaOccupancyMaxActiveClusters), never more than a wave of
    blocks, and the wrappers' plan launches one wave at the 7B shapes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for entry in ("pq_w4a8_two_level_decode", "pq_wo4_split_decode"):
        for m in (1, 4, 16, 32):
            held = W.int4_decode_held(entry, cuda, m, 128)
            assert all(1 <= held[s] and s * held[s] <= 8 * sms for s in held), held
            for k, n, group in MODEL_SHAPES:
                splits = W.int4_decode_plan(m, n, k, group, held)
                assert splits == 1 or -(-n // P.DECODE_ROWS) <= held[splits]


@pytest.mark.cuda
def test_group_decode_shared_memory_budget(cuda):
    """The group kernel's cluster query counts its group sums: a split
    count holds no cluster exactly where the sums pass the budget or the
    count passes the units of K, and one launched there raises; the plan
    picks a split whose sums fit, at a K too long for one split."""
    for m, k in ((4, 4096), (16, 11008), (32, 11008), (32, 32768)):
        held = A.group_decode_held(cuda, m, k, 128)
        units, _ = W.int4_decode_units(k, 128)
        for splits, clusters in held.items():
            fits = splits <= units and A.group_decode_smem(m, k, 128, splits) <= A.GROUP_DECODE_SMEM
            assert (clusters > 0) == fits, (m, k, splits, clusters)
        splits = A.group_decode_plan(m, 4096, k, 128, held)
        assert splits is None or A.group_decode_smem(m, k, 128, splits) <= A.GROUP_DECODE_SMEM
    xq, sx, packed, scales, bias = _two_level_case(cuda, 32, 11008, 64, 128)
    with pytest.raises(RuntimeError, match="pq_w4a8_group_decode"):
        A.w4a8_group_launch(xq, sx, packed, scales, 128, bias, torch.float32, 1)
    y = A.w4a8_group_launch(xq, sx, packed, scales, 128, bias, torch.float32, 8)
    torch.cuda.synchronize()
    assert torch.equal(y, ops.w4a8_matmul_ref(xq, sx, packed, scales, 128, bias, torch.float32))
