"""The int4-weight tile GEMMs (``csrc/w4a8_tile.cu``, ``csrc/w4a8_group_tile.cu``,
``csrc/wo4_tile.cu`` on ``csrc/int4_tile_sm90.cuh``) against their plain
versions, on the card.
Every test here skips without one.

This file imports nothing of JAX:
``python -m pytest tests/test_torch_int4_tile_cuda.py --noconftest -q``.
W4A8 two_level: equal to ``w4a8_matmul_ref(..., "two_level")`` bit for bit
(the int32 sums are exact in any order and the epilogue runs once, on the
whole sum). W4A8 group: equal to ``w4a8_matmul_ref(..., "group")`` and to
its tile spelling bit for bit (one K split, the chain over the groups in
order). The split body: within ``ops.weight_only_int4_tolerance`` of its
plain version (the same products, f32 sums in another order). Both at M 33,
48, 64, 80, 256, 257 and 512 through the route the wrapper names, every
group, ragged N and K, with and without a bias, f32, bf16 and f16 out; every
tile and split count the kernels take; two calls and a CUDA graph
replay bit for bit.
"""

import importlib

import pytest
import torch

from protoquant_tpu_torch import ops

W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")

TILE_MS = (33, 48, 64, 80, 256, 257, 512)
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# (K, N, group): Llama-2-7B's q/k/v/o at group 128; ragged N and K at every
# group (96: three groups of 32 in one and a half stages; 320: five of 64;
# 768: three of 256; 11008: 86 of 128, split unevenly)
SHAPES = [(4096, 4096, 128), (96, 130, 32), (320, 130, 64), (768, 130, 256),
          (11008, 200, 128), (4096, 1000, 32), (4096, 1000, 64), (4096, 1000, 256)]


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
    g = torch.Generator(device=cuda).manual_seed(m * 41 + k + n)
    xq, sx = ops.rowquant(torch.randn(m, k, generator=g, device=cuda))
    packed, scales = _weight(g, cuda, n, k, group)
    return xq, sx, packed, scales, torch.randn(n, generator=g, device=cuda)


def _split_case(cuda, m, k, n, group):
    g = torch.Generator(device=cuda).manual_seed(m * 43 + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    packed, scales = _weight(g, cuda, n, k, group)
    return x, packed, scales, torch.randn(n, generator=g, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,group", SHAPES)
def test_two_level_tile_exact(cuda, k, n, group):
    for m in TILE_MS:
        xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
        for out_dtype in OUT_DTYPES:
            for b in (None, bias):
                ops.reset_launch_counts()
                y = ops.w4a8_matmul(xq, sx, packed, scales, group, b, out_dtype, "two_level")
                ref = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, b, out_dtype,
                                          "two_level")
                torch.cuda.synchronize()
                assert ops.w4a8_two_level.routes == {"decode": 0, "tile": 1}
                assert y.dtype == out_dtype and y.shape == (m, n)
                assert torch.equal(y, ref), (m, out_dtype, b is None)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,group", SHAPES)
def test_group_tile_exact(cuda, k, n, group):
    for m in TILE_MS:
        xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
        for out_dtype in OUT_DTYPES:
            for b in (None, bias):
                ops.reset_launch_counts()
                y = ops.w4a8_matmul(xq, sx, packed, scales, group, b, out_dtype, "group")
                ref = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, b, out_dtype, "group")
                torch.cuda.synchronize()
                assert ops.w4a8_group.routes == {"decode": 0, "tile": 1}
                assert y.dtype == out_dtype and y.shape == (m, n)
                assert torch.equal(y, ref), (m, out_dtype, b is None)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,group", SHAPES)
def test_split_tile_within_tolerance(cuda, k, n, group):
    for m in TILE_MS:
        x, packed, scales, bias = _split_case(cuda, m, k, n, group)
        for out_dtype in OUT_DTYPES:
            for b in (None, bias):
                ops.reset_launch_counts()
                y = ops.weight_only_int4_matmul(x, packed, scales, group, b, out_dtype)
                ref = ops.weight_only_int4_matmul_ref(x, packed, scales, group, b, out_dtype)
                torch.cuda.synchronize()
                assert ops.wo4_split.routes == {"decode": 0, "tile": 1}
                assert y.dtype == out_dtype and y.shape == (m, n)
                tol = ops.weight_only_int4_tolerance(x, packed, scales, group, ref)
                assert ((y.float() - ref.float()).abs() <= tol).all(), (m, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [(33, 96, 130, 32), (80, 4096, 300, 64),
                                         (257, 2048, 256, 128), (100, 4096 + 512, 130, 256),
                                         (512, 11008, 128, 128)])
def test_tile_every_plan(cuda, m, k, n, group):
    """Every tile and split count the kernels take, at small M too (the
    tile kernel takes any M): two_level and group the plain version's bits
    (group its spelling's too, at its one split), split within the
    tolerance of the plain version and of its own spelling; a plan the
    kernels do not take raises."""
    xq, sx, packed, scales, bias = _two_level_case(cuda, m, k, n, group)
    r16, scol = ops.two_level_scales(scales)
    want = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, bias, torch.float32, "two_level")
    want_group = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, bias, torch.float32)
    for tokens in (64, 128, 256):
        for splits in (1, 2, 4):
            plan = (tokens, splits)
            if tokens not in W.INT4_TILE_TOKENS["group"] or splits != 1:
                with pytest.raises(RuntimeError, match="pq_w4a8_group_tile"):
                    A.w4a8_group_launch(xq, sx, packed, scales, group, bias, torch.float32,
                                        tile=plan)
                continue
            y = A.w4a8_group_launch(xq, sx, packed, scales, group, bias, torch.float32, tile=plan)
            spelled = A.w4a8_group_tile_ref(xq, sx, packed, scales, group, bias, torch.float32,
                                            plan)
            torch.cuda.synchronize()
            assert torch.equal(y, want_group) and torch.equal(spelled, want_group), plan
    x, xp, xs, xb = _split_case(cuda, m, k, n, group)
    ref = ops.weight_only_int4_matmul_ref(x, xp, xs, group, xb, torch.float32)
    tol = ops.weight_only_int4_tolerance(x, xp, xs, group, ref)
    units, _ = W.int4_decode_units(k, group)
    for tokens in W.INT4_TILE_TOKENS["two_level"]:
        for splits in (1, 2, 3, 4, 8):
            plan = (tokens, splits)
            if splits > units:
                with pytest.raises(RuntimeError, match="pq_w4a8_two_level"):
                    A.w4a8_two_level_launch(xq, sx, packed, r16, scol, group, bias,
                                            torch.float32, tile=plan)
                continue
            y = A.w4a8_two_level_launch(xq, sx, packed, r16, scol, group, bias, torch.float32,
                                        tile=plan)
            spelled = A.w4a8_two_level_tile_ref(xq, sx, packed, r16, scol, group, bias,
                                                torch.float32, plan)
            torch.cuda.synchronize()
            assert torch.equal(y, want) and torch.equal(spelled, want), plan
            if tokens not in W.INT4_TILE_TOKENS["split"]:
                with pytest.raises(RuntimeError, match="pq_wo4_split"):
                    W.wo4_split_launch(x, xp, xs, group, xb, torch.float32, tile=plan)
                continue
            z = W.wo4_split_launch(x, xp, xs, group, xb, torch.float32, tile=plan)
            spelled = ops.wo4_split_tile_ref(x, xp, xs, group, xb, torch.float32, plan)
            torch.cuda.synchronize()
            assert ((z - ref).abs() <= tol).all(), plan
            assert ((z - spelled).abs() <= tol).all(), plan
    for tile in ((64, 9), (96, 1), (64, 0)):
        with pytest.raises(RuntimeError, match="pq_w4a8_two_level"):
            A.w4a8_two_level_launch(xq, sx, packed, r16, scol, group, bias, torch.float32,
                                    tile=tile)


@pytest.mark.cuda
def test_tile_bitwise_and_cuda_graph(cuda):
    """Two calls give the same bits, and a call captured in a CUDA graph
    and replayed gives the eager call's bits (nothing kept between calls),
    for the three bodies, through the tile route at a split plan and an
    unsplit one."""
    k, n, group = 4096, 11008, 128
    for m in (48, 256):
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
            assert (counts["w4a8_two_level_tile"] + counts["w4a8_group_tile"]
                    + counts["wo4_split_tile"]) == 1
