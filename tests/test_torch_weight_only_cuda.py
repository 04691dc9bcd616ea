"""The weight-only int8 GEMM's kernels (``csrc/wo_decode.cu``, ``csrc/wo_tile.cu``)
against their plain version, on the card. Every test here skips without one.

This file imports nothing of JAX:
``python -m pytest tests/test_torch_weight_only_cuda.py --noconftest -q``.
Every product of a bf16 and an int8 code is exact in f32, so a kernel lies
within ``ops.weight_only_tolerance`` of the plain version (an f32 sum in
another order, then one ulp of the output type). At the Llama-2-7B shapes
and a ragged N and K, f32 and bf16 out, with and without a bias: M 1, 4 and
the threshold through the decode route, one row more and 48, 256, 512
through the tile route, as the wrapper names them; the decode kernel at
every split count and the tile kernel at every plan it takes; two calls
and a CUDA graph replay bit for bit.
"""

import importlib

import pytest
import torch

from protoquant_tpu_torch import ops

W = importlib.import_module("protoquant_tpu_torch.ops.wo_matmul")

# (K, N): Llama-2-7B's q/k/v/o, gate/up, down and lm_head; a ragged N and a K
# of 1.25 steps; K of 64.25 steps (4112) and a ragged N
MODEL_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
RAGGED_SHAPES = [(80, 130), (4112, 200), (208, 72)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _case(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * 31 + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    wq = torch.randint(-128, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sw = torch.rand(n, generator=g, device=cuda) * 1e-2 + 1e-4
    return x, wq, sw, torch.randn(n, generator=g, device=cuda)


def _within(y, ref, x, wq, sw):
    tol = ops.weight_only_tolerance(x, wq, sw, ref)
    assert ((y.float() - ref.float()).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MODEL_SHAPES + RAGGED_SHAPES)
def test_routes_within_tolerance(cuda, k, n):
    """Through the wrapper, by M: the route it names, within the tolerance
    of the plain version."""
    t = W.WO_DECODE_MAX_M
    for m in sorted({1, 4, t, t + 1, 48, 256, 512}):
        x, wq, sw, bias = _case(cuda, m, k, n)
        for out_dtype in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                ops.reset_launch_counts()
                y = ops.weight_only_matmul(x, wq, sw, b, out_dtype)
                ref = ops.weight_only_matmul_ref(x, wq, sw, b, out_dtype)
                torch.cuda.synchronize()
                decode = m <= t
                assert ops.weight_only_matmul.routes == {"decode": int(decode),
                                                         "tile": int(not decode)}
                assert y.dtype == out_dtype and y.shape == (m, n)
                _within(y, ref, x, wq, sw)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (4, 80, 130), (8, 11008, 72), (16, 4096, 4096),
                                   (32, 4112, 200)])
def test_decode_every_split(cuda, m, k, n):
    """The decode kernel at every cluster size the steps of K allow (1 to
    8), within the tolerance; a split count it does not take raises."""
    x, wq, sw, bias = _case(cuda, m, k, n)
    ref = ops.weight_only_matmul_ref(x, wq, sw, bias, torch.float32)
    steps = -(-k // W.WO_DECODE_STEP)
    for splits in range(1, 9):
        if splits > steps:
            with pytest.raises(RuntimeError, match="pq_weight_only_decode"):
                W.weight_only_launch(x, wq, sw, bias, torch.float32, splits)
            continue
        y = W.weight_only_launch(x, wq, sw, bias, torch.float32, splits)
        torch.cuda.synchronize()
        _within(y, ref, x, wq, sw)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(17, 80, 130), (48, 4096, 11008), (100, 4112, 200),
                                   (256, 11008, 4096), (300, 208, 72), (512, 4096, 4096)])
def test_tile_every_plan(cuda, m, k, n):
    """The tile kernel at every (tokens a tile, K splits) it takes, within
    the tolerance; a split count past the stages of K raises."""
    x, wq, sw, bias = _case(cuda, m, k, n)
    ref = ops.weight_only_matmul_ref(x, wq, sw, bias, torch.bfloat16)
    stages = -(-k // W.WO_TILE_STEP)
    for tokens in (64, 128, 256):
        for splits in (1, 2, 3, 4, 6, 8):
            if splits > stages:
                with pytest.raises(RuntimeError, match="pq_weight_only_tile"):
                    W.weight_only_launch(x, wq, sw, bias, torch.bfloat16, tile=(tokens, splits))
                continue
            y = W.weight_only_launch(x, wq, sw, bias, torch.bfloat16, tile=(tokens, splits))
            torch.cuda.synchronize()
            _within(y, ref, x, wq, sw)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 256])
def test_bitwise_and_cuda_graph(cuda, m):
    """Two calls give the same bits, and so does a replay of the call
    captured in a CUDA graph (one launch, no workspace)."""
    x, wq, sw, bias = _case(cuda, m, 4096, 11008)
    first = ops.weight_only_matmul(x, wq, sw, bias, torch.bfloat16)
    assert torch.equal(first, ops.weight_only_matmul(x, wq, sw, bias, torch.bfloat16))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.weight_only_matmul(x, wq, sw, bias, torch.bfloat16)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
