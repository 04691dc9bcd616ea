"""The ring reduce-scatter matmul's split-K order (``csrc/collective_matmul.cu``:
each ring step's product split over K between the blocks of a cluster,
their int32 partials summed, then the epilogue and the ring's adds) spelled
out in plain PyTorch, and the plan and routes the wrapper launches it by.

* ``qmatmul_reduce_scatter_dma_splitk_ref`` at 1, 3 and 8 splits, tp 2, 3
  and 4, M 1 to 256, over a rank's K of 10 steps of 64 bytes whose last is
  ragged (no split a whole number of steps) and chunks of 72 columns (not a
  multiple of the kernel's 64-column tiles): bit for bit equal to
  ``qmatmul_reduce_scatter_dma_all_ref`` with unit, power-of-two and real
  scales, and to the JAX package's Pallas ring in TPU interpret mode with
  unit and power-of-two scales. Those make every epilogue product exact, so
  the compiled JAX program's freedom to contract it into the ring's add
  (an FMA) cannot move a bit; real scales are held to the plain version
  alone, whose ring order ``test_torch_collective.py`` pins. A planted
  fault, one K slice dropped, fails.
* ``gemm_plan.ring_plan``: never more clusters than the card holds at once
  for the split it picks, None where not even one-block clusters fit, within
  its route's blocks-an-SM aim, and ``decode_plan``'s answer where that aim
  does not bind; the Llama-2-7B choices pinned at tp 2 and 4.
* The routes: M up to ``RING_DECODE_MAX_M`` on the decode route, one row more
  on the prefill route; the wrapper names the instance (``ring_fragments``)
  to the launcher and counts each call once on that instance's route (the
  launcher stubbed and the operands on the meta device, so no card is
  needed).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from protoquant_tpu_torch import ops
from protoquant_tpu_torch.ops.qmatmul import k_slices

from test_torch_collective import _jax_dma, _split_k, needs_8dev

C = importlib.import_module("protoquant_tpu_torch.ops.collective_matmul")
P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")

K_RANK = 64 * 9 + 48  # a rank's K: 10 steps, the last 48 bytes
NC = 72  # columns of a chunk
MS = (1, 37, 256)
# cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 (132 SMs) of a
# decode instance with 4 blocks an SM (the int4 decode kernels' table)
H100_HELD = {1: 528, 2: 264, 3: 163, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62}


SCALES = ("unit", "pow2", "real")


@functools.lru_cache(maxsize=None)
def _operands(tp, m, scales):
    """The JAX-layout operands (xq [M, K], sx, wq [K, N], sw), numpy."""
    rng = np.random.default_rng(100 * tp + m + 7 * SCALES.index(scales))
    k, n = K_RANK * tp, NC * tp
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    if scales == "real":
        sx = rng.uniform(0.001, 0.05, m).astype(np.float32)
        sw = rng.uniform(0.0005, 0.02, n).astype(np.float32)
    elif scales == "pow2":
        sx = np.exp2(-rng.integers(5, 10, m)).astype(np.float32)
        sw = np.exp2(-rng.integers(6, 12, n)).astype(np.float32)
    else:
        sx, sw = np.ones(m, np.float32), np.ones(n, np.float32)
    return xq, sx, wq, sw


def _ranks(tp, m, scales):
    """Every rank's operands for the port (lists in rank order)."""
    xq, sx, wq, sw = _operands(tp, m, scales)
    wq_nk = np.ascontiguousarray(wq.T)
    return ([_split_k(xq, tp, r) for r in range(tp)], [torch.from_numpy(sx)] * tp,
            [_split_k(wq_nk, tp, r) for r in range(tp)], [torch.from_numpy(sw)] * tp)


@functools.lru_cache(maxsize=None)
def _jax(tp, m, scales):
    return _jax_dma(*_operands(tp, m, scales), tp)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_k_slices_cover_a_ragged_rank_k(splits):
    """The kernel's K slices tile [0, K) in whole 64-byte steps, but the
    last, which ends at K (48 bytes past the last whole step)."""
    slices = k_slices(K_RANK, splits, C.DECODE_STEP)
    assert len(slices) == splits and slices[0][0] == 0 and slices[-1][1] == K_RANK
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(k0 % 64 == 0 and k1 > k0 for k0, k1 in slices)
    assert K_RANK % 64 and all((k1 - k0) % 64 == 0 for k0, k1 in slices[:-1])


@needs_8dev
@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("m", MS)
def test_splitk_ref_bitwise(tp, splits, m):
    for scales in SCALES:
        args = _ranks(tp, m, scales)
        got = C.qmatmul_reduce_scatter_dma_splitk_ref(*args, splits)
        want = C.qmatmul_reduce_scatter_dma_all_ref(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(g.shape == (m, NC) and g.dtype == torch.float32 for g in got)
        if scales != "real":
            np.testing.assert_array_equal(torch.cat(got, -1).numpy(), _jax(tp, m, scales))


@pytest.mark.parametrize("tp", [2, 4])
def test_splitk_ref_misses_a_dropped_slice(tp, monkeypatch):
    """A planted fault: the spelling with each rank's last K slice dropped
    differs from the plain version."""
    args = _ranks(tp, 37, "real")
    monkeypatch.setattr(C, "qmatmul_splitk_ref",
                        lambda xq, wq, sx, sw, k_splits, step: ops.qmatmul_ref(
                            xq[:, :k_slices(xq.shape[1], k_splits, step)[-1][0]],
                            wq[:, :k_slices(xq.shape[1], k_splits, step)[-1][0]], sx, sw))
    got = C.qmatmul_reduce_scatter_dma_splitk_ref(*args, 3)
    want = C.qmatmul_reduce_scatter_dma_all_ref(*args)
    assert not any(torch.equal(a, b) for a, b in zip(got, want))


def _held_cases():
    rng = np.random.default_rng(22)
    cases = [H100_HELD, {s: 0 for s in range(1, 9)}, {s: 1 for s in range(1, 9)}]
    for _ in range(40):
        held = {1: int(rng.integers(0, 1100))}
        for s in range(2, 9):
            held[s] = int(rng.integers(0, held[1] // s + 1))
        cases.append(held)
    return cases


@pytest.mark.parametrize("route", ["decode", "prefill"])
@pytest.mark.parametrize("sms", [8, 132])
def test_ring_plan_never_plans_past_the_held_clusters(sms, route):
    per_sm = P.RING_BLOCKS_PER_SM[route]
    for held in _held_cases():
        for clusters in (1, 7, 64, 128, 300, 600, 1100):
            for units in (1, 2, 3, 10, 43, 172):
                splits = P.ring_plan(clusters, units, held, sms, per_sm)
                if clusters > held[1]:
                    assert splits is None
                    continue
                assert 1 <= splits <= 8 and clusters <= held[splits]
                assert splits == 1 or (2 * splits <= units
                                       and clusters * splits <= per_sm * sms)


def test_ring_plan_is_decode_plan_where_its_aim_does_not_bind():
    """With SMs enough that eight blocks a cluster stay within the aim,
    the plan is decode_plan's: the most blocks whose clusters fit."""
    for held in _held_cases():
        for clusters in (1, 7, 64, 128, 300):
            if clusters > held[1]:
                continue
            sms = 8 * clusters  # one block an SM over 8 a cluster
            for units in (1, 3, 10, 43):
                for per_sm in P.RING_BLOCKS_PER_SM.values():
                    assert P.ring_plan(clusters, units, held, sms, per_sm) == P.decode_plan(
                        P.DECODE_ROWS * clusters, units, held)


@pytest.mark.parametrize("tp,k", [(2, 4096), (2, 11008), (4, 4096), (4, 11008)])
@pytest.mark.parametrize("route,splits", [("decode", 2), ("prefill", 4)])
def test_ring_plan_llama2_7b(tp, k, route, splits):
    """o_proj and down_proj (N 4096) of Llama-2-7B: 64 clusters at tp 2 and
    4, split 2 ways at decode (128 blocks on 132 SMs, twice the 64 blocks of
    one a tile) and 4 ways at prefill (256 blocks)."""
    clusters = C.ring_tiles(4096 // tp) * tp
    assert clusters == 64
    assert P.ring_plan(clusters, -(-(k // tp) // 64), H100_HELD, 132,
                       P.RING_BLOCKS_PER_SM[route]) == splits


def test_ring_routes_and_counts(monkeypatch):
    """Through the wrapper, the launcher stubbed (operands on the meta
    device): each call names the instance of its M to the launcher and
    counts one launch on that instance's route, M 0 none."""
    given = []

    def launch(xqs, sxs, wqs, sws, mf):
        given.append(mf)
        return [torch.empty(xqs[0].shape[0], wqs[0].shape[0] // len(xqs),
                            device="meta")] * len(xqs)

    monkeypatch.setattr(C, "ring_launch", launch)
    ops.reset_launch_counts()
    tp, k, n = 2, 64, 128

    def call(m):
        xqs = [torch.empty(m, k, dtype=torch.int8, device="meta")] * tp
        sxs = [torch.empty(m, device="meta")] * tp
        wqs = [torch.empty(n, k, dtype=torch.int8, device="meta")] * tp
        sws = [torch.empty(n, device="meta")] * tp
        before = dict(ops.qmatmul_reduce_scatter_dma.routes)
        outs = ops.qmatmul_reduce_scatter_dma_all(xqs, sxs, wqs, sws)
        assert len(outs) == tp and outs[0].shape == (m, n // tp)
        return {r: ops.qmatmul_reduce_scatter_dma.routes[r] - before[r] for r in before}

    assert C.RING_DECODE_MAX_M == 32
    for m, route, mf in ((1, "decode", 1), (4, "decode", 1), (32, "decode", 4),
                         (33, "prefill", 8), (256, "prefill", 8)):
        assert C.ring_route(m) == route
        got = call(m)
        assert given[-1] == mf
        assert got == {"decode": int(route == "decode"), "prefill": int(route == "prefill")}
    assert call(0) == {"decode": 0, "prefill": 0}
    assert ops.qmatmul_reduce_scatter_dma.launches == 5
    counts = ops.route_counts()
    assert counts["qmatmul_reduce_scatter_dma_decode"] == 3
    assert counts["qmatmul_reduce_scatter_dma_prefill"] == 2
    ops.reset_launch_counts()
    assert ops.qmatmul_reduce_scatter_dma.routes == {"decode": 0, "prefill": 0}


@pytest.mark.parametrize("m,mf", [(1, 1), (8, 1), (9, 2), (16, 2), (17, 4), (32, 4),
                                  (33, 8), (64, 8), (65, 8), (256, 8)])
def test_ring_fragments(m, mf):
    """The instance of M rows: the fewest fragments of 8 tokens that hold M
    on the decode route, the prefill instance's 8 above RING_DECODE_MAX_M;
    the route follows the instance."""
    assert C.ring_fragments(m) == mf
    assert 8 * mf >= m or mf == C.RING_PREFILL_MF
    assert C.ring_route(m) == C.fragments_route(mf)
    assert C.fragments_route(mf) == ("decode" if m <= C.RING_DECODE_MAX_M else "prefill")
