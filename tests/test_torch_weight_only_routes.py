"""The weight-only int8 GEMM's two kernels (``csrc/wo_decode.cu``, the
split-K decode kernel; ``csrc/wo_tile.cu`` on ``csrc/int4_tile_sm90.cuh``,
the TMA + wgmma tile kernel) spelled out in plain PyTorch, and the plans and
routes the wrapper launches them by, against the plain version and the JAX
package.

* The plans: the decode kernel's K slices tile [0, K) in 64-code steps;
  the tile kernel's blocks cover every output once, their K slices running
  from 0 to K in whole stages; the choices at the Llama-2-7B shapes are
  pinned (decode: by the clusters an H100 holds; tile: on 132 SMs).
* The routes: M up to ``WO_DECODE_MAX_M`` takes the decode kernel, one row
  more the tile kernel, at the threshold as set and monkeypatched (the
  launcher stubbed and the operands on the meta device, so no card is
  needed); each route counted.
* ``weight_only_splitk_ref`` (each K slice's f32 sum, the slices added in
  split order) and ``weight_only_tile_ref`` (each block's slice, a tile's
  slices added in order) lie within ``weight_only_tolerance`` of
  ``weight_only_matmul_ref`` and of the JAX Pallas kernel in interpret mode,
  at every split and plan, f32 and bf16 out, with and without a bias.
* A planted fault, the last K slice dropped, fails both.
Operands are random arrays made with numpy from a seed. Every product of a
bf16 and an int8 code is exact in f32, so two correct versions differ only
in the order of the f32 sum (``ops.weight_only_tolerance``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.ops.wo_matmul import weight_only_matmul as j_wo
from protoquant_tpu_torch import ops

W = importlib.import_module("protoquant_tpu_torch.ops.wo_matmul")
P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")
Q = importlib.import_module("protoquant_tpu_torch.ops.qmatmul")

# (M, K, N): one token over 8 steps; 4 over 4; 13 over 1.25 steps and a
# ragged N; 48 (a prefill chunk) over 6 steps and N past a 128-row tile
CASES = [(1, 512, 48), (4, 256, 128), (13, 80, 130), (48, 384, 200)]
SPLITS = tuple(range(1, 9))
TOKENS = (64, 128, 256)
TILE_SPLITS = (1, 2, 3, 4, 6, 8)
# cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 (132 SMs) of a
# decode instance with 4 blocks an SM (the int4 decode kernels' table)
H100_HELD = {1: 528, 2: 264, 3: 163, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62}


def _operands(m, k, n, seed, bias):
    """x [M, K] f32, the JAX-layout int8 weight [K, N], scales [N], bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    sw = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return x, wq, sw, b


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _within(got, want, x, wq, sw):
    tol = ops.weight_only_tolerance(x, wq, sw, got)
    diff = (got.float() - torch.from_numpy(np.array(want, np.float32))).abs()
    assert (diff <= tol).all(), float((diff - tol).max())


def _tile_plans(k):
    stages = -(-k // W.WO_TILE_STEP)
    return [(tokens, s) for tokens in TOKENS for s in TILE_SPLITS if s <= stages]


# -- the plans -------------------------------------------------------------------


@pytest.mark.parametrize("k", [16, 80, 512, 4096, 4112, 11008])
def test_decode_k_slices_cover_k_in_steps(k):
    """The decode kernel's K slices: in order from 0 to K, each starting
    on a 64-code step."""
    steps = -(-k // W.WO_DECODE_STEP)
    for splits in SPLITS:
        if splits > steps:
            continue
        ks = Q.k_slices(k, splits, W.WO_DECODE_STEP)
        assert len(ks) == splits and ks[0][0] == 0 and ks[-1][1] == k
        assert all(a[1] == b[0] and a[0] % W.WO_DECODE_STEP == 0 for a, b in zip(ks, ks[1:]))


@pytest.mark.parametrize("m,k,n", CASES + [(300, 4112, 300), (512, 11008, 130)])
def test_tile_blocks_cover_every_output_once(m, k, n):
    """A tile launch's blocks: 128 weight rows by a token tile, each split
    over K; every (token, row) pair in the blocks of one tile, whose K
    slices run from 0 to K in order in whole stages."""
    for plan in _tile_plans(k):
        tokens, splits = plan
        covered = np.zeros((m, n), np.int32)
        slices = {}
        for (m0, m1), (n0, n1), (k0, k1) in W.wo_tile_blocks(m, n, k, plan):
            assert m0 % tokens == 0 and m1 - m0 <= tokens
            assert n0 % 128 == 0 and n1 - n0 <= 128
            assert k0 % W.WO_TILE_STEP == 0 and k0 < k1 <= k
            slices.setdefault((m0, n0), []).append((k0, k1))
            if k0 == 0:
                covered[m0:m1, n0:n1] += 1
        assert (covered == 1).all()
        for ks in slices.values():
            assert len(ks) == splits and ks[0][0] == 0 and ks[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))


def test_decode_plan_by_shape():
    """The decode kernel's splits at the Llama-2-7B shapes: the most blocks
    whose clusters the card holds at once, at most 8, each split at least
    two steps; None past WO_DECODE_MAX_M."""
    plan = W.wo_decode_plan
    for m in (1, 4):
        assert plan(m, 4096, 4096, H100_HELD) == 7  # 64 tiles: 448 blocks
        assert plan(m, 11008, 4096, H100_HELD) == 2  # 172 tiles: 3 of 163 would not fit
        assert plan(m, 4096, 11008, H100_HELD) == 7  # down: 64 tiles, 172 steps
        assert plan(m, 32000, 4096, H100_HELD) == 1  # lm_head: 500 tiles of 528
    assert plan(4, 96, 128, H100_HELD) == 1  # two steps: one split of two
    assert plan(4, 96, 256, H100_HELD) == 2
    assert plan(W.WO_DECODE_MAX_M, 4096, 4096, H100_HELD) == 7
    assert plan(W.WO_DECODE_MAX_M + 1, 4096, 4096, H100_HELD) is None
    assert plan(256, 11008, 4096, H100_HELD) is None
    for n in (8, 96, 1024, 4096, 11008, 32000):
        for k in (16, 80, 2880, 4096, 11008):
            s = plan(4, n, k, H100_HELD)
            steps, tiles = -(-k // W.WO_DECODE_STEP), -(-n // P.DECODE_ROWS)
            assert 1 <= s <= 8 and (s == 1 or steps // s >= 2)
            assert s == 1 or tiles <= H100_HELD[s]


def test_tile_plan_by_shape():
    """The tile kernel's plans at the Llama-2-7B shapes on an H100 (132
    SMs), by M: (tokens a tile, K splits), the plan sweep's best in PERF.md
    at each but down at M 256 (4.5 % over it); every plan a tile the kernel
    takes and splits that keep their stages."""
    plan = W.wo_tile_plan
    want = {  # (K, N): {M: plan}
        (4096, 4096): {48: (64, 3), 256: (128, 2), 512: (256, 2)},
        (4096, 11008): {48: (64, 1), 256: (256, 1), 512: (256, 2)},
        (11008, 4096): {48: (64, 3), 256: (128, 2), 512: (256, 2)},
        (4096, 32000): {48: (64, 1), 256: (256, 1), 512: (256, 1)}}
    for (k, n), by_m in want.items():
        for m, p in by_m.items():
            assert plan(m, n, k, 132) == p, (k, n, m)
    for m in (17, 33, 64, 100, 256, 1000):
        for n in (8, 130, 4096, 32000):
            for k in (16, 80, 4096, 11008):
                tokens, s = plan(m, n, k, 132)
                stages = -(-k // W.WO_TILE_STEP)
                assert tokens in TOKENS
                assert s == 1 or (s in TILE_SPLITS and stages >= s * W.WO_TILE_MIN_STAGES)


@pytest.mark.parametrize("max_m", [None, 8, 32])
def test_routes_flip_at_the_threshold(monkeypatch, max_m):
    """Through the wrapper, with the launcher stubbed (operands on the meta
    device): M up to WO_DECODE_MAX_M (as set, and monkeypatched to 8 and
    32) takes the decode kernel at the decode plan's splits, one row more
    the tile kernel at the tile plan; the route counters count each, and
    batched leading dims count their rows."""
    if max_m is not None:
        monkeypatch.setattr(W, "WO_DECODE_MAX_M", max_m)
    calls = []

    def launch(x, wq, s_w, bias=None, out_dtype=None, k_splits=None, tile=None):
        calls.append(k_splits)
        return torch.empty(*x.shape[:-1], wq.shape[0], device="meta")

    monkeypatch.setattr(W, "wo_decode_held", lambda dev, m: H100_HELD)
    monkeypatch.setattr(W, "weight_only_launch", launch)
    threshold = W.WO_DECODE_MAX_M
    k, n = 4096, 11008
    wq = torch.empty(n, k, dtype=torch.int8, device="meta")
    sw = torch.empty(n, device="meta")
    for m in sorted({1, threshold, threshold + 1, 256}):
        for shape in ((m, k), (1, m, k)):
            ops.reset_launch_counts()
            calls.clear()
            y = ops.weight_only_matmul(torch.empty(*shape, dtype=torch.bfloat16, device="meta"),
                                       wq, sw)
            assert y.shape == (*shape[:-1], n)
            decode = m <= threshold
            assert calls == [W.wo_decode_plan(m, n, k, H100_HELD) if decode else None]
            assert ops.weight_only_matmul.routes == {"decode": int(decode), "tile": int(not decode)}
            assert ops.route_counts()["weight_only_matmul_decode"] == int(decode)
            assert ops.launch_counts()["weight_only_matmul"] == 1


# -- the spellings ---------------------------------------------------------------


def _pallas(x, wq, sw, b, out):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out]
    y = j_wo(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(sw),
             None if b is None else jnp.asarray(b), out_dtype=jdt, interpret=True)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", CASES)
def test_splitk_ref_within_tolerance(m, k, n, with_bias, out):
    """At every split the kernel takes: the decode kernel's sum order lies
    within weight_only_tolerance of the plain version and of the JAX Pallas
    kernel in interpret mode."""
    x, wq, sw, b = _operands(m, k, n, m + 3 * n, with_bias)
    xt, wt, st, bt = _t(x).to(torch.bfloat16), _t(wq.T), _t(sw), _t(b)
    plain = ops.weight_only_matmul_ref(xt, wt, st, bt, out)
    want = _pallas(x, wq, sw, b, out)
    steps = -(-k // W.WO_DECODE_STEP)
    for splits in SPLITS:
        if splits > steps:
            continue
        got = ops.weight_only_splitk_ref(xt, wt, st, bt, out, splits)
        assert got.dtype == out and got.shape == (m, n)
        _within(got, plain.float().numpy(), xt, wt, st)
        _within(got, want, xt, wt, st)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", CASES)
def test_tile_ref_within_tolerance(m, k, n, with_bias, out):
    """At every plan: the tile kernel's sum order lies within
    weight_only_tolerance of the plain version and of the JAX Pallas kernel
    in interpret mode."""
    x, wq, sw, b = _operands(m, k, n, 7 * m + n, with_bias)
    xt, wt, st, bt = _t(x).to(torch.bfloat16), _t(wq.T), _t(sw), _t(b)
    plain = ops.weight_only_matmul_ref(xt, wt, st, bt, out)
    want = _pallas(x, wq, sw, b, out)
    for plan in _tile_plans(k):
        got = ops.weight_only_tile_ref(xt, wt, st, bt, out, plan)
        assert got.dtype == out and got.shape == (m, n)
        _within(got, plain.float().numpy(), xt, wt, st)
        _within(got, want, xt, wt, st)


def test_spellings_batched_leading_dims():
    """Leading dims, as ``nn.QLinear`` passes [B, T, K]; x in f32 is
    rounded to bf16 first, as the plain version does."""
    x, wq, sw, b = _operands(66, 256, 40, 9, True)
    xt, wt, st, bt = _t(x).reshape(2, 33, 256), _t(wq.T), _t(sw), _t(b)
    plain = ops.weight_only_matmul_ref(xt, wt, st, bt)
    for got in (ops.weight_only_splitk_ref(xt, wt, st, bt, None, 3),
                ops.weight_only_tile_ref(xt, wt, st, bt, None, (64, 2))):
        assert got.shape == (2, 33, 40) and got.dtype == torch.float32
        _within(got, plain.numpy(), xt, wt, st)


@pytest.mark.parametrize("route", ["decode", "tile"])
def test_dropped_last_k_slice_is_caught(monkeypatch, route):
    """A planted fault: the last K slice (the decode kernel's last split,
    the tile kernel's last split of every tile) dropped. The spelling then
    differs from the plain version past the tolerance, at every split or
    plan."""
    m, k, n = 13, 1408, 200
    x, wq, sw, _ = _operands(m, k, n, 23, False)
    xt, wt, st = _t(x).to(torch.bfloat16), _t(wq.T), _t(sw)
    good = ops.weight_only_matmul_ref(xt, wt, st, None, torch.float32)
    slices = Q.k_slices
    monkeypatch.setattr(W, "k_slices", lambda k, s, step: slices(k, s, step)[:-1]
                        + [(slices(k, s, step)[-1][0],) * 2])
    plans = SPLITS if route == "decode" else _tile_plans(k)
    for plan in plans:
        bad = (ops.weight_only_splitk_ref(xt, wt, st, None, torch.float32, plan)
               if route == "decode" else
               ops.weight_only_tile_ref(xt, wt, st, None, torch.float32, plan))
        tol = ops.weight_only_tolerance(xt, wt, st, good)
        assert ((bad - good).abs() > tol).float().mean().item() > 0.5, plan
