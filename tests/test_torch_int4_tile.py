"""The int4-weight tile GEMMs (``csrc/w4a8_tile.cu``, ``csrc/wo4_tile.cu``
on ``csrc/int4_tile_sm90.cuh``) spelled out in plain PyTorch, and the plan
the wrappers launch them by, against the plain versions and the JAX package.

* The plan: its blocks cover every output once and their K slices tile
  [0, K) on group boundaries; its choices at the Llama-2-7B shapes on 132
  SMs are pinned.
* The routes: M up to the body's threshold (``INT4_DECODE_MAX_M``,
  ``SPLIT_DECODE_MAX_M``) takes the decode kernel, one row more the tile
  kernel at the plan (the launchers stubbed, so no card is needed).
* ``w4a8_two_level_tile_ref`` (every code requantized on its own, each
  block's exact int32 partial, then the epilogue) equals ``w4a8_matmul_ref``
  bit for bit at every plan, and the JAX kernel in interpret mode without a
  bias.
* ``wo4_split_tile_ref`` (each block's group sums in ascending order, a
  tile's K slices added in order) lies within ``weight_only_int4_tolerance``
  of ``weight_only_int4_matmul_ref`` and of the JAX split kernel in
  interpret mode.
* A planted fault, the last K stage of a launch dropped, fails both.
Operands are random arrays made with numpy from a seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.core import numerics as jnum
from protoquant_tpu.ops.w4a8_matmul import w4a8_matmul as j_w4a8
from protoquant_tpu.ops.wo4_matmul import weight_only_int4_matmul as j_wo4
from protoquant_tpu_torch import ops

W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")
A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
Q = importlib.import_module("protoquant_tpu_torch.ops.qmatmul")

# (M, K, N, group): M past the threshold and ragged against every token tile;
# a ragged N (130, 200); K of 1.5 stages (96), 2.5 (320, five groups of 64),
# 11 units split unevenly (1408), three groups of 256 (768); every group
CASES = [(33, 96, 130, 32), (70, 320, 130, 64), (100, 768, 72, 256), (65, 1408, 200, 128),
         (257, 256, 40, 64)]
SPLITS = (1, 2, 3, 4, 6, 8)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _operands(m, k, n, group, seed, bias):
    """x [M, K], the JAX-layout packed [K/2, N] and scales [K/g, N], bias."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    q, s = jnum.quantize_groupwise_int4(jnp.asarray(w), group)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return x, np.asarray(jnum.pack_int4(q, group)), np.asarray(s), b


def _within(got, want, tol):
    diff = (got.float() - torch.from_numpy(np.array(want, np.float32))).abs()
    assert (diff <= tol).all(), float((diff - tol).max())


def _plans(k, group, formulation):
    units, _ = W.int4_decode_units(k, group)
    return [(tokens, s) for tokens in W.INT4_TILE_TOKENS[formulation] for s in SPLITS
            if s <= units]


# -- the plan --------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,group", CASES + [(512, 4096, 300, 128), (48, 11008, 128, 128)])
def test_blocks_cover_every_output_once(m, k, n, group):
    """A launch's blocks: 128 weight rows by a token tile, each split over
    K; every (token, row) pair in the blocks of exactly one tile, whose K
    slices run from 0 to K in order, each starting on a group boundary."""
    rows = P.TILE_ROWS
    for formulation in ("split", "two_level"):
        for plan in _plans(k, group, formulation):
            tokens, splits = plan
            covered = np.zeros((m, n), np.int32)
            slices = {}
            for (m0, m1), (n0, n1), (k0, k1) in W.int4_tile_blocks(m, n, k, group, plan):
                assert m0 % tokens == 0 and m1 - m0 <= tokens
                assert n0 % rows == 0 and n1 - n0 <= rows
                assert k0 % group == 0 and k0 < k1 <= k
                slices.setdefault((m0, n0), []).append((k0, k1))
                if k0 == 0:
                    covered[m0:m1, n0:n1] += 1
            assert (covered == 1).all()
            for ks in slices.values():
                assert len(ks) == splits and ks[0][0] == 0 and ks[-1][1] == k
                assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))


def test_tile_plan_by_shape():
    """The plans at the Llama-2-7B shapes at group 128 on an H100 (132
    SMs), by M: (tokens a tile, K splits), the best of the plan sweep in
    PERF.md at each; every plan a tile the body takes and splits that keep
    their units."""
    plan = W.int4_tile_plan
    want = {  # (K, N): {M: (split, two_level)}
        (4096, 4096): {48: ((64, 3), (64, 3)), 64: ((64, 3), (64, 3)),
                       256: ((128, 2), (128, 2)), 512: ((128, 1), (256, 2))},
        (4096, 11008): {48: ((64, 1), (64, 1)), 64: ((64, 1), (64, 1)),
                        256: ((128, 2), (256, 1)), 512: ((128, 1), (256, 2))},
        (11008, 4096): {48: ((64, 3), (64, 3)), 64: ((64, 3), (64, 3)),
                        256: ((128, 2), (128, 2)), 512: ((128, 1), (256, 2))},
        (4096, 32000): {48: ((64, 1), (64, 1)), 64: ((64, 1), (64, 1)),
                        256: ((128, 1), (256, 1)), 512: ((128, 1), (256, 1))}}
    for (k, n), by_m in want.items():
        for m, (split, two_level) in by_m.items():
            assert plan(m, n, k, 128, 132, "split") == split, (k, n, m)
            assert plan(m, n, k, 128, 132, "two_level") == two_level, (k, n, m)
    for m in (33, 64, 100, 256, 1000):
        for n in (8, 130, 4096, 32000):
            for k, group in ((96, 32), (320, 64), (768, 256), (4096, 128), (11008, 128)):
                for formulation in ("split", "two_level"):
                    tokens, s = plan(m, n, k, group, 132, formulation)
                    units, _ = W.int4_decode_units(k, group)
                    assert tokens in W.INT4_TILE_TOKENS[formulation]
                    assert s == 1 or (s in SPLITS and units >= s * W.INT4_TILE_MIN_UNITS)


def test_routes_flip_at_the_threshold(monkeypatch):
    """Through the wrappers, with the launchers stubbed: M up to the body's
    threshold (INT4_DECODE_MAX_M for two_level, SPLIT_DECODE_MAX_M for
    split) takes the decode entry at the decode plan's splits, one row more
    the tile entry at the tile plan; the route counters count each."""
    calls = []

    def launch(fn_name, *args):
        x, tail = args[0], args[-1]
        m, k = x.numel() // x.shape[-1], x.shape[-1]
        n = args[2].shape[0] if fn_name.startswith("pq_w4a8") else args[1].shape[0]
        calls.append((fn_name, tail(m, n, k, torch.device("cuda", 0))))
        return torch.zeros(m, n)

    held = dict.fromkeys(range(1, 9), 528)
    for mod in (W, A):
        monkeypatch.setattr(mod, "decodes",
                            lambda x, m, group, max_m=W.INT4_DECODE_MAX_M: m <= max_m)
        monkeypatch.setattr(mod, "int4_decode_held", lambda *a: held)
        monkeypatch.setattr(mod, "_launch", launch)
    monkeypatch.setattr(Q, "_sm_count", lambda dev: 132)
    k, n, group = 4096, 11008, 128
    packed = torch.zeros(n, k // 2, dtype=torch.int8)
    scales = torch.ones(n, k // group)
    r16, scol = ops.two_level_scales(scales)
    thresholds = {"split": W.SPLIT_DECODE_MAX_M, "two_level": W.INT4_DECODE_MAX_M}
    for m in sorted({t + d for t in thresholds.values() for d in (0, 1)} | {256}):
        ops.reset_launch_counts()
        calls.clear()
        W.wo4_split(torch.zeros(m, k, dtype=torch.bfloat16), packed, scales, group)
        A.w4a8_two_level(torch.zeros(m, k, dtype=torch.int8), torch.ones(m), packed, r16, scol,
                         group)
        for (fn, route), (name, wrapper) in zip(calls, (("split", ops.wo4_split),
                                                        ("two_level", ops.w4a8_two_level))):
            if m <= thresholds[name]:
                assert (fn, route) == (f"pq_{wrapper.__name__}_decode",
                                       [W.int4_decode_plan(m, n, k, group, held)])
                assert wrapper.routes == {"decode": 1, "tile": 0}
            else:
                assert (fn, route) == (f"pq_{wrapper.__name__}",
                                       list(W.int4_tile_plan(m, n, k, group, 132, name)))
                assert wrapper.routes == {"decode": 0, "tile": 1}
            assert wrapper.launches == 1
        assert len(calls) == 2


# -- the spellings ---------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,group", CASES)
def test_two_level_tile_bit_exact(m, k, n, group):
    """Every plan, f32 and bf16 out, with and without a bias: the tile
    spelling equals the plain version bit for bit, and the JAX two-level
    kernel in interpret mode without a bias."""
    x, p, s, b = _operands(m, k, n, group, m * 5 + k + n, True)
    xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
    xqt, sxt, pt, st = _t(xq), _t(sx), _t(p.T), _t(s.T)
    r16, scol = ops.two_level_scales(st)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for bias in (None, _t(b)):
            plain = ops.w4a8_matmul_ref(xqt, sxt, pt, st, group, bias, tdt, "two_level")
            for plan in _plans(k, group, "two_level"):
                got = ops.w4a8_two_level_tile_ref(xqt, sxt, pt, r16, scol, group, bias, tdt,
                                                  plan)
                assert got.dtype == tdt and got.shape == (m, n)
                assert torch.equal(got, plain), plan
        want = _np(j_w4a8(xq, sx, jnp.asarray(p), jnp.asarray(s), group=group, bias=None,
                          out_dtype=jdt, formulation="two_level", interpret=True))
        got = ops.w4a8_two_level_tile_ref(xqt, sxt, pt, r16, scol, group, None, tdt,
                                          W.int4_tile_plan(m, n, k, group, 132, "two_level"))
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("m,k,n,group", CASES)
def test_split_tile_within_tolerance(m, k, n, group):
    """Every plan, f32 and bf16 out, with and without a bias: the tile
    spelling lies within weight_only_int4_tolerance of the plain version
    and of the JAX split kernel in interpret mode."""
    x, p, s, b = _operands(m, k, n, group, m * 3 + k + n, True)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt, pt, st = _t(_np(xj)).to(torch.bfloat16), _t(p.T), _t(s.T)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for bias, jb in ((None, None), (_t(b), jnp.asarray(b))):
            plain = ops.weight_only_int4_matmul_ref(xt, pt, st, group, bias, tdt)
            want = _np(j_wo4(xj, jnp.asarray(p), jnp.asarray(s), group, jb, out_dtype=jdt,
                             interpret=True, formulation="split"))
            for plan in _plans(k, group, "split"):
                got = ops.wo4_split_tile_ref(xt, pt, st, group, bias, tdt, plan)
                assert got.dtype == tdt and got.shape == (m, n)
                tol = ops.weight_only_int4_tolerance(xt, pt, st, group, got)
                _within(got, plain.float().numpy(), tol)
                _within(got, want, tol)


def test_tile_spellings_batched_leading_dims():
    """Leading dims, as ``nn.QLinear`` passes [B, T, K]."""
    x, p, s, b = _operands(66, 256, 40, 64, 9, True)
    xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
    xqt, sxt, pt, st = _t(xq).reshape(2, 33, 256), _t(sx).reshape(2, 33), _t(p.T), _t(s.T)
    r16, scol = ops.two_level_scales(st)
    got = ops.w4a8_two_level_tile_ref(xqt, sxt, pt, r16, scol, 64, _t(b), torch.float32,
                                      (64, 2))
    want = ops.w4a8_matmul_ref(xqt, sxt, pt, st, 64, _t(b), torch.float32, "two_level")
    assert got.shape == (2, 33, 40) and torch.equal(got, want)
    xt = torch.from_numpy(x).reshape(2, 33, 256)
    got = ops.wo4_split_tile_ref(xt, pt, st, 64, _t(b), torch.float32, (64, 3))
    assert got.shape == (2, 33, 40)
    _within(got, ops.weight_only_int4_matmul_ref(xt, pt, st, 64, _t(b)).numpy(),
            ops.weight_only_int4_tolerance(xt, pt, st, 64, got))


@pytest.mark.parametrize("formulation", ["two_level", "split"])
def test_dropped_last_k_stage_is_caught(monkeypatch, formulation):
    """A planted fault: the blocks of the last K split stop one stage (128
    codes) short of K. The spelling then differs from the plain version
    past the tolerance, at every plan."""
    m, k, n, group = 65, 1408, 200, 128
    x, p, s, _ = _operands(m, k, n, group, 23, False)
    pt, st = _t(p.T), _t(s.T)
    blocks = W.int4_tile_blocks

    def short(m, n, k, group, plan):
        return [(ms, ns, (k0, k1 - 128 if k1 == k else k1))
                for ms, ns, (k0, k1) in blocks(m, n, k, group, plan)]

    monkeypatch.setattr(W, "int4_tile_blocks", short)
    monkeypatch.setattr(A, "int4_tile_blocks", short)
    for plan in _plans(k, group, formulation):
        if formulation == "two_level":
            xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
            xqt, sxt = _t(xq), _t(sx)
            good = ops.w4a8_matmul_ref(xqt, sxt, pt, st, group, None, torch.float32, formulation)
            bad = ops.w4a8_two_level_tile_ref(xqt, sxt, pt, *ops.two_level_scales(st), group,
                                              None, torch.float32, plan)
            assert (good != bad).float().mean().item() > 0.5, plan
        else:
            xt = torch.from_numpy(x).to(torch.bfloat16)
            good = ops.weight_only_int4_matmul_ref(xt, pt, st, group, None, torch.float32)
            bad = ops.wo4_split_tile_ref(xt, pt, st, group, None, torch.float32, plan)
            tol = ops.weight_only_int4_tolerance(xt, pt, st, group, good)
            assert ((good - bad).abs() > tol).float().mean().item() > 0.5, plan
