"""The int4-weight decode GEMMs (``csrc/w4a8_decode.cu``,
``csrc/wo4_decode.cu``) spelled out in plain PyTorch, and the plan the
wrappers launch them by, against the plain versions and the JAX package.

* The plan: its K slices tile [0, K) on group boundaries, its blocks cover
  the rows [0, N) once, its choices at the Llama-2-7B shapes on 132 SMs are
  pinned, and it hands M above the threshold to the tile kernel.
* The two-level table: for every code -8..7 and r16 values with exact ties,
  ``requant_table`` equals the tile kernel's per-code requant and
  ``torch.round(c * r)``; the kernel's prmt lookup of a packed word, spelled
  byte by byte, gives the table's entries in the kernel's k order.
* ``w4a8_two_level_splitk_ref`` (each split's exact int32 partial, summed,
  then the epilogue) equals ``w4a8_matmul_ref`` bit for bit at every split,
  and the JAX kernel in interpret mode where there is no bias (with a bias
  XLA:CPU contracts the add into an FMA: one f32 ulp of the term before it
  and one of the output, as ``test_torch_int4.py`` states).
* ``wo4_split_splitk_ref`` (each split's group sums in ascending order,
  the splits added in order) lies within ``weight_only_int4_tolerance`` of
  ``weight_only_int4_matmul_ref`` and of the JAX split kernel in
  interpret mode.
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
from protoquant_tpu_torch.core import numerics

W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")

SPLITS = tuple(range(1, 9))
# (M, K, N, group): M 1, 4, 16, 32; a ragged N (130); K whose units split
# unevenly (11 units of 64 bytes; 5 groups of 64 in 2.5 steps; 3 groups of
# 256); every group
CASES = [(1, 1408, 130, 128), (4, 1408, 130, 32), (16, 320, 130, 64), (32, 768, 72, 256),
         (4, 256, 48, 64), (16, 96, 40, 32)]


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


# -- the plan --------------------------------------------------------------------


@pytest.mark.parametrize("k,group", [(k, g) for k in (96, 320, 768, 1408, 2880, 4096, 11008)
                                     for g in (32, 64, 128, 256) if k % g == 0])
def test_k_slices_tile_k_on_group_boundaries(k, group):
    """Every k in exactly one slice, in order, each slice starting on a
    group boundary and a whole unit, the last ending at K; the kernels
    refuse more splits than units, so no slice of a launch is empty."""
    units, unit = W.int4_decode_units(k, group)
    assert unit == 2 * max(W.INT4_DECODE_STEP, group // 2) and unit % group == 0
    for splits in SPLITS:
        slices = W.int4_k_slices(k, group, splits)
        assert len(slices) == splits
        covered = np.zeros(k, np.int32)
        for k0, k1 in slices:
            assert k0 % group == 0 and k0 % unit == 0 and k0 <= k1
            covered[k0:k1] += 1
        assert (covered == 1).all()
        assert [a for a, _ in slices[1:]] == [b for _, b in slices[:-1]]
        if splits <= units:
            assert all(k1 > k0 for k0, k1 in slices)


@pytest.mark.parametrize("n,k,group", [(130, 1408, 128), (4096, 4096, 128), (72, 768, 256)])
def test_blocks_cover_rows_once(n, k, group):
    """A launch's blocks, 64-row tiles each split over K: every (row, k)
    pair in exactly one block."""
    for splits in SPLITS:
        covered = np.zeros((n, k), np.int32)
        for (r0, r1), (k0, k1) in W.int4_decode_blocks(n, k, group, splits):
            assert r1 - r0 <= P.DECODE_ROWS and r0 % P.DECODE_ROWS == 0
            covered[r0:r1, k0:k1] += 1
        assert (covered == 1).all()


# cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 (132 SMs), by
# cluster size: the one-fragment instances (4 blocks an SM; the card's GPCs
# hold fewer clusters of 3 to 8 than 528 / size) and the two-fragment
# two-level instance (3 blocks an SM)
H100_HELD = {1: 528, 2: 264, 3: 163, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62}
THREE_AN_SM = {1: 396, 2: 198, 3: 124, 4: 92, 5: 69, 6: 62, 7: 47, 8: 45}


def test_decode_plan_by_shape():
    """The splits at the Llama-2-7B shapes at group 128 on an H100: the
    most blocks whose clusters the card holds at once, at most 8, each
    split at least two units; None past INT4_DECODE_MAX_M."""
    plan = W.int4_decode_plan
    for m in (1, 4):
        assert plan(m, 4096, 4096, 128, H100_HELD) == 7  # 64 tiles: 448 blocks
        assert plan(m, 11008, 4096, 128, H100_HELD) == 2  # 172 tiles: 3 of 163 would not fit
        assert plan(m, 4096, 11008, 128, H100_HELD) == 7  # down: 64 tiles, 86 units
        assert plan(m, 32000, 4096, 128, H100_HELD) == 1  # lm_head: 500 tiles of 528
    assert plan(16, 4096, 4096, 128, THREE_AN_SM) == 5
    assert plan(16, 11008, 4096, 128, THREE_AN_SM) == 2
    assert plan(16, 4096, 11008, 128, THREE_AN_SM) == 5
    assert plan(16, 32000, 4096, 128, THREE_AN_SM) == 1  # no split fits one wave
    assert plan(4, 96, 256, 128, H100_HELD) == 1  # two units: one split of two
    assert plan(4, 96, 512, 128, H100_HELD) == 2
    assert plan(4, 96, 512, 256, H100_HELD) == 1  # 256-code groups: units of 256 codes
    assert plan(W.INT4_DECODE_MAX_M, 4096, 4096, 128, H100_HELD) == 7
    assert plan(W.INT4_DECODE_MAX_M + 1, 4096, 4096, 128, H100_HELD) is None
    assert plan(256, 11008, 4096, 128, H100_HELD) is None
    for n in (8, 96, 1024, 4096, 11008, 32000):
        for k in (64, 96, 2880, 4096, 11008):
            for group in (32, 64, 128, 256):
                if k % group:
                    continue
                s = plan(4, n, k, group, H100_HELD)
                units, _ = W.int4_decode_units(k, group)
                tiles = -(-n // P.DECODE_ROWS)
                assert 1 <= s <= 8 and (s == 1 or units // s >= 2)
                assert s == 1 or tiles <= H100_HELD[s]


# -- the two-level table ---------------------------------------------------------


def _tile_requant(codes, r):
    """The tile kernel's per-code requant (int4_tile_sm90.cuh, i4t_requant), op
    by op in f32: the code from 2**23 + (code + 8) less 2**23 + 8, times r,
    plus 1.5 * 2**23, the low byte of the sum's bits."""
    biased = (codes + 8).to(torch.int32)
    code = (0x4B000000 | biased).view(torch.float32) + torch.tensor(-8388616.0)
    y = code * r + torch.tensor(12582912.0)
    return (y.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


def test_requant_table_every_code_and_ties():
    """Every entry c = -8..7 equals the tile kernel's per-code requant and
    torch.round(c * r) (half to even), at r16 values that include exact
    ties c * r = j + 0.5, 0, the largest 16 and random ones."""
    rng = np.random.default_rng(3)
    ties = [0.5, 1.5, 2.5, 0.25, 0.75, 1.25, 3.5 / 7, 4.5 / 3, 16.0, 0.0, 15.9375, 2.0 / 3]
    r16 = torch.tensor(ties + list(rng.uniform(0, 16, 500)), dtype=torch.float32)
    table = A.requant_table(r16.reshape(-1, 1))[:, 0]  # [R, 16]
    codes = torch.arange(-8, 8)
    want = torch.round(codes.float()[None, :] * r16[:, None]).to(torch.int8)
    assert torch.equal(table, want)
    assert torch.equal(table, _tile_requant(codes[None, :].expand(len(r16), 16),
                                            r16[:, None]))
    # the ties are there: c * r = j + 0.5 rounds to the even j
    assert table[0, 8 + 1].item() == 0 and table[0, 8 + 3].item() == 2  # 0.5, 1.5
    assert table[1, 8 + 1].item() == 2 and table[1, 8 - 1].item() == -2  # 1.5, -1.5
    assert table[8, 0].item() == -128 and table[8, 15].item() == 112  # r = 16


def test_table_lookup_matches_the_table():
    """The kernel's lookup of packed words, spelled with prmt byte by byte:
    the low 16 bits give the entries of nibbles lo0, hi0, lo1, hi1 and the
    high 16 bits lo2, hi2, lo3, hi3, for every nibble value, under tables
    with entries of both signs."""
    rng = np.random.default_rng(5)
    r = torch.tensor([[0.7], [16.0], [-3.3], [0.0]], dtype=torch.float32)
    table = A.requant_table(r)[:, 0]  # [4, 16]
    words_np = rng.integers(0, 2**32, 4096, dtype=np.int64)
    words_np[:16] = [0x11111111 * v for v in range(16)]  # every nibble value alone
    w = torch.from_numpy(words_np)
    for row in range(4):
        tw = [x.expand_as(w) for x in A.table_words(table[row])]
        lo, hi = A.table_lookup(tw, w)
        nib = [(w >> (4 * j)) & 0xF for j in range(8)]
        entry = [table[row][n ^ 8].to(torch.int64) & 0xFF for n in nib]
        want_lo = entry[0] | (entry[1] << 8) | (entry[2] << 16) | (entry[3] << 24)
        want_hi = entry[4] | (entry[5] << 8) | (entry[6] << 16) | (entry[7] << 24)
        assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)


def test_prmt_spelling():
    """The prmt spelling against hand-worked PTX results: byte copies from
    both words and the sign-replicate flag."""
    a, b = torch.tensor([0x80402010]), torch.tensor([0x7F01FF08])
    assert A.prmt(a, b, 0x3210).item() == 0x80402010
    assert A.prmt(a, b, 0x7654).item() == 0x7F01FF08
    assert A.prmt(a, b, 0x0415).item() == 0x100820FF  # bytes 5, 1, 4, 0
    # sign-replicated bytes 5 (0xFF) and 4 (0x08), byte 3 raw, then replicated
    assert A.prmt(a, b, 0xB3CD).item() == 0xFF8000FF
    assert A.prmt(a, b, 0x10000 | 0x3210).item() == 0x80402010  # high bits unread


# -- the split-K spellings -------------------------------------------------------


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n,group", CASES)
def test_two_level_splitk_bit_exact(m, k, n, group, with_bias):
    """Every split, f32 and bf16 out: the split-K spelling equals the plain
    version bit for bit, and the JAX two-level kernel in interpret mode
    without a bias (with one: the FMA bound)."""
    x, p, s, b = _operands(m, k, n, group, m * 7 + k + n, with_bias)
    xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
    xqt, sxt, pt, st = _t(xq), _t(sx), _t(p.T), _t(s.T)
    r16, scol = ops.two_level_scales(st)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        plain = ops.w4a8_matmul_ref(xqt, sxt, pt, st, group, _t(b), tdt, "two_level")
        for splits in SPLITS:
            got = ops.w4a8_two_level_splitk_ref(xqt, sxt, pt, r16, scol, group, _t(b), tdt,
                                                splits)
            assert got.dtype == tdt and got.shape == (m, n)
            assert torch.equal(got, plain), splits
        want = _np(j_w4a8(xq, sx, jnp.asarray(p), jnp.asarray(s), group=group,
                          bias=None if b is None else jnp.asarray(b), out_dtype=jdt,
                          formulation="two_level", interpret=True))
        if b is None:
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            pre = ops.w4a8_two_level_splitk_ref(xqt, sxt, pt, r16, scol, group, None,
                                                torch.float32, 2).abs()
            _, exp = torch.frexp(got.float().abs() + pre)
            tol = (torch.finfo(torch.float32).eps * pre
                   + torch.finfo(tdt).eps * torch.pow(2.0, (exp - 1).float()))
            _within(got, want, tol)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n,group", CASES)
def test_split_splitk_within_tolerance(m, k, n, group, with_bias):
    """Every split, f32 and bf16 out: the split-K spelling lies within
    weight_only_int4_tolerance of the plain version and of the JAX split
    kernel in interpret mode."""
    x, p, s, b = _operands(m, k, n, group, m * 11 + k + n, with_bias)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt, pt, st = _t(_np(xj)).to(torch.bfloat16), _t(p.T), _t(s.T)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        plain = ops.weight_only_int4_matmul_ref(xt, pt, st, group, _t(b), tdt)
        want = _np(j_wo4(xj, jnp.asarray(p), jnp.asarray(s), group,
                         None if b is None else jnp.asarray(b), out_dtype=jdt,
                         interpret=True, formulation="split"))
        for splits in SPLITS:
            got = ops.wo4_split_splitk_ref(xt, pt, st, group, _t(b), tdt, splits)
            assert got.dtype == tdt and got.shape == (m, n)
            tol = ops.weight_only_int4_tolerance(xt, pt, st, group, got)
            _within(got, plain.float().numpy(), tol)
            _within(got, want, tol)


def test_splitk_batched_leading_dims():
    """Leading dims, as ``nn.QLinear`` passes [B, T, K]."""
    x, p, s, b = _operands(6, 256, 40, 64, 9, True)
    xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
    xqt, sxt, pt, st = _t(xq).reshape(2, 3, 256), _t(sx).reshape(2, 3), _t(p.T), _t(s.T)
    r16, scol = ops.two_level_scales(st)
    got = ops.w4a8_two_level_splitk_ref(xqt, sxt, pt, r16, scol, 64, _t(b), torch.float32, 2)
    want = ops.w4a8_matmul_ref(xqt, sxt, pt, st, 64, _t(b), torch.float32, "two_level")
    assert got.shape == (2, 3, 40) and torch.equal(got, want)
    xt = torch.from_numpy(x).reshape(2, 3, 256)
    got = ops.wo4_split_splitk_ref(xt, pt, st, 64, _t(b), torch.float32, 2)
    assert got.shape == (2, 3, 40)
    _within(got, ops.weight_only_int4_matmul_ref(xt, pt, st, 64, _t(b)).numpy(),
            ops.weight_only_int4_tolerance(xt, pt, st, 64, got))


@pytest.mark.parametrize("formulation", ["two_level", "split"])
def test_dropped_last_group_is_caught(formulation):
    """The planted fault ``chip_smoke.py`` holds each decode case to: the
    plain product with the weight's last group zeroed differs."""
    m, k, n, group = 4, 512, 64, 128
    x, p, s, _ = _operands(m, k, n, group, 21, False)
    pt, st = _t(p.T), _t(s.T)
    dropped = pt.clone()
    dropped[:, -group // 2:] = 0  # the last group's bytes: codes 0
    if formulation == "two_level":
        xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
        good = ops.w4a8_matmul_ref(_t(xq), _t(sx), pt, st, group, None, torch.bfloat16,
                                   formulation)
        bad = ops.w4a8_matmul_ref(_t(xq), _t(sx), dropped, st, group, None, torch.bfloat16,
                                  formulation, ops.two_level_scales(st))
    else:
        xt = torch.from_numpy(x).to(torch.bfloat16)
        good = ops.weight_only_int4_matmul_ref(xt, pt, st, group)
        bad = ops.weight_only_int4_matmul_ref(xt, dropped, st, group)
    assert (good != bad).float().mean().item() > 0.5
    assert numerics.unpack_int4(dropped, group)[:, -group:].abs().sum().item() == 0
