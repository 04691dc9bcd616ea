"""The W4A8 group GEMM's two kernels (``csrc/w4a8_group_decode.cu``, the
split-K decode kernel; ``csrc/w4a8_group_tile.cu`` on
``csrc/int4_tile_sm90.cuh``, the TMA + wgmma tile kernel) spelled out in
plain PyTorch, and the plans and routes the wrapper launches them by,
against the plain version and the JAX package.

* The codes: the kernels' biased-nibble subtract (``biased_nibble_codes``)
  gives ``unpack_int4``'s codes for every byte, -8 and 7 among them.
* ``w4a8_group_splitk_ref`` (each K split's exact int32 group sums, then one
  chain over all groups in order) and ``w4a8_group_tile_ref`` (each block's
  chain over its groups, one K split) equal ``w4a8_matmul_ref(...,
  formulation="group")`` bit for bit at every split (1 to 8) and tile
  plan, every group, ragged N and K, f32 and bf16 out, with and without a
  bias, leading dims; and the JAX ``_w4a8_kernel`` in interpret mode within
  ``_fma_tol`` (XLA:CPU may contract the chain's multiply and add into an
  FMA; the port never does).
* The plans: the decode kernel's group sums fit the shared-memory budget
  at the plan's splits, or the product takes the tile route; the tile plan
  takes one K split.
* The routes: M up to ``GROUP_DECODE_MAX_M`` takes the decode kernel, one
  row more the tile kernel (the launcher stubbed, so no card is needed);
  each route counted.
* Planted faults, the decode spelling's last K slice dropped and the tile
  spelling's last K stage dropped, differ.
Operands are random arrays made with numpy from a seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.core import numerics as jnum
from protoquant_tpu.ops.w4a8_matmul import w4a8_matmul as j_w4a8
from protoquant_tpu_torch import ops
from protoquant_tpu_torch.core import numerics
from test_torch_int4 import _fma_tol

W = importlib.import_module("protoquant_tpu_torch.ops.wo4_matmul")
A = importlib.import_module("protoquant_tpu_torch.ops.w4a8_matmul")
P = importlib.import_module("protoquant_tpu_torch.ops.gemm_plan")
Q = importlib.import_module("protoquant_tpu_torch.ops.qmatmul")

SPLITS = tuple(range(1, 9))
# (M, K, N, group): decode M (1, 4, 16, 32) and tile M (33, 70, 100); a
# ragged N (130, 200); K of 1.5 steps (96), 2.5 (320: five groups of 64), 11
# units split unevenly (1408), three groups of 256 (768); every group
CASES = [(1, 1408, 130, 128), (4, 96, 130, 32), (16, 320, 130, 64), (32, 768, 72, 256),
         (33, 96, 130, 32), (70, 320, 200, 64), (100, 768, 72, 256), (65, 1408, 200, 128)]
# cudaOccupancyMaxActiveClusters of a decode instance with 4 blocks an SM on
# an NVIDIA H100 80GB HBM3 (132 SMs), by cluster size
H100_HELD = {1: 528, 2: 264, 3: 163, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62}
# the group decode kernel's on the same card (pq_w4a8_group_decode_clusters,
# counting each block's group terms; the sweep in PERF.md), by (M, K) at
# group 128
GROUP_HELD = {(4, 4096): {1: 396, 2: 264, 3: 163, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62},
              (16, 4096): {1: 132, 2: 198, 3: 124, 4: 92, 5: 69, 6: 62, 7: 47, 8: 45},
              (4, 11008): {1: 132, 2: 132, 3: 124, 4: 124, 5: 94, 6: 79, 7: 69, 8: 62},
              (16, 11008): {1: 0, 2: 66, 3: 39, 4: 62, 5: 47, 6: 62, 7: 47, 8: 45}}


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _operands(m, k, n, group, seed):
    """x [M, K], the JAX-layout packed [K/2, N] and scales [K/g, N], bias."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    q, s = jnum.quantize_groupwise_int4(jnp.asarray(w), group)
    b = rng.standard_normal(n).astype(np.float32)
    return x, np.asarray(jnum.pack_int4(q, group)), np.asarray(s), b


def _port(x, p, s):
    """The port's operands: int8 rows and scales (the JAX quantizer's), the
    [N, K/2] packed weight and [N, K/g] scales."""
    xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
    return xq, sx, _t(xq), _t(sx), _t(p.T), _t(s.T)


def _within(got, want, tol):
    diff = (got.float() - torch.from_numpy(np.array(want, np.float32))).abs()
    assert (diff <= tol).all(), float((diff - tol).max())


def _tile_plans():
    return [(tokens, 1) for tokens in W.INT4_TILE_TOKENS["group"]]


# -- the codes -------------------------------------------------------------------


@pytest.mark.parametrize("group", [32, 64, 128, 256])
def test_biased_nibble_codes_every_byte(group):
    """Every byte value in every position of a group: the kernels' codes
    equal unpack_int4's, from -8 (nibble 8) to 7."""
    k = 512  # 256 bytes a row: row r, byte c holds (r + c) % 256
    rows = torch.arange(256, dtype=torch.int32)[:, None] + torch.arange(k // 2)[None, :]
    packed = (rows % 256).to(torch.uint8).view(torch.int8)
    codes = A.biased_nibble_codes(packed, group)
    assert torch.equal(codes, numerics.unpack_int4(packed, group))
    assert codes.min().item() == -8 and codes.max().item() == 7


# -- the spellings ---------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,group", CASES)
def test_group_splitk_bit_exact(m, k, n, group):
    """Every split 1 to 8, f32 and bf16 out, with and without a bias: the
    decode spelling equals the plain version bit for bit; the JAX kernel in
    interpret mode within the FMA bound."""
    x, p, s, b = _operands(m, k, n, group, m * 7 + k + n)
    xq, sx, xqt, sxt, pt, st = _port(x, p, s)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for bias in (None, b):
            plain = ops.w4a8_matmul_ref(xqt, sxt, pt, st, group, _t(bias), tdt, "group")
            for splits in SPLITS:
                got = ops.w4a8_group_splitk_ref(xqt, sxt, pt, st, group, _t(bias), tdt, splits)
                assert got.dtype == tdt and got.shape == (m, n)
                assert torch.equal(got, plain), (splits, tdt, bias is None)
            want = _np(j_w4a8(xq, sx, jnp.asarray(p), jnp.asarray(s), group=group,
                              bias=None if bias is None else jnp.asarray(bias), out_dtype=jdt,
                              formulation="group", interpret=True))
            _within(got, want, _fma_tol(xqt, sxt, pt, st, group, got, bias))


@pytest.mark.parametrize("m,k,n,group", CASES)
def test_group_tile_bit_exact(m, k, n, group):
    """Every tile plan, f32 and bf16 out, with and without a bias: the tile
    spelling equals the plain version bit for bit, and the JAX kernel in
    interpret mode within the FMA bound; a plan of more K splits is
    refused."""
    x, p, s, b = _operands(m, k, n, group, m * 5 + k + n)
    xq, sx, xqt, sxt, pt, st = _port(x, p, s)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for bias in (None, b):
            plain = ops.w4a8_matmul_ref(xqt, sxt, pt, st, group, _t(bias), tdt, "group")
            for plan in _tile_plans():
                got = ops.w4a8_group_tile_ref(xqt, sxt, pt, st, group, _t(bias), tdt, plan)
                assert got.dtype == tdt and got.shape == (m, n)
                assert torch.equal(got, plain), (plan, tdt, bias is None)
        want = _np(j_w4a8(xq, sx, jnp.asarray(p), jnp.asarray(s), group=group,
                          bias=jnp.asarray(b), out_dtype=jdt, formulation="group",
                          interpret=True))
        _within(got, want, _fma_tol(xqt, sxt, pt, st, group, got, b))
    with pytest.raises(ValueError, match="one K split"):
        ops.w4a8_group_tile_ref(xqt, sxt, pt, st, group, None, torch.float32, (64, 2))


@pytest.mark.parametrize("group", [32, 256])
def test_group_spellings_extreme_codes(group):
    """Codes -8 and 7 only, against int8 rows of -127 and 127: both
    spellings the plain version's bits (the int32 group sums far from
    overflow: 127 x 8 x 256)."""
    m, k, n = 9, 4 * group, 70
    g = torch.Generator().manual_seed(group)
    packed = torch.where(torch.rand(n, k // 2, generator=g) < 0.5, 0x77, 0x88 - 256)
    packed = packed.to(torch.int8)
    xq = torch.where(torch.rand(m, k, generator=g) < 0.5, 127, -127).to(torch.int8)
    sx = torch.rand(m, generator=g) * 1e-2
    scales = torch.rand(n, k // group, generator=g) * 1e-2 + 1e-4
    bias = torch.randn(n, generator=g)
    codes = numerics.unpack_int4(packed, group)
    assert set(codes.unique().tolist()) == {-8, 7}
    for tdt in (torch.float32, torch.bfloat16):
        plain = ops.w4a8_matmul_ref(xq, sx, packed, scales, group, bias, tdt, "group")
        for splits in SPLITS:
            assert torch.equal(ops.w4a8_group_splitk_ref(xq, sx, packed, scales, group, bias,
                                                         tdt, splits), plain), splits
        for plan in _tile_plans():
            assert torch.equal(ops.w4a8_group_tile_ref(xq, sx, packed, scales, group, bias,
                                                       tdt, plan), plain), plan


def test_group_spellings_leading_dims():
    """Leading dims, as ``nn.QLinear`` passes [B, T, K]."""
    x, p, s, b = _operands(66, 256, 40, 64, 9)
    _, _, xqt, sxt, pt, st = _port(x, p, s)
    xqt, sxt = xqt.reshape(2, 33, 256), sxt.reshape(2, 33)
    want = ops.w4a8_matmul_ref(xqt, sxt, pt, st, 64, _t(b), torch.float32, "group")
    assert want.shape == (2, 33, 40)
    got = ops.w4a8_group_splitk_ref(xqt, sxt, pt, st, 64, _t(b), torch.float32, 2)
    assert got.shape == (2, 33, 40) and torch.equal(got, want)
    got = ops.w4a8_group_tile_ref(xqt, sxt, pt, st, 64, _t(b), torch.float32, (64, 1))
    assert got.shape == (2, 33, 40) and torch.equal(got, want)


# -- the plans -------------------------------------------------------------------


def test_group_decode_smem():
    """A block keeps the group sums of its split's most units: 68-int rows
    of 8 tokens a fragment, a group's 64 weight rows."""
    smem = A.group_decode_smem
    assert smem(4, 4096, 128, 2) == 16 * 8 * 68 * 4  # 16 groups, one fragment
    assert smem(4, 4096, 128, 4) == 8 * 8 * 68 * 4  # 16 KB at 4 splits, as sized
    assert smem(16, 4096, 32, 3) == 11 * 4 * 16 * 68 * 4  # 11 units of 4 groups
    assert smem(32, 768, 256, 2) == 2 * 32 * 68 * 4  # a unit is one group of 256
    assert smem(32, 11008, 128, 8) == 11 * 32 * 68 * 4  # 86 groups: 11 a split
    assert smem(32, 11008, 128, 8) <= 100 * 1024 < smem(32, 11008, 128, 7)
    for k, group in ((96, 32), (4096, 128), (11008, 128), (768, 256)):
        for m in (1, 8, 9, 16, 17, 32):
            sizes = [smem(m, k, group, s) for s in SPLITS]
            assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("m", [1, 4, 16, 32])
def test_group_decode_plan_under_budget(m):
    """The plan's splits keep each block's group terms under the budget, the
    splits at most the units; decode_plan's choice where its clusters fit
    one wave, else the least waves a split; None past GROUP_DECODE_MAX_M or
    where no split's terms fit (then the tile kernel takes it)."""
    plan, smem = A.group_decode_plan, A.group_decode_smem
    for n in (8, 130, 4096, 11008, 32000):
        for k in (96, 320, 768, 1408, 4096, 11008, 14336):
            for group in (32, 64, 128, 256):
                if k % group:
                    continue
                units, _ = W.int4_decode_units(k, group)
                room = [s for s in SPLITS if s <= units
                        and smem(m, k, group, s) <= A.GROUP_DECODE_SMEM]
                splits = plan(m, n, k, group, H100_HELD)
                if m > A.GROUP_DECODE_MAX_M or not room:
                    assert splits is None
                    continue
                assert splits in room
                fit = {s: H100_HELD[s] if s in room else 0 for s in SPLITS}
                tiles = -(-n // P.DECODE_ROWS)
                if tiles <= fit[P.decode_plan(n, units, fit)]:
                    assert splits == P.decode_plan(n, units, fit)
                else:
                    pick = [s for s in room if s == 1 or 2 * s <= units] or room
                    waves = {s: -(-tiles // max(1, fit[s])) / s for s in pick}
                    assert splits in pick and waves[splits] == min(waves.values())
    # 256 units of 128 codes: 32 groups of 8 tokens a block at 8 splits
    assert (plan(m, 4096, 32768, 128, H100_HELD) is None) == (
        m > A.GROUP_DECODE_MAX_M or smem(m, 32768, 128, 8) > A.GROUP_DECODE_SMEM)


def test_group_decode_plan_by_shape():
    """The splits at the Llama-2-7B shapes on an H100, from the group
    kernel's own cluster counts: the best or within 3 % of it at each in the
    sweep in PERF.md; lm_head, which no split fits in one wave, at 2 splits
    (2 waves, half the work a block)."""
    plan = A.group_decode_plan
    for m in (4, 16):
        held_h, held_i = GROUP_HELD[(m, 4096)], GROUP_HELD[(m, 11008)]
        assert plan(m, 4096, 4096, 128, held_h) == (7 if m == 4 else 5)  # q/k/v/o
        assert plan(m, 11008, 4096, 128, held_h) == 2  # gate/up: 3 of 163 would not fit
        assert plan(m, 4096, 11008, 128, held_i) == (7 if m == 4 else 2)  # down
        assert plan(m, 32000, 4096, 128, held_h) == 2  # lm_head: 500 tiles
    assert plan(A.GROUP_DECODE_MAX_M + 1, 4096, 4096, 128, H100_HELD) is None


def test_group_tile_plan_one_split():
    """The group tile plan: 64 or 128 tokens a tile and one K split at
    every shape, as the kernel takes it; at the Llama-2-7B shapes on 132
    SMs the tokens the plan sweep in PERF.md measured best at each."""
    best_128 = {(4096, 4096): (512,), (4096, 11008): (128, 256, 512),
                (11008, 4096): (512,), (4096, 32000): (128, 256, 512)}
    for (k, n), ms in best_128.items():
        for m in (48, 64, 128, 256, 512):
            assert W.int4_tile_plan(m, n, k, 128, 132, "group") == (128 if m in ms else 64, 1)
    for m in (33, 48, 64, 100, 256, 512, 1000):
        for n in (8, 130, 4096, 11008, 32000):
            for k, group in ((96, 32), (320, 64), (768, 256), (4096, 128), (11008, 128)):
                tokens, splits = W.int4_tile_plan(m, n, k, group, 132, "group")
                assert tokens in W.INT4_TILE_TOKENS["group"] and splits == 1


# -- the routes ------------------------------------------------------------------


def test_routes_flip_at_the_threshold(monkeypatch):
    """Through the wrapper, with the launcher stubbed: M up to
    GROUP_DECODE_MAX_M takes the decode entry at the plan's splits, one row
    more the tile entry at the tile plan, as does a K whose group sums fit
    no split; each route counted."""
    calls = []

    def launch(fn_name, xq, s_x, packed, table, scol, group, bias, out_dtype, tail=None):
        m, k = xq.numel() // xq.shape[-1], xq.shape[-1]
        calls.append((fn_name, tail(m, packed.shape[0], k, torch.device("cuda", 0))))
        return torch.zeros(m, packed.shape[0])

    monkeypatch.setattr(A, "decodes", lambda x, m, group, max_m: m <= max_m)
    monkeypatch.setattr(A, "group_decode_held", lambda dev, m, k, group: H100_HELD)
    monkeypatch.setattr(A, "_launch", launch)
    monkeypatch.setattr(Q, "_sm_count", lambda dev: 132)
    n, group = 11008, 128
    top = A.GROUP_DECODE_MAX_M
    for m, k in ((1, 4096), (4, 11008), (top, 4096), (top + 1, 4096), (256, 4096),
                 (top, 32768)):
        ops.reset_launch_counts()
        calls.clear()
        packed = torch.zeros(n, k // 2, dtype=torch.int8)
        scales = torch.ones(n, k // group)
        A.w4a8_group(torch.zeros(m, k, dtype=torch.int8), torch.ones(m), packed, scales, group)
        splits = A.group_decode_plan(m, n, k, group, H100_HELD)
        if splits is not None:
            assert calls == [("pq_w4a8_group_decode", [splits])]
            assert ops.w4a8_group.routes == {"decode": 1, "tile": 0}
        else:
            assert calls == [("pq_w4a8_group_tile",
                              list(W.int4_tile_plan(m, n, k, group, 132, "group")))]
            assert ops.w4a8_group.routes == {"decode": 0, "tile": 1}
            assert m > top or k == 32768
        assert ops.w4a8_group.launches == 1
        assert ops.route_counts()["w4a8_group_" + ("decode" if splits else "tile")] == 1


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor takes the plain version and counts no launch."""
    x, p, s, b = _operands(4, 256, 40, 64, 3)
    _, _, xqt, sxt, pt, st = _port(x, p, s)
    ops.reset_launch_counts()
    got = ops.w4a8_matmul(xqt, sxt, pt, st, 64, _t(b), torch.float32, "group")
    assert torch.equal(got, ops.w4a8_matmul_ref(xqt, sxt, pt, st, 64, _t(b), torch.float32))
    assert ops.w4a8_group.launches == 0 and ops.w4a8_group.routes == {"decode": 0, "tile": 0}


# -- planted faults --------------------------------------------------------------


@pytest.mark.parametrize("splits", [1, 2, 5, 8])
def test_dropped_k_slice_is_caught(monkeypatch, splits):
    """The decode spelling with its last K slice dropped (as chip_smoke.py
    plants it: the slice's packed bytes zeroed, and the slice left out of
    the split) differs from the plain version."""
    m, k, n, group = 4, 1408, 130, 128
    x, p, s, _ = _operands(m, k, n, group, 21)
    _, _, xqt, sxt, pt, st = _port(x, p, s)
    good = ops.w4a8_matmul_ref(xqt, sxt, pt, st, group, None, torch.float32, "group")
    k0, _ = W.int4_k_slices(k, group, splits)[-1]
    zeroed = pt.clone()
    zeroed[:, k0 // 2:] = 0
    bad = ops.w4a8_group_splitk_ref(xqt, sxt, zeroed, st, group, None, torch.float32, splits)
    assert (good != bad).float().mean().item() > 0.5
    slices = W.int4_k_slices
    monkeypatch.setattr(A, "int4_k_slices", lambda k, g, s: slices(k, g, s)[:-1])
    bad = ops.w4a8_group_splitk_ref(xqt, sxt, pt, st, group, None, torch.float32, splits)
    assert (good != bad).float().mean().item() > 0.5


def test_dropped_last_k_stage_is_caught(monkeypatch):
    """The tile spelling's blocks stopping one stage (128 codes) short of K
    differ from the plain version, at every plan."""
    m, k, n, group = 65, 1408, 200, 128
    x, p, s, _ = _operands(m, k, n, group, 23)
    _, _, xqt, sxt, pt, st = _port(x, p, s)
    good = ops.w4a8_matmul_ref(xqt, sxt, pt, st, group, None, torch.float32, "group")
    blocks = W.int4_tile_blocks
    monkeypatch.setattr(A, "int4_tile_blocks", lambda *a: [
        (ms, ns, (k0, k1 - 128 if k1 == k else k1)) for ms, ns, (k0, k1) in blocks(*a)])
    for plan in _tile_plans():
        bad = ops.w4a8_group_tile_ref(xqt, sxt, pt, st, group, None, torch.float32, plan)
        assert (good != bad).float().mean().item() > 0.5, plan
