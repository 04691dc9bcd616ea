"""The tile GEMM (``csrc/qmatmul.cu``, every int8 product of more than
``DECODE_MAX_M`` token rows) as its plan lays it out, spelled in plain
PyTorch, against the plain version and the JAX package.

The plan (``qmatmul_tile_plan``) puts every output element in exactly one
tile and splits each tile's K into slices of whole 128-byte steps that
cover [0, K) once; its choices at the model shapes on an H100 (132 SMs) are
pinned. The split spelling (``qmatmul_splitk_ref`` at the kernel's step):
the exact int32 product of each K slice, the partials summed, then the f32
epilogue, bit for bit with ``qmatmul_ref`` at every split and with the JAX
``qmatmul`` in interpret mode without a bias (with a bias XLA contracts the
add into an FMA: within the rounding of the product term and of the sum, as
``test_torch_ops.py`` holds them). Operands are random arrays made with
numpy from a seed; the kernel itself runs only on the card
(``tests/test_torch_cuda.py -k qmatmul_tile``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu import ops as jops
from protoquant_tpu_torch import ops

Q = importlib.import_module("protoquant_tpu_torch.ops.qmatmul")

SMS = 132  # an H100 SXM's SMs

# (M, K, N) of the prefill products: Llama-2-7B's q/k/v/o, gate/up, down and
# lm_head at M = 256, GPT-OSS-20B's experts at M = 80, Gemma-2-9B's gate/up
# and down at M = 512, the 7B gate/up at M = 128; each with the plan the
# kernel runs it by.
PINNED = {
    (256, 4096, 4096): (128, 2),
    (256, 4096, 11008): (256, 1),
    (256, 11008, 4096): (128, 2),
    (256, 4096, 32000): (256, 1),
    (80, 2880, 5760): (128, 2),
    (80, 2880, 2880): (128, 4),
    (512, 3584, 14336): (256, 1),
    (512, 14336, 3584): (256, 2),
    (128, 4096, 11008): (128, 1),
}


def _blocks(m, n, k, plan):
    """The kernel's blocks as csrc/qmatmul.cu indexes them: grid (row
    tiles x splits, column tiles), cluster rank = blockIdx.x % splits; each
    block's rows, columns and K range."""
    bm, splits = plan
    steps = -(-k // Q.TILE_STEP)
    for bx in range(-(-m // bm) * splits):
        rank, m0 = bx % splits, (bx // splits) * bm
        k0 = Q.TILE_STEP * (rank * steps // splits)
        k1 = min(k, Q.TILE_STEP * ((rank + 1) * steps // splits))
        for by in range(-(-n // Q.TILE_N)):
            n0 = by * Q.TILE_N
            yield (m0, min(m, m0 + bm)), (n0, min(n, n0 + Q.TILE_N)), (k0, k1)


@pytest.mark.parametrize("m,k,n", [(65, 80, 130), (80, 2880, 5760), (200, 4112, 130),
                                   (129, 16, 8), (257, 4096, 4096), (512, 14336, 3584),
                                   (1024, 4096, 11008), (300, 1024, 131)])
def test_plan_covers_every_output_once(m, k, n):
    """Every (row, column, k) triple in exactly one block: the tiles cover
    the output once and each tile's splits cover [0, K) once, each split
    whole 128-byte steps (the last cut at K) and, when K is split, at least
    TILE_MIN_STEPS of them."""
    plan = Q.qmatmul_tile_plan(m, n, k, SMS)
    bm, splits = plan
    assert bm in (128, 256) and splits in (1, 2, 4)
    assert bm == 128 or m > 128
    cover = np.zeros((m, n, -(-k // Q.TILE_STEP)), np.int32)
    for (r0, r1), (c0, c1), (k0, k1) in _blocks(m, n, k, plan):
        assert k0 % Q.TILE_STEP == 0 and k0 < k1
        if splits > 1:
            assert -(-(k1 - k0) // Q.TILE_STEP) >= Q.TILE_MIN_STEPS
        cover[r0:r1, c0:c1, k0 // Q.TILE_STEP:-(-k1 // Q.TILE_STEP)] += 1
    assert (cover == 1).all()
    slices = Q.k_slices(k, splits, Q.TILE_STEP)
    assert [s for _, _, s in _blocks(m, min(n, Q.TILE_N), k, plan)][:splits] == slices


def test_plan_at_the_model_shapes():
    """The plans the kernel runs the prefill products by on 132 SMs (from
    the plan sweep in PERF.md), and the wave they fill."""
    for (m, k, n), plan in PINNED.items():
        assert Q.qmatmul_tile_plan(m, n, k, SMS) == plan, (m, k, n)
    # the most blocks one wave holds: 7B q/k/v/o 64 tiles of 128 rows x 2
    # splits; 4 splits would need 32 clusters of 4 where 30 fit
    assert Q.qmatmul_tile_plan(256, 4096, 4096, SMS) == (128, 2)
    assert Q.qmatmul_tile_plan(80, 2880, 2880, SMS) == (128, 4)  # 23 clusters of 4
    # nothing fits one wave: the tallest tile, unsplit
    assert Q.qmatmul_tile_plan(1024, 11008, 4096, SMS) == (256, 1)
    # K too short to split: one step, or fewer than TILE_MIN_STEPS a split
    assert Q.qmatmul_tile_plan(200, 8, 16, SMS) == (128, 1)
    assert Q.qmatmul_tile_plan(200, 8, 128 * 7, SMS)[1] == 1


def _ulp(x, dtype):
    """One unit in the last place of the values x (f32 arrays holding
    values of ``dtype``) in that type, subnormals included."""
    if dtype == torch.float16:
        return np.spacing(np.abs(x).astype(np.float16)).astype(np.float32)
    scale = 2.0**16 if dtype == torch.bfloat16 else 1.0  # bf16: f32's exponent, 8 bits
    return np.spacing(np.abs(x)) * scale


@pytest.mark.parametrize("m,k,n", [(65, 80, 130), (80, 2880, 5760), (200, 4112, 130),
                                   (80, 4112, 130), (200, 2880, 130), (65, 2880, 5760)])
def test_tile_split_bit_exact_vs_plain_and_pallas(m, k, n):
    """M past the decode threshold (65, 80, 200), K of one partial step
    (80), 2880 and 4096 + 16, ragged N (130, and 5760 of GPT-OSS's
    experts), every split the kernel takes and the plan's, with and without
    a bias, f32, bf16 and f16 out: the split spelling equals the plain
    version bit for bit, and the Pallas kernel in interpret mode (without a
    bias bit for bit, with one within the FMA bound)."""
    rng = np.random.default_rng(m * 31 + k + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (n, k)).astype(np.int8)
    sx = rng.uniform(1e-4, 1e-2, m).astype(np.float32)  # f16 out stays finite
    sw = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    t = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    plan_splits = Q.qmatmul_tile_plan(m, n, k, SMS)[1]
    for b in (None, bias):
        tb = None if b is None else torch.from_numpy(b)
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                         (torch.float16, jnp.float16)):
            plain = ops.qmatmul_ref(*t, tb, out_dtype=tdt)
            for splits in sorted({1, 2, 4, plan_splits}):
                if splits > -(-k // Q.TILE_STEP):
                    continue
                got = ops.qmatmul_splitk_ref(*t, tb, out_dtype=tdt, k_splits=splits,
                                             step=Q.TILE_STEP)
                assert got.dtype == tdt and got.shape == (m, n)
                assert torch.equal(got, plain), (splits, tdt)
            jy = np.asarray(jops.qmatmul(jnp.asarray(xq), jnp.asarray(wq.T.copy()),
                                         jnp.asarray(sx), jnp.asarray(sw),
                                         None if b is None else jnp.asarray(b),
                                         out_dtype=jdt, interpret=True), np.float32)
            y = plain.float().numpy()
            if b is None:
                np.testing.assert_array_equal(jy, y)
            else:  # one ulp of the output type each for the product and the sum
                prod = ops.qmatmul_ref(*t, out_dtype=tdt).float().numpy()
                bound = _ulp(prod, tdt) + _ulp(y, tdt)
                assert (np.abs(jy - y) <= bound).all()


@pytest.mark.parametrize("k", [80, 2880, 4112])
def test_last_k_step_zeroed_is_caught(k):
    """The planted fault ``chip_smoke.py`` holds the tile kernel's output
    against: the plain product with the last 128-byte K step of xq zeroed
    differs from the right one."""
    rng = np.random.default_rng(k)
    xq = torch.from_numpy(rng.integers(-127, 128, (80, k)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (130, k)).astype(np.int8))
    sx = torch.from_numpy(rng.uniform(1e-3, 1e-1, 80).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-1, 130).astype(np.float32))
    dropped = xq.clone()
    dropped[:, Q.TILE_STEP * ((k - 1) // Q.TILE_STEP):] = 0
    good = ops.qmatmul_ref(xq, wq, sx, sw, out_dtype=torch.bfloat16)
    bad = ops.qmatmul_ref(dropped, wq, sx, sw, out_dtype=torch.bfloat16)
    assert (bad != good).sum().item() > 0


def test_routes_past_the_threshold():
    """The wrapper's routing: the decode plan gives None (the tile kernel)
    past DECODE_MAX_M, a split count at or below it; M = 4 decode steps
    stay on the decode kernel."""
    for n, k in ((4096, 4096), (11008, 4096), (5760, 2880)):
        assert Q.qmatmul_decode_plan(4, n, k, SMS) is not None
        assert Q.qmatmul_decode_plan(Q.DECODE_MAX_M, n, k, SMS) is not None
        assert Q.qmatmul_decode_plan(Q.DECODE_MAX_M + 1, n, k, SMS) is None
    assert 4 <= Q.DECODE_MAX_M <= 64  # the decode kernel takes up to 64 rows
