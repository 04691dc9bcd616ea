"""The split-K decode GEMM (``csrc/qmatmul_decode.cu``) spelled out in plain
PyTorch by ``qmatmul_splitk_ref``, and the plan the wrapper launches it by,
against the plain version and the JAX package.

The int32 partials of each K slice summed, then the f32 epilogue: bit for
bit with ``qmatmul_ref`` at every split, and with the JAX ``qmatmul`` in
interpret mode without a bias (with a bias XLA contracts the add into an
FMA, so the two differ by the rounding of the product term and of the sum,
the bound ``test_torch_ops.py`` holds them to). Operands are random arrays
made with numpy from a seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu import ops as jops
from protoquant_tpu_torch import ops

Q = importlib.import_module("protoquant_tpu_torch.ops.qmatmul")

N = 96
SPLITS = (1, 2, 4, 8)


def _operands(seed, m, k, n=N):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (n, k)).astype(np.int8)
    sx = rng.uniform(1e-3, 1e-1, m).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return xq, wq, sx, sw, bias


@pytest.mark.parametrize("k", [16, 80, 4096 + 16])
@pytest.mark.parametrize("m", [1, 3, 4, 8, 9, 33])
def test_splitk_bit_exact_vs_plain_and_pallas(m, k):
    """M from 1 to 33 (one to five fragments of 8 tokens), K of one step, a
    ragged step and 4096 + 16, every split, with and without a bias, f32 and
    bf16 out: the split-K formulation equals ``qmatmul_ref`` bit for bit,
    and the Pallas kernel in interpret mode without a bias."""
    xq, wq, sx, sw, bias = _operands(m * 7 + k, m, k)
    t = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    for b in (None, bias):
        tb = None if b is None else torch.from_numpy(b)
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            plain = ops.qmatmul_ref(*t, tb, out_dtype=tdt)
            for splits in SPLITS:
                got = ops.qmatmul_splitk_ref(*t, tb, out_dtype=tdt, k_splits=splits)
                assert got.dtype == tdt and got.shape == (m, N)
                np.testing.assert_array_equal(got.float().numpy(), plain.float().numpy())
            jy = np.asarray(jops.qmatmul(jnp.asarray(xq), jnp.asarray(wq.T.copy()),
                                         jnp.asarray(sx), jnp.asarray(sw),
                                         None if b is None else jnp.asarray(b),
                                         out_dtype=jdt, interpret=True), np.float32)
            y = got.float().numpy()
            if b is None:
                np.testing.assert_array_equal(jy, y)
            else:  # one ulp of the output type each for the product and the sum
                prod = ops.qmatmul_ref(*t, out_dtype=tdt).float().numpy()
                scale = 2.0**16 if tdt == torch.bfloat16 else 1.0  # bf16 ulp in f32 ulps
                bound = (np.spacing(np.abs(prod)) + np.spacing(np.abs(y))) * scale
                assert (np.abs(jy - y) <= bound).all()


def test_splitk_batched_leading_dims():
    """xq [..., K] with leading dims, as ``nn.QLinear`` passes [B, T, K]."""
    xq, wq, sx, sw, bias = _operands(3, 6, 256)
    t = [torch.from_numpy(a) for a in (xq.reshape(2, 3, 256), wq, sx.reshape(2, 3), sw)]
    got = ops.qmatmul_splitk_ref(*t, torch.from_numpy(bias), k_splits=4)
    want = ops.qmatmul_ref(*t, torch.from_numpy(bias))
    assert got.shape == (2, 3, N) and torch.equal(got, want)


@pytest.mark.parametrize("k", [16, 64, 80, 2880, 4096, 4112, 11008])
def test_k_slices_cover_k_once(k):
    """Every k in exactly one slice, the slices in order, each starting on a
    64-byte step, the last ending at K."""
    for splits in SPLITS:
        slices = Q.k_slices(k, splits)
        assert len(slices) == splits
        covered = np.zeros(k, np.int32)
        for k0, k1 in slices:
            assert k0 % Q.DECODE_STEP == 0 and k0 <= k1
            covered[k0:k1] += 1
        assert (covered == 1).all()
        assert [a for a, _ in slices[1:]] == [b for _, b in slices[:-1]]
        assert slices[0][0] == 0 and slices[-1][1] == k


def test_decode_plan_by_shape():
    """The splits at the shapes the engine runs on an H100 (132 SMs): the
    count of 64-row blocks nearest DECODE_BLOCKS_PER_SM an SM, at most 8,
    each split at least two 64-byte steps; None past DECODE_MAX_M (the tile
    kernel)."""
    plan = Q.qmatmul_decode_plan
    assert plan(4, 4096, 4096, 132) == 4  # 64 tiles: 256 blocks
    assert plan(4, 11008, 4096, 132) == 2  # 172 tiles: 344
    assert plan(4, 4096, 11008, 132) == 4
    assert plan(4, 32000, 4096, 132) == 1  # 500 tiles
    assert plan(1, 5760, 2880, 132) == 4  # GPT-OSS's experts: 360 blocks
    assert plan(1, 2880, 2880, 132) == 8  # 360
    assert plan(4, 201088, 2880, 132) == 1  # GPT-OSS's lm_head
    assert plan(4, 1024, 4096, 132) == 8  # 16 tiles: as many as a cluster takes
    assert plan(4, 96, 16, 132) == 1  # one step of K: no split
    assert plan(4, 96, 128, 132) == 1  # two steps: one split of two
    assert plan(4, 96, 256, 132) == 2
    assert plan(Q.DECODE_MAX_M, 4096, 4096, 132) == 4
    assert plan(Q.DECODE_MAX_M + 1, 4096, 4096, 132) is None
    assert plan(256, 11008, 4096, 132) is None
    for n in (8, 96, 1024, 4096, 11008, 32000):
        for k in (16, 80, 2880, 4096, 11008):
            s = plan(4, n, k, 132)
            steps = -(-k // Q.DECODE_STEP)
            assert s in SPLITS and (s == 1 or steps // s >= 2)


def test_dropped_k_slice_is_caught():
    """A planted fault, as ``chip_smoke.py`` plants it: one K slice left out
    of the sum changes the output."""
    xq, wq, sx, sw, _ = _operands(11, 4, 4096)
    t = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    k0, k1 = Q.k_slices(4096, 8)[-1]
    dropped = t[0].clone()
    dropped[:, k0:k1] = 0
    assert not torch.equal(ops.qmatmul_splitk_ref(dropped, *t[1:], k_splits=8),
                           ops.qmatmul_ref(*t))
