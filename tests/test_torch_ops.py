"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; the JAX kernels run
in Pallas interpret mode, as the JAX package's own tests run them. The port
holds the contract of ``protoquant_tpu.core.numerics`` exactly (divide, not
multiply by a reciprocal; separate multiply and add in the epilogue). Under
jit, XLA:CPU rewrites the kernels' ``amax / 127`` into ``amax * (1/127)`` and
contracts the bias add into an FMA, so the interpret-mode kernels can sit one
f32 ulp off that contract: a row's scale by one ulp (and then a code by
one), an epilogue with bias by one ulp. The tests below demand exact
agreement everywhere the interpret-mode kernel is itself on the contract,
and at most that one ulp elsewhere. The decode scatter must agree exactly.
Attention is held to ATOL: both sides sum in f32 in different orders (and
the JAX kernel, unlike its XLA formulation, scales scores after the dot),
which moves outputs of magnitude ~1 by a few ulps.

The CUDA kernels against their plain versions on the card:
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu import ops as jops
from protoquant_tpu.core import numerics as jnum
from protoquant_tpu.ops.attention import int8_kv_attention as j_attention
from protoquant_tpu.ops.attention import int8_kv_attention_xla as j_attention_xla
from protoquant_tpu.ops.kv_scatter import kv_scatter_decode as j_scatter
from protoquant_tpu_torch import ops
from protoquant_tpu_torch.core import numerics

ATOL = 2e-5  # attention outputs, f32 on both sides


def _cache_inputs(rng, B, KV, S, Dh):
    kq = rng.integers(-127, 128, (B, KV, S, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, KV, S, Dh)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (B, KV, S)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (B, KV, S)).astype(np.float32)
    return kq, ks, vq, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (33, 96)])
def test_rowquant_bit_exact_vs_pallas(shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 2
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jq, js = map(np.asarray, jops.rowquant(jx, interpret=True))
    tq, ts = (a.numpy() for a in ops.rowquant(torch.from_numpy(x).to(getattr(torch, dtype))))
    # Exact against the contract ...
    cq, cs = map(np.asarray, jnum.quantize_rowwise(jx))
    np.testing.assert_array_equal(cq, tq)
    np.testing.assert_array_equal(cs, ts)
    # ... and against the interpret-mode kernel wherever its scale is.
    np.testing.assert_array_max_ulp(js, ts, maxulp=1)
    same = js == ts
    np.testing.assert_array_equal(jq[same], tq[same])
    assert np.abs(jq.astype(np.int32) - tq.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(4, 64, 48), (33, 256, 128), (1, 512, 96)])
def test_qmatmul_bit_exact_vs_pallas(m, k, n, with_bias):
    rng = np.random.default_rng(1)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = rng.uniform(1e-3, 1e-1, m).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if with_bias else None
    jy = jops.qmatmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx),
                      jnp.asarray(sw), None if b is None else jnp.asarray(b),
                      out_dtype=jnp.float32, interpret=True)
    ty = ops.qmatmul(torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
                     torch.from_numpy(sx), torch.from_numpy(sw),
                     None if b is None else torch.from_numpy(b))
    if with_bias:
        # XLA contracts the bias add into an FMA (module docstring): the two
        # differ by the rounding of the product term and of the sum.
        prod = ops.qmatmul(torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
                           torch.from_numpy(sx), torch.from_numpy(sw)).numpy()
        y = ty.numpy()
        bound = np.spacing(np.abs(prod)) + np.spacing(np.abs(y))
        assert (np.abs(np.asarray(jy) - y) <= bound).all()
    else:
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())


def test_dynamic_qlinear_bit_exact_vs_pallas():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    wq, sw = numerics.quantize_channelwise(torch.from_numpy(w.T.copy()), dim=1)
    jy = jops.dynamic_qlinear(jnp.asarray(x), jnp.asarray(wq.numpy().T),
                              jnp.asarray(sw.numpy()), interpret=True)
    ty = ops.dynamic_qlinear(torch.from_numpy(x), wq, sw)
    xq, sx = (np.array(a) for a in jops.rowquant(jnp.asarray(x), interpret=True))
    # Given the interpret-mode kernel's own codes and scales, the GEMM and
    # epilogue agree exactly (no bias), whatever rows rowquant put one ulp off.
    want = ops.qmatmul(torch.from_numpy(xq), wq, torch.from_numpy(sx), sw)
    np.testing.assert_array_equal(np.asarray(jy), want.numpy())
    np.testing.assert_array_equal(
        ty.numpy(), np.asarray(jnum.dynamic_qlinear_ref(
            jnp.asarray(x), jnp.asarray(wq.numpy().T), jnp.asarray(sw.numpy()))))


def test_kv_scatter_decode_exact_vs_pallas_including_capacity():
    rng = np.random.default_rng(3)
    B, KV, S, Dh = 4, 2, 16, 32
    kq, ks, vq, vs = _cache_inputs(rng, B, KV, S, Dh)
    lengths = np.array([3, S, 0, S - 1], np.int32)  # row 1 is at capacity
    k8 = rng.integers(-127, 128, (B, KV, 1, Dh)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, KV, 1, Dh)).astype(np.int8)
    ksn = rng.uniform(1e-3, 2e-2, (B, KV, 1)).astype(np.float32)
    vsn = rng.uniform(1e-3, 2e-2, (B, KV, 1)).astype(np.float32)
    want = j_scatter(*map(jnp.asarray, (kq, ks, vq, vs, lengths, k8, ksn, v8, vsn)),
                     interpret=True)
    t = [torch.from_numpy(a.copy()) for a in (kq, ks, vq, vs)]
    got = ops.kv_scatter_decode(*t, *map(torch.from_numpy, (lengths, k8, ksn, v8, vsn)))
    for w, g, orig in zip(want, got, (kq, ks, vq, vs)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    np.testing.assert_array_equal(got[0][1].numpy(), kq[1])  # dropped write
    assert got[0].data_ptr() == t[0].data_ptr()  # in place


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("t_q", [1, 8])
def test_int8_attention_vs_pallas_and_xla(t_q, group):
    rng = np.random.default_rng(4 + t_q + group)
    B, KV, S, Dh = 3, 2, 64, 32
    H = KV * group
    kq, ks, vq, vs = _cache_inputs(rng, B, KV, S, Dh)
    q = rng.standard_normal((B, t_q, H, Dh)).astype(np.float32)
    lengths = np.array([0, 17, S - t_q], np.int32)  # ragged, one full row
    args = [q, kq, ks, vq, vs, lengths]
    j_kernel = np.asarray(j_attention(*map(jnp.asarray, args), interpret=True))
    j_xla = np.asarray(j_attention_xla(*map(jnp.asarray, args)))
    got = ops.int8_kv_attention(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, j_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, j_kernel, atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", [
    {"tree_mask": torch.ones(1, 1)},
])
def test_attention_variants_not_ported_raise(variant):
    q = torch.zeros(1, 1, 2, 16)
    kq = torch.zeros(1, 2, 8, 16, dtype=torch.int8)
    s = torch.ones(1, 2, 8)
    lengths = torch.zeros(1, dtype=torch.int32)
    for fn in (ops.int8_kv_attention, ops.int8_kv_attention_ref):
        with pytest.raises(NotImplementedError):
            fn(q, kq, s, kq, s, lengths, **variant)


def test_cpu_tensors_take_plain_versions_without_counting():
    ops.reset_launch_counts()
    x = torch.randn(3, 64)
    xq, sx = ops.rowquant(x)
    wq, sw = numerics.quantize_channelwise(torch.randn(32, 64), dim=1)
    y = ops.qmatmul(xq, wq, sx, sw)
    assert torch.equal(y, numerics.qmatmul_ref(xq, wq, sx, sw))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
