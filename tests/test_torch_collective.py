"""The port's ring collective matmul against the JAX package's, on the CPU.

The JAX functions run inside ``jax.shard_map`` over tp of the 8 virtual CPU
devices that ``tests/conftest.py`` makes, the explicit-DMA Pallas ring
(B19) in TPU interpret mode; the port's run on a mesh of tp ranks on the
CPU (``make_mesh(devices=["cpu"] * tp)``), each rank a thread, the kernel
wrappers taking their plain versions. The limits are the JAX package's own
(``tests/test_collective.py``): bitwise with unit scales, where every value
is an exactly representable int32 sum, and ``rtol = atol = 1e-6`` with
real scales, where the two frameworks may contract the f32 epilogue into
the ring add differently. The JAX weight is [K, N]; the port's is [N, K].
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from protoquant_tpu import ops as jops
from protoquant_tpu.core import numerics as jnumerics
from protoquant_tpu.ops.collective_matmul import \
    qmatmul_reduce_scatter_dma as j_qmatmul_reduce_scatter_dma
from protoquant_tpu.parallel import collective as jcoll
from protoquant_tpu_torch import ops
from protoquant_tpu_torch.core import numerics
from protoquant_tpu_torch.parallel import collective as coll
from protoquant_tpu_torch.parallel import make_mesh
from protoquant_tpu_torch.utils import MeshConfig

needs_8dev = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")


def _jmesh(tp):
    return JMesh(np.asarray(jax.devices()[:tp]), ("model",))


def _mesh(tp):
    return make_mesh(MeshConfig(tp=tp), ["cpu"] * tp)


def _split_k(a: np.ndarray, tp: int, r: int) -> torch.Tensor:
    """Rank r's contiguous slice of the last axis (K)."""
    ks = a.shape[-1] // tp
    return torch.from_numpy(np.ascontiguousarray(a[..., r * ks:(r + 1) * ks]))


def _int_operands(seed, M, K, N, real_scales):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)  # JAX [K, N]
    if real_scales:
        sx = rng.uniform(0.001, 0.05, M).astype(np.float32)
        sw = rng.uniform(0.0005, 0.02, N).astype(np.float32)
    else:
        sx, sw = np.ones(M, np.float32), np.ones(N, np.float32)
    return xq, sx, wq, sw


def _jax_dma(xq, sx, wq, sw, tp):
    @functools.partial(jax.shard_map, mesh=_jmesh(tp),
                       in_specs=(P(None, "model"), P(), P("model", None), P()),
                       out_specs=P(None, "model"), check_vma=False)
    def f(xq, sx, wq, sw):
        return j_qmatmul_reduce_scatter_dma(xq, sx, wq, sw, axis="model", tp=tp,
                                            interpret=True)

    return np.asarray(f(jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(wq), jnp.asarray(sw)))


def _port_dma(xq, sx, wq, sw, tp, fn=None):
    mesh, wq_nk = _mesh(tp), np.ascontiguousarray(wq.T)
    fn = fn or ops.qmatmul_reduce_scatter_dma
    outs = mesh.run(lambda r: fn(_split_k(xq, tp, r), torch.from_numpy(sx),
                                 _split_k(wq_nk, tp, r), torch.from_numpy(sw), mesh.group))
    return torch.cat(outs, -1).numpy()


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
def test_dma_ring_plain_bitwise_unit_scales(tp):
    xq, sx, wq, sw = _int_operands(1, 8, 32 * tp, 32 * tp, real_scales=False)
    want = _jax_dma(xq, sx, wq, sw, tp)
    got = _port_dma(xq, sx, wq, sw, tp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (xq.astype(np.int64) @ wq).astype(np.float32))


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
def test_dma_ring_plain_real_scales(tp):
    xq, sx, wq, sw = _int_operands(2, 8, 16 * tp, 16 * tp, real_scales=True)
    want = _jax_dma(xq, sx, wq, sw, tp)
    got = _port_dma(xq, sx, wq, sw, tp)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the per-rank plain call and the all-ranks plain version are one function
    np.testing.assert_array_equal(_port_dma(xq, sx, wq, sw, tp,
                                            ops.qmatmul_reduce_scatter_dma_ref), got)


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_dma_ring_order_is_the_ring(tp):
    """Chunk e adds rank e + 1's product first and rank e's last: with real
    scales that order is visible bit for bit, so the plain version is held
    to the ring written out here, and from tp = 4 a reversed ring differs."""
    xq, sx, wq, sw = _int_operands(3, 5, 64 * tp, 32 * tp, real_scales=True)
    wq_nk = np.ascontiguousarray(wq.T)
    xqs = [_split_k(xq, tp, r) for r in range(tp)]
    wqs = [_split_k(wq_nk, tp, r) for r in range(tp)]
    sxs, sws = [torch.from_numpy(sx)] * tp, [torch.from_numpy(sw)] * tp
    nc = wq.shape[1] // tp
    prod = lambda d, e: numerics.qmatmul_ref(xqs[d], wqs[d][e * nc:(e + 1) * nc], sxs[d],
                                             sws[d][e * nc:(e + 1) * nc])
    got = ops.qmatmul_reduce_scatter_dma_all(xqs, sxs, wqs, sws)
    for e in range(tp):
        ring = prod((e + 1) % tp, e)
        for hop in range(2, tp + 1):
            ring = ring + prod((e + hop) % tp, e)
        assert torch.equal(got[e], ring)
    if tp >= 4:  # at tp = 3 the reversed ring only swaps its first, commutative addition
        reversed_ring = [functools.reduce(torch.add, [prod((e - h) % tp, e)
                                                      for h in range(1, tp + 1)])
                         for e in range(tp)]
        assert any(not torch.equal(a, b) for a, b in zip(got, reversed_ring))


def _unit_scale_activations(seed, B, T, K, tp):
    """Integer-valued activations whose every rank slice of every row holds
    a +-127, so each rank's rowquant scale is exactly 1 and its codes are
    the values themselves."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-126, 127, (B, T, K)).astype(np.float32)
    ks = K // tp
    x[..., ::ks] = 127.0
    return x


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("unit", [True, False])
def test_ppermute_tier_matches_jax(tp, unit):
    """``qmatmul_reduce_scatter`` (rowquant, per-chunk qmatmul, ppermute
    hops) against the JAX tier's, both through their plain kernels."""
    M, K, N = 8, 64 * tp, 32 * tp
    rng = np.random.default_rng(4)
    if unit:
        x = _unit_scale_activations(4, 1, M, K, tp)[0]
        wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
        sw = np.ones(N, np.float32)
    else:
        x = rng.standard_normal((M, K)).astype(np.float32)
        w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
        wq, sw = map(np.array, jnumerics.quantize_channelwise(jnp.asarray(w), axis=0))

    @functools.partial(jax.shard_map, mesh=_jmesh(tp),
                       in_specs=(P(None, "model"), P("model", None), P()),
                       out_specs=P(None, "model"), check_vma=False)
    def f(x, wq, sw):
        return jcoll.qmatmul_reduce_scatter(x, wq, sw, "model", tp, out_dtype=jnp.float32,
                                            interpret=True)

    want = np.asarray(f(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw)))
    mesh, wq_nk = _mesh(tp), np.ascontiguousarray(wq.T)
    outs = mesh.run(lambda r: coll.qmatmul_reduce_scatter(
        _split_k(x, tp, r), _split_k(wq_nk, tp, r), torch.from_numpy(sw), mesh.group,
        out_dtype=torch.float32))
    got = torch.cat(outs, -1).numpy()
    if unit:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # qmatmul_allreduce_overlapped: the same chunks, gathered on every rank
    full = mesh.run(lambda r: coll.qmatmul_allreduce_overlapped(
        _split_k(x, tp, r), _split_k(wq_nk, tp, r), torch.from_numpy(sw), mesh.group,
        out_dtype=torch.float32))
    for f_r in full:
        np.testing.assert_array_equal(f_r.numpy(), got)


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backend", ["ppermute", "dma"])
def test_dynamic_qlinear_collective_matches_jax(tp, backend, monkeypatch):
    """The product path (rowquant, the ring of RING_BACKEND, all_gather)
    against the JAX one under the same backend, and against the psum of
    the ranks' products."""
    monkeypatch.setattr(coll, "RING_BACKEND", backend)
    monkeypatch.setattr(jcoll, "RING_BACKEND", backend)
    monkeypatch.setattr(jops, "LINEAR_BACKEND", "pallas")
    B, T, K, N = 2, 4, 32 * tp, 32 * tp
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    wq, sw = map(np.array, jnumerics.quantize_channelwise(jnp.asarray(w), axis=0))

    @functools.partial(jax.shard_map, mesh=_jmesh(tp),
                       in_specs=(P(None, None, "model"), P("model", None), P()),
                       out_specs=P(), check_vma=False)
    def f(x, wq, sw):
        return jcoll.dynamic_qlinear_collective(x, wq, sw, "model", tp, out_dtype=jnp.float32,
                                                interpret=True)

    want = np.asarray(f(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw)))
    mesh, wq_nk = _mesh(tp), np.ascontiguousarray(wq.T)
    run = lambda fn: mesh.run(lambda r: fn(_split_k(x, tp, r), _split_k(wq_nk, tp, r),
                                           torch.from_numpy(sw)))
    outs = run(lambda xr, wr, s: coll.dynamic_qlinear_collective(xr, wr, s, mesh.group))
    for o in outs:  # every rank holds the whole [B, T, N]
        assert o.shape == (B, T, N)
        np.testing.assert_allclose(o.numpy(), want, rtol=1e-6, atol=1e-6)
    psum = run(lambda xr, wr, s: mesh.group.psum(ops.dynamic_qlinear(xr, wr, s,
                                                                     out_dtype=torch.float32)))
    np.testing.assert_allclose(outs[0].numpy(), psum[0].numpy(), rtol=1e-5, atol=1e-5)


def test_ring_backend_resolves_auto_to_ppermute(monkeypatch):
    monkeypatch.setattr(coll, "RING_BACKEND", "auto")
    assert coll.resolve_ring_backend() == "ppermute"
    monkeypatch.setattr(coll, "RING_BACKEND", "dma")
    assert coll.resolve_ring_backend() == "dma"


def test_collective_scope_not_ported_raises():
    mesh = _mesh(2)
    x, wq, sw = torch.zeros(1, 4, 16), torch.zeros(32, 16, dtype=torch.int8), torch.ones(32)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        mesh.run(lambda r: coll.dynamic_qlinear_collective(x, wq, sw, mesh.group,
                                                           scatter_tokens=True))
    with pytest.raises(NotImplementedError):
        coll.weight_only_qlinear_collective(x, wq, sw, mesh.group)


@pytest.mark.parametrize("tp", [2, 4])
def test_group_collectives(tp):
    mesh = _mesh(tp)
    g = mesh.group

    def body(r):
        x = torch.arange(3, dtype=torch.float32) + 10 * r
        return (g.axis_index(), g.psum(x), g.all_gather(x, axis=0, tiled=True),
                g.all_gather(x, axis=0), g.ppermute(x, [(i, (i + 1) % tp) for i in range(tp)]),
                g.ppermute(x, [(0, tp - 1)]))

    xs = [torch.arange(3, dtype=torch.float32) + 10 * r for r in range(tp)]
    for r, (idx, ps, tiled, stacked, ring, one) in enumerate(mesh.run(body)):
        assert idx == r
        want = xs[0]
        for t in xs[1:]:
            want = want + t  # rank order
        assert torch.equal(ps, want)
        assert torch.equal(tiled, torch.cat(xs))
        assert torch.equal(stacked, torch.stack(xs))
        assert torch.equal(ring, xs[(r - 1) % tp])
        assert torch.equal(one, xs[0] if r == tp - 1 else torch.zeros(3))


def test_psum_adds_in_rank_order():
    """f32 addition is not associative: 1e8 + 1 - 1e8 in rank order is 0,
    and every rank gets that same value."""
    mesh = _mesh(3)
    vals = [1e8, 1.0, -1e8]
    out = mesh.run(lambda r: mesh.group.psum(torch.tensor([vals[r]], dtype=torch.float32)))
    assert all(o.item() == 0.0 for o in out)


def test_rank_that_raises_aborts_the_rendezvous():
    """A rank that raises before its collective ends ``run`` with its error;
    the ranks waiting in the collective raise too instead of hanging, and
    the mesh serves the next run."""
    mesh = _mesh(4)
    g = mesh.group
    entered = threading.Event()

    def body(r):
        if r == 2:
            entered.wait(5)
            raise ValueError("rank 2 failed")
        entered.set()
        return g.psum(torch.ones(1))

    with pytest.raises(ValueError, match="rank 2 failed"):
        mesh.run(body)
    assert [o.item() for o in mesh.run(lambda r: g.psum(torch.ones(1)))] == [4.0] * 4


def test_mismatched_collectives_raise():
    mesh = _mesh(2)
    g = mesh.group
    with pytest.raises(RuntimeError, match="different collectives"):
        mesh.run(lambda r: g.psum(torch.ones(1)) if r == 0
                 else g.all_gather(torch.ones(1), tiled=True))
    with pytest.raises(RuntimeError, match="outside"):
        g.psum(torch.ones(1))


def test_group_stress_more_ranks_than_cores():
    """More rank threads than cores, a thread switch forced every
    microsecond: 200 rounds of psum, all_gather and ppermute each give
    exactly the rank-order results (a lost or reordered operand would
    not)."""
    import os
    import sys

    tp = 2 * (os.cpu_count() or 1) + 1
    mesh = make_mesh(MeshConfig(tp=tp), ["cpu"] * tp)
    g = mesh.group
    perm = [(i, (i + 1) % tp) for i in range(tp)]

    def body(r):
        for i in range(200):
            x = torch.tensor([float(r + i)])
            assert g.psum(x).item() == sum(range(tp)) + tp * i
            assert g.all_gather(x, tiled=True).tolist() == [float(k + i) for k in range(tp)]
            assert g.ppermute(x, perm).item() == float((r - 1) % tp + i)
        return r

    saved = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        assert mesh.run(body) == list(range(tp))
    finally:
        sys.setswitchinterval(saved)
