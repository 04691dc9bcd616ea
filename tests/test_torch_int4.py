"""The port's int4 weights against the JAX package's: the int4 helpers,
``weight_only_int4_matmul`` (split, legacy) and ``w4a8_matmul`` (two_level,
group), and 2-layer models in modes ``weight_only_int4`` and
``dynamic_int4`` through greedy decoding and the engine.

The wrappers take their plain versions on the CPU. The JAX side runs as
``tests/test_int4.py`` and ``tests/test_w4a8.py`` run it: the Pallas kernels
in interpret mode, and the JAX model with ``ops.LINEAR_BACKEND`` set to
"pallas" where its default would take the XLA formulation.

Tolerances:
* Quantizer codes and scales, packing, the [N, K/2] layout: exact.
* wo4 (split, legacy): ``ops.weight_only_int4_tolerance``. Every product
  is the same in the two versions and only the order of the f32 sums
  differs, plus one ulp of the output type. Against the XLA formulation,
  which rounds each weight ``q * s`` to bf16 first, the same bound plus
  2**-8 * sum_k |x * q * s|.
* w4a8: two_level equals the JAX kernel where there is no bias. With a
  bias, XLA:CPU contracts the bias add into an FMA, one rounding fewer: the
  two differ by at most one f32 ulp of the term before the bias, plus one
  ulp of the output. group: XLA:CPU contracts each group's
  ``acc + p * s`` into an FMA, so the two differ by at most one f32 ulp of
  each product and of each partial sum (``_fma_tol`` below). The plain versions'
  integer parts (requantized codes, int32 sums) are exact by construction.
* Models: logits within LOGIT_ATOL of the JAX model that computes the same
  function (as ``test_torch_model.py``); the 16 greedy tokens and the
  engines' tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu import ops as jops
from protoquant_tpu.core import numerics as jnum
from protoquant_tpu.core.qtensor import QTensor as JQTensor
from protoquant_tpu.core.qtensor import QTensor4 as JQTensor4
from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models import greedy_generate as j_greedy
from protoquant_tpu.nn.convert import quantize_params
from protoquant_tpu.nn.qlinear import pick_int4_group as j_pick_int4_group
from protoquant_tpu.ops.w4a8_matmul import w4a8_matmul as j_w4a8
from protoquant_tpu.ops.wo4_matmul import weight_only_int4_matmul as j_wo4
from protoquant_tpu.ops.xla_backend import weight_only_int4_matmul_xla as j_wo4_xla
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu.utils.config import QuantConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig, QTensor4,
                                  greedy_generate, ops, params_from_numpy)
from protoquant_tpu_torch.core import numerics
from protoquant_tpu_torch.nn import QLinear, pick_int4_group, quantize_model
from test_torch_model import DIMS

LOGIT_ATOL = 1e-3
GROUP = 32
# intermediate 96: the down projection's K holds 3 groups of 32
DIMS4 = dict(DIMS, intermediate_size=96)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- the helpers -----------------------------------------------------------------


def _weights(k, n, seed, group):
    """A [K, N] weight with a zero group and exact .5 ties: column 0's
    first group is 0; column 1's first 32 values are 7 and halves, so its
    first group's amax step is 1."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:group, 0] = 0.0
    ties = np.array([7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5, 6.5], np.float32)
    w[:GROUP, 1] = np.resize(ties, GROUP)
    return w


@pytest.mark.parametrize("clip", ["mse", "amax"])
@pytest.mark.parametrize("k,n,group", [(64, 40, 32), (96, 24, 32), (256, 48, 128),
                                       (512, 16, 64)])
def test_quantize_groupwise_int4_bitwise(k, n, group, clip):
    w = _weights(k, n, k + n, group)
    qj, sj = jnum.quantize_groupwise_int4(jnp.asarray(w), group, clip)
    qt, st = numerics.quantize_groupwise_int4(torch.from_numpy(w.T.copy()), group, clip)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj).T)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).T)
    assert st[0, 0] == np.float32(1e-12) and (qt[0, :group] == 0).all()  # the zero group
    if clip == "amax":
        np.testing.assert_array_equal(qt[1, :10].numpy(), [7, 0, 2, 2, 0, -2, -2, 4, -4, 6])


def test_pack_unpack_and_the_nk_layout_pin():
    """The port's buffer [N, K/2] is the JAX package's [K/2, N], transposed,
    byte for byte; unpacking it gives the JAX unpack, transposed."""
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (192, 40)).astype(np.int8)  # JAX layout [K, N]
    for group in (None, 32, 64, 192):
        pj = np.asarray(jnum.pack_int4(jnp.asarray(q), group))
        pt = numerics.pack_int4(torch.from_numpy(q.T.copy()), group)
        assert pt.shape == (40, 96) and pt.dtype == torch.int8
        np.testing.assert_array_equal(pt.numpy(), pj.T)
        np.testing.assert_array_equal(numerics.unpack_int4(pt, group).numpy(),
                                      np.asarray(jnum.unpack_int4(jnp.asarray(pj), group)).T)
    # group-local order: byte j of group r holds k = r*g + j low, + g/2 high
    qt = torch.from_numpy(q.T.copy())
    byte = int(numerics.pack_int4(qt, 64)[5, 64 // 2 + 3]) & 0xFF
    assert (byte & 0xF) == (int(q[64 + 3, 5]) & 0xF)
    assert (byte >> 4) == (int(q[64 + 32 + 3, 5]) & 0xF)


def test_qtensor4_matches_jax_and_rejects_native():
    w = _weights(256, 48, 3, 64)
    qj = JQTensor4.quantize(jnp.asarray(w), group=64)
    qt = QTensor4.quantize(torch.from_numpy(w.T.copy()), group=64)
    assert qt.shape == (48, 256) and qt.group == 64 and qt.orig_k == 256
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qj.data).T)
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale).T)
    np.testing.assert_array_equal(qt.dequantize().numpy(), np.asarray(qj.dequantize()).T)
    assert qt.nbytes() == qj.nbytes() == 48 * 128 + 48 * 4 * 4
    with pytest.raises(ValueError, match="native"):
        QTensor4.quantize(torch.from_numpy(w.T.copy()), group=64, storage="native")


@pytest.mark.parametrize("k", [64, 96, 4096, 11008, 200, 15])
def test_pick_int4_group_matches_jax(k):
    try:
        want = j_pick_int4_group(k, 128)
    except ValueError:
        with pytest.raises(ValueError):
            pick_int4_group(k, 128)
        return
    assert pick_int4_group(k, 128) == want
    assert pick_int4_group(4096) == pick_int4_group(11008) == 128


# -- wo4 -------------------------------------------------------------------------

SHAPES = [(4, 256, 128, 128), (5, 96, 72, 32), (13, 320, 130, 64), (1, 128, 48, 32)]


def _int4_operands(m, k, n, group, seed, bias):
    """x [M, K], the JAX-layout packed [K/2, N] and scales [K/g, N], bias."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    q, s = jnum.quantize_groupwise_int4(jnp.asarray(w), group)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return x, np.asarray(jnum.pack_int4(q, group)), np.asarray(s), b


def _within(got, want, tol):
    diff = (got.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
    assert (diff <= tol).all(), float((diff - tol).max())


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("formulation", ["split", "legacy"])
@pytest.mark.parametrize("m,k,n,group", SHAPES)
def test_wo4_vs_pallas_interpret(m, k, n, group, formulation, with_bias, out):
    x, p, s, b = _int4_operands(m, k, n, group, m + n, with_bias)
    xj = jnp.asarray(x, jnp.bfloat16 if formulation == "split" else jnp.float32)
    want = _np(j_wo4(xj, jnp.asarray(p), jnp.asarray(s), group,
                     None if b is None else jnp.asarray(b), out_dtype=getattr(jnp, out),
                     interpret=True, formulation=formulation))
    xt = torch.from_numpy(_np(xj))
    got = ops.weight_only_int4_matmul(xt.to(torch.bfloat16) if formulation == "split" else xt,
                                      _t(p.T), _t(s.T), group, _t(b),
                                      out_dtype=getattr(torch, out), formulation=formulation)
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    _within(got, want, ops.weight_only_int4_tolerance(xt, _t(p.T), _t(s.T), group, got,
                                                      formulation))


@pytest.mark.parametrize("m,k,n,group", [(3, 96, 40, 32), (8, 256, 64, 128)])
def test_weight_only_int4_linear_ref_is_legacy(m, k, n, group):
    """The contract's reference (dequantize to f32, one f32 product) against
    the JAX package's, and the legacy formulation against it."""
    x, p, s, b = _int4_operands(m, k, n, group, 5 * m, True)
    want = np.asarray(jnum.weight_only_int4_linear_ref(jnp.asarray(x), jnp.asarray(p),
                                                       jnp.asarray(s), group, jnp.asarray(b)))
    xt = torch.from_numpy(x)
    mine = numerics.weight_only_int4_linear_ref(xt, _t(p.T), _t(s.T), group, _t(b))
    tol = ops.weight_only_int4_tolerance(xt, _t(p.T), _t(s.T), group, mine, "legacy")
    _within(mine, want, tol)
    _within(ops.weight_only_int4_matmul(xt, _t(p.T), _t(s.T), group, _t(b),
                                        formulation="legacy"), mine.numpy(), tol)


@pytest.mark.parametrize("m,k,n,group", [(2, 64, 96, 32), (33, 192, 72, 64)])
def test_wo4_split_vs_xla_formulation(m, k, n, group):
    """The JAX model's default (XLA) rounds each weight q * s to bf16: the
    port's split kernel is within that rounding of it."""
    x, p, s, b = _int4_operands(m, k, n, group, 7 * m, True)
    want = np.asarray(j_wo4_xla(jnp.asarray(x), jnp.asarray(p), jnp.asarray(s), group,
                                jnp.asarray(b)))
    xt = torch.from_numpy(x)
    got = ops.weight_only_int4_matmul(xt, _t(p.T), _t(s.T), group, _t(b))
    assert got.dtype == torch.float32  # out_dtype defaults to x's
    tol = ops.weight_only_int4_tolerance(xt, _t(p.T), _t(s.T), group, got, w_rel=2.0**-8)
    _within(got, want, tol)


def test_wo4_formulation_and_dispatch():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 64)
    p = torch.randint(-128, 128, (40, 32), dtype=torch.int8)
    s = torch.rand(40, 2)
    y = ops.weight_only_int4_matmul(x, p, s, 32)
    assert y.shape == (2, 3, 40) and y.dtype == torch.float32
    assert not any(ops.launch_counts().values())  # plain versions on the CPU
    with pytest.raises(ValueError, match="formulation"):
        ops.weight_only_int4_matmul(x, p, s, 32, formulation="fused")
    with pytest.raises(ValueError, match="formulation"):
        ops.w4a8_matmul(torch.zeros(2, 64, dtype=torch.int8), torch.ones(2), p, s, 32,
                        formulation="split")


# -- w4a8 ------------------------------------------------------------------------


def _fma_tol(xq, sx, p_nk, s_nk, group, y, bias):
    """One f32 ulp of each product f32(p_g) * s[n, g] and of each partial
    sum over the groups (at most the running sum of |products|), carried
    through the s_x multiply; then one ulp of the term before the bias and
    one of the output."""
    k = xq.shape[-1]
    ng = k // group
    q = numerics.unpack_int4(p_nk, group).double().reshape(-1, ng, group)
    pg = torch.einsum("mgk,ngk->mgn", xq.double().reshape(-1, ng, group), q)
    mag = (pg.abs() * s_nk.double().t()[None]).sum(1) * sx.double()[:, None]
    pre = mag.float()
    tol = (ng + 1) * 2.0**-23 * pre
    if bias is not None:
        tol = tol + torch.finfo(torch.float32).eps * pre
    _, exp = torch.frexp(y.float().abs() + tol)
    return tol + torch.finfo(y.dtype).eps * torch.pow(2.0, (exp - 1).float())


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("formulation", ["two_level", "group"])
@pytest.mark.parametrize("m,k,n,group", SHAPES + [(33, 384, 200, 128)])
def test_w4a8_vs_pallas_interpret(m, k, n, group, formulation, with_bias, out):
    x, p, s, b = _int4_operands(m, k, n, group, m + n, with_bias)
    xq, sx = jnum.quantize_rowwise(jnp.asarray(x))
    want = _np(j_w4a8(xq, sx, jnp.asarray(p), jnp.asarray(s), group=group,
                      bias=None if b is None else jnp.asarray(b),
                      out_dtype=getattr(jnp, out), formulation=formulation, interpret=True))
    xqt, sxt = _t(xq), _t(sx)
    got = ops.w4a8_matmul(xqt, sxt, _t(p.T), _t(s.T), group, _t(b),
                          out_dtype=getattr(torch, out), formulation=formulation)
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    if formulation == "two_level" and b is None:
        np.testing.assert_array_equal(got.float().numpy(), want)  # exact
    elif formulation == "two_level":
        pre = ops.w4a8_matmul(xqt, sxt, _t(p.T), _t(s.T), group, None, torch.float32,
                              formulation).abs()
        _, exp = torch.frexp(got.float().abs() + pre)
        tol = (torch.finfo(torch.float32).eps * pre
               + torch.finfo(got.dtype).eps * torch.pow(2.0, (exp - 1).float()))
        _within(got, want, tol)
    else:
        _within(got, want, _fma_tol(xqt, sxt, _t(p.T), _t(s.T), group, got, b))


@pytest.mark.parametrize("m,k,n,group", [(8, 256, 128, 128), (5, 96, 72, 32)])
def test_w4a8_group_vs_dynamic_int4_linear_ref(m, k, n, group):
    """group against the contract (a sum over the groups in its own order):
    the same products, each partial sum one ulp apart at most."""
    x, p, s, b = _int4_operands(m, k, n, group, 3 * m, True)
    want = np.asarray(jnum.dynamic_int4_linear_ref(jnp.asarray(x), jnp.asarray(p),
                                                   jnp.asarray(s), group, jnp.asarray(b)))
    xt = torch.from_numpy(x)
    mine = numerics.dynamic_int4_linear_ref(xt, _t(p.T), _t(s.T), group, _t(b))
    xq, sx = ops.rowquant(xt)
    got = ops.w4a8_matmul(xq, sx, _t(p.T), _t(s.T), group, _t(b), torch.float32, "group")
    tol = _fma_tol(xq, sx, _t(p.T), _t(s.T), group, got, b)
    _within(got, want, tol)
    _within(got, mine.numpy(), tol)


def test_two_level_scales_divide_by_a_tensor():
    """r16 = s * (16 / scol) with a true division, bit for bit as JAX
    computes it."""
    s = torch.from_numpy(np.random.default_rng(4).uniform(1e-4, 3e-2, (512, 6)).astype(np.float32))
    r16, scol = ops.two_level_scales(s)
    sj = jnp.asarray(s.numpy().T)
    scol_j = jnp.max(sj, axis=0, keepdims=True)
    r16_j = sj * jnp.where(scol_j > 0, 16.0 / scol_j, 0.0)
    np.testing.assert_array_equal(scol.numpy(), np.asarray(scol_j)[0])
    np.testing.assert_array_equal(r16.numpy(), np.asarray(r16_j).T)
    # each column's largest group ratio is 16 to within the two roundings
    assert ((r16.amax(1) - 16).abs() <= 16 * 2.0**-22).all()


# -- models ---------------------------------------------------------------------


def to_numpy_tree(tree):
    """flax params -> nested dicts of numpy arrays; a QTensor or QTensor4 as
    {data, scale}."""
    if isinstance(tree, (JQTensor, JQTensor4)):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale)}
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def fp_params():
    fp = JLlamaModel(JModelConfig(**DIMS4), mode="fp", dtype=jnp.float32)
    return fp.init(jax.random.PRNGKey(21), jnp.zeros((1, 4), jnp.int32))


_PAIRS = {}


def _pair(mode, fp_params):
    """An fp JAX model's params quantized with QuantConfig(mode, int4_group=32),
    carried into the port's LlamaModel(mode, int4_group=32)."""
    if mode not in _PAIRS:
        params = quantize_params(fp_params, QuantConfig(mode=mode, int4_group=GROUP))
        jm = JLlamaModel(JModelConfig(**DIMS4), mode=mode, dtype=jnp.float32,
                         int4_group=GROUP)
        tm = LlamaModel(ModelConfig(**DIMS4), mode=mode, dtype=torch.float32, device="cpu",
                        int4_group=GROUP)
        tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
        _PAIRS[mode] = mode, jm, params, tm
    return _PAIRS[mode]


@pytest.fixture(scope="module", params=["dynamic_int4", "weight_only_int4"])
def int4_pair(request, fp_params):
    return _pair(request.param, fp_params)


@pytest.fixture
def pallas_linears(monkeypatch):
    """The JAX model's linears through the Pallas kernels (interpret mode):
    for weight_only_int4 the split kernel, what the port computes."""
    monkeypatch.setattr(jops, "LINEAR_BACKEND", "pallas")


def _tokens(b, t, seed):
    return np.random.default_rng(seed).integers(1, DIMS4["vocab_size"], (b, t)).astype(np.int32)


def test_from_jax_carries_int4_params(int4_pair, fp_params):
    mode, _, params, tm = int4_pair
    for path in (("layers_1", "mlp", "down_proj"), ("layers_0", "self_attn", "k_proj"),
                 ("lm_head",)):
        node = params["params"]
        for key in path:
            node = node[key]
        q = node["qkernel"]
        lin = tm.get_submodule(".".join(path))
        assert lin.mode == mode and lin.group == q.group == GROUP
        np.testing.assert_array_equal(lin.qweight.numpy(), np.asarray(q.data).T)
        np.testing.assert_array_equal(lin.qscale.numpy(), np.asarray(q.scale).T)
        if mode == "dynamic_int4":  # remade from the loaded scales
            r16, scol = ops.two_level_scales(lin.qscale)
            assert torch.equal(lin.r16, r16) and torch.equal(lin.scol, scol)
    assert tm.layers_1.mlp.down_proj.qscale.shape == (DIMS4["hidden_size"], 3)
    # quantize_model of the fp port model gives the same int4 weights
    fm = LlamaModel(ModelConfig(**DIMS4), mode="fp", dtype=torch.float32, device="cpu")
    fm.load_state_dict(params_from_numpy(to_numpy_tree(fp_params)), strict=True)
    quantize_model(fm, mode=mode, int4_group=GROUP)
    for (name, a), (_, b) in zip(fm.state_dict().items(), tm.state_dict().items()):
        assert torch.equal(a, b), name


def test_int4_logits_close(int4_pair, pallas_linears):
    _, jm, params, tm = int4_pair
    tokens = _tokens(2, 12, seed=8)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_weight_only_int4_logits_vs_xla_default(fp_params):
    """Against the JAX model's default formulation, which rounds every
    weight q * s to bf16 (relative 2**-8) before the product. Each of the 9
    linears on a token's path (q/k/v, o, gate/up, down per layer, then
    lm_head) moves its output by at most 2**-8 of its sum_k |x * q * s|; the
    limit is that much per linear, in units of the lm_head's
    sum_k |h * q * s|, the largest the logits see."""
    _, jm, params, tm = _pair("weight_only_int4", fp_params)
    assert jops.LINEAR_BACKEND == "auto"
    tokens = _tokens(2, 12, seed=8)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    hidden = {}
    handle = tm.lm_head.register_forward_pre_hook(lambda mod, args: hidden.update(h=args[0]))
    got = tm(torch.from_numpy(tokens))
    handle.remove()
    lm = tm.lm_head
    mag = (hidden["h"].to(torch.bfloat16).float().abs()
           @ numerics.dequantize_int4(lm.qweight, lm.qscale, lm.group).abs().t())
    limit = 9 * 2.0**-8 * mag.max().item()
    diff = np.abs(got.numpy() - want).max()
    assert 0 < diff <= limit, (diff, limit)


def test_int4_greedy_tokens_identical_16_steps(int4_pair, pallas_linears):
    _, jm, params, tm = int4_pair
    prompt = _tokens(2, 6, seed=9)
    want = np.asarray(j_greedy(jm, params, jnp.asarray(prompt), 16, 32, kv_dtype=jnp.int8))
    got = greedy_generate(tm, torch.from_numpy(prompt), 16, 32, kv_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)


# -- engines -----------------------------------------------------------------------

PS = 8
SYSTEM = list(map(int, np.random.default_rng(40).integers(1, DIMS4["vocab_size"], 16)))


def _prompts():
    rng = np.random.default_rng(41)
    return [SYSTEM + list(map(int, rng.integers(1, DIMS4["vocab_size"], n)))
            for n in (5, 12, 3, 20)]


def _serve(engine, prompts):
    """Request 0 alone until its prefill ends (its prompt is then
    published), then the others."""
    rids = [engine.add_request(prompts[0])]
    while engine.prefilling or engine.waiting:
        engine.step()
    rids += [engine.add_request(p) for p in prompts[1:]]
    out = engine.run()
    return [out[r] for r in rids], engine.metrics()


def test_int4_engine_matches_jax_engine(int4_pair, pallas_linears):
    """dynamic_int4 on the dense cache; weight_only_int4 on the paged pool
    with the prefix cache. Batched equals sequential, and equals the JAX
    engine's greedy outputs."""
    mode, jm, params, tm = int4_pair
    paged = mode == "weight_only_int4"
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=16, max_new_tokens=5)
    if paged:
        kw.update(page_size=PS, prefix_cache=True)
    layout = dict(kv_layout="paged") if paged else {}
    want, jmet = _serve(JEngine(jm, params, JEngineConfig(**kw), kv_dtype=jnp.int8, **layout),
                        _prompts())
    e = Engine(tm, EngineConfig(**kw), **layout)
    got, m = _serve(e, _prompts())
    assert got == want and all(len(o) == 5 for o in got)
    for p, out in zip(_prompts(), got):
        assert greedy_generate(tm, torch.tensor([p]), 5, 64, kv_dtype="int8")[0].tolist() == out
    if paged:
        assert m["prefix_hit_tokens"] == jmet["prefix_hit_tokens"] == 16 * 3
        assert not e.prefix.refs
        assert m["kv_pages_free"] + m["prefix_reusable_pages"] == m["kv_pages_total"]


def test_int4_launches_per_block(monkeypatch):
    """weight_only_int4 sends x itself to every projection: no rowquant.
    dynamic_int4 quantizes each block input once: one rowquant for q/k/v,
    one for gate/up, one each for o_proj, down_proj and lm_head."""
    cfg = ModelConfig(**DIMS4)
    L = cfg.num_hidden_layers
    for mode, want in (("weight_only_int4", {"weight_only_int4_matmul": 7 * L + 1}),
                       ("dynamic_int4", {"rowquant": 4 * L + 1, "w4a8_matmul": 7 * L + 1})):
        m = LlamaModel(cfg, mode=mode, dtype=torch.float32, device="cpu",
                       int4_group=GROUP).init_random_(0)
        calls = []
        for name in ("weight_only_int4_matmul", "w4a8_matmul", "rowquant", "qmatmul",
                     "weight_only_matmul"):
            fn = getattr(ops, name)
            monkeypatch.setattr(ops, name,
                                lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
        m(torch.tensor([[1, 2, 3]]))
        assert {n: calls.count(n) for n in set(calls)} == want, mode
        monkeypatch.undo()


def test_resolve_w4a8_formulation_follows_the_env():
    import os
    import subprocess
    import sys

    default = os.environ.get("W4A8_FORMULATION", "two_level")
    assert ops.resolve_w4a8_formulation() == jops.resolve_w4a8_formulation() == default
    code = "from protoquant_tpu_torch import ops; print(ops.resolve_w4a8_formulation())"
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, W4A8_FORMULATION="group"),
                         capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "group"
