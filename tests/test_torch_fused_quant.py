"""The port's producer-fused quantization and ``dequant`` against the JAX
package's: ``rms_norm_quant`` and ``swiglu_quant`` (plain versions against
the Pallas kernels in interpret mode), ``dequant``, and a ``dynamic`` model
under ``FUSED_QUANT=on`` through scoring, greedy decoding and the engine.

The wrappers take their plain versions on the CPU. The JAX side runs as
``tests/test_ops.py`` runs it, with ``protoquant_tpu.ops.FUSED_QUANT``
monkeypatched to "on" for its model (it reads the knob at trace time).

Tolerances, what the JAX package demands of its own kernels against the
module composition (``protoquant_tpu/ops/fused_quant.py``,
``tests/test_ops.py``): the norm's codes equal or +-1, in under 1e-3 of the
elements, scales within rtol 1e-6 (the two sum x^2 in other orders); the
gate's codes equal or +-1, in under 5 %, scales within rtol 1e-2 (SiLU and
GELU are spelled differently in the two frameworks, an ulp apart, which a
bf16 rounding can turn into one bf16 ulp). ``dequant``: exact. The fused
port model equals the unfused one bit for bit (the plain versions are the
unfused composition), and matches the fused JAX model as
``test_torch_model.py`` matches the unfused one: logits within LOGIT_ATOL,
greedy and engine tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu import ops as jops
from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models import greedy_generate as j_greedy
from protoquant_tpu.ops.fused_quant import rms_norm_quant as j_rms_norm_quant
from protoquant_tpu.ops.fused_quant import swiglu_quant as j_swiglu_quant
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import (Engine, EngineConfig, LlamaModel, ModelConfig,
                                  greedy_generate, ops, params_from_numpy)
from test_torch_model import DIMS, LOGIT_ATOL, to_numpy_tree

# A config of its own (vocab 72): the JAX engine and greedy_generate jit
# with the model as a static argument, so an equal model traced unfused
# elsewhere in the process would be reused here.
DIMSF = dict(DIMS, vocab_size=72)
NORMS = ("input_layernorm", "post_attention_layernorm")
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
JAX_DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}


def _codes_close(q, q_ref, share):
    """Codes equal or one step apart, in under ``share`` of the elements."""
    dq = np.abs(np.asarray(q, np.int32) - np.asarray(q_ref, np.int32))
    assert dq.max() <= 1, dq.max()
    assert (dq != 0).mean() < share, (dq != 0).mean()


def _pair(x):
    """One numpy array as the same values in JAX and in torch (bf16 stays
    bf16 in both)."""
    j = jnp.asarray(x)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DTYPES[str(j.dtype)])


# -- the ops ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rms_norm_quant_ref_vs_jax(dtype):
    rng = np.random.default_rng(3)
    eps = 1e-5
    xj, xt = _pair((rng.standard_normal((2, 37, 256)) * 2).astype(JAX_DTYPES[dtype]))
    w = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    qj, sj = j_rms_norm_quant(xj, jnp.asarray(w), eps=eps, interpret=True,
                              cast_dtype=JAX_DTYPES[dtype])
    qt, st = ops.rms_norm_quant_ref(xt, torch.from_numpy(w), eps=eps,
                                    cast_dtype=TORCH_DTYPES[dtype])
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == (2, 37)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    _codes_close(qt.numpy(), qj, 1e-3)
    # the wrapper takes the plain version for a CPU tensor
    qw, sw = ops.rms_norm_quant(xt, torch.from_numpy(w), eps=eps,
                                cast_dtype=TORCH_DTYPES[dtype])
    assert torch.equal(qw, qt) and torch.equal(sw, st)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_quant_ref_vs_jax(act):
    rng = np.random.default_rng(4)
    gj, gt = _pair((rng.standard_normal((2, 21, 384)) * 2).astype(jnp.bfloat16))
    uj, ut = _pair((rng.standard_normal((2, 21, 384)) * 2).astype(jnp.bfloat16))
    qj, sj = j_swiglu_quant(gj, uj, act=act, interpret=True)
    qt, st = ops.swiglu_quant_ref(gt, ut, act=act)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-2)
    _codes_close(qt.numpy(), qj, 0.05)
    qw, sw = ops.swiglu_quant(gt, ut, act=act)
    assert torch.equal(qw, qt) and torch.equal(sw, st)


def test_swiglu_quant_rejects_unknown_activation():
    g = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="activation"):
        ops.swiglu_quant(g, g, act="relu")


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_dequant_vs_jax_exact(axis, out_dtype):
    rng = np.random.default_rng(10 + axis)
    q = rng.integers(-127, 128, (40, 200)).astype(np.int8)  # ragged vs the 512 blocks
    s = rng.uniform(1e-3, 0.05, q.shape[1] if axis == 0 else q.shape[0]).astype(np.float32)
    want = jops.dequant(jnp.asarray(q), jnp.asarray(s), axis=axis,
                        out_dtype=JAX_DTYPES[out_dtype])
    got = ops.dequant(torch.from_numpy(q), torch.from_numpy(s), axis,
                      out_dtype=TORCH_DTYPES[out_dtype])
    assert got.dtype == TORCH_DTYPES[out_dtype] and got.shape == q.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_dequant_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="2D"):
        ops.dequant(torch.zeros(2, 3, 4, dtype=torch.int8), torch.ones(4), 0)
    with pytest.raises(ValueError, match="scales"):
        ops.dequant(torch.zeros(3, 4, dtype=torch.int8), torch.ones(3), 0)


# -- the model -------------------------------------------------------------------


def _norm_weights(seed):
    """Non-unit norm weights for every norm of a DIMSF model: a fault in the
    kernel's weight read would pass unseen with weights of 1."""
    rng = np.random.default_rng(seed)
    names = [(f"layers_{i}", n) for i in range(DIMSF["num_hidden_layers"]) for n in NORMS]
    names.append(("norm",))
    return {path: rng.uniform(0.5, 1.5, DIMSF["hidden_size"]).astype(np.float32)
            for path in names}


def _with_norms(tree, weights, as_array):
    """A copy of the params tree with each norm's weight replaced."""
    out = dict(tree)
    inner = out["params"] = dict(out["params"])
    for path, w in weights.items():
        node = inner
        for key in path[:-1]:
            node[key] = dict(node[key])
            node = node[key]
        node[path[-1]] = dict(node[path[-1]], weight=as_array(w))
    return out


@pytest.fixture(scope="module")
def fused_pair():
    """The JAX model and the port's, dynamic, f32, with the same int8
    weights and non-unit norm weights (set in the numpy tree and carried by
    params_from_numpy)."""
    jm = JLlamaModel(JModelConfig(**DIMSF), mode="dynamic", dtype=jnp.float32)
    init = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 4), jnp.int32))
    norms = _norm_weights(5)
    params = _with_norms(init, norms, jnp.asarray)
    tree = _with_norms(to_numpy_tree(init), norms, np.asarray)
    tm = LlamaModel(ModelConfig(**DIMSF), mode="dynamic", dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_numpy(tree), strict=True)
    assert not torch.equal(tm.layers_1.post_attention_layernorm.weight,
                           torch.ones(DIMSF["hidden_size"]))
    return jm, params, tm


@pytest.fixture
def fused_on(monkeypatch):
    """FUSED_QUANT=on in both packages for the test."""
    monkeypatch.setattr(jops, "FUSED_QUANT", "on")
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")


@pytest.fixture
def spy(monkeypatch):
    """Calls of the fused ops by name (the launch counters count CUDA
    launches only)."""
    calls = {"rms_norm_quant": 0, "swiglu_quant": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    return calls


def _prompt(b, t, seed):
    return np.random.default_rng(seed).integers(1, DIMSF["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_model_equals_unfused_bitwise(monkeypatch, spy, dtype):
    """On the CPU the plain versions are the unfused composition, so the
    fused model's logits, cache and greedy tokens equal the unfused ones bit
    for bit; the fused path runs both norms and the gate of every layer
    through the fused ops."""
    m = LlamaModel(ModelConfig(**DIMSF), mode="dynamic", dtype=dtype,
                   device="cpu").init_random_(0)
    g = torch.Generator().manual_seed(1)
    for name, mod in m.named_modules():
        if name.endswith("layernorm") or name == "norm":
            mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
    tokens = torch.from_numpy(_prompt(2, 11, seed=6))
    want = (m(tokens), greedy_generate(m, tokens, 8, 32, kv_dtype="int8"))
    assert spy == {"rms_norm_quant": 0, "swiglu_quant": 0}
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")
    got = (m(tokens), greedy_generate(m, tokens, 8, 32, kv_dtype="int8"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    layers = DIMSF["num_hidden_layers"]
    assert spy["rms_norm_quant"] == 2 * layers * 9  # scoring, prefill, 7 decode steps
    assert spy["swiglu_quant"] == layers * 9


def test_converted_model_takes_the_fused_path(monkeypatch, spy):
    """A model built in fp and converted by quantize_model to "dynamic"
    fuses as one built dynamic: the gate reads the linears' mode."""
    from protoquant_tpu_torch.nn import quantize_model

    m = LlamaModel(ModelConfig(**DIMSF), mode="fp", dtype=torch.float32,
                   device="cpu").init_random_(3)
    tokens = torch.from_numpy(_prompt(2, 5, seed=9))
    quantize_model(m)
    want = m(tokens)
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")
    assert torch.equal(m(tokens), want)
    assert spy == {"rms_norm_quant": 2 * DIMSF["num_hidden_layers"],
                   "swiglu_quant": DIMSF["num_hidden_layers"]}


@pytest.mark.parametrize("mode", ["dynamic_int4", "weight_only"])
def test_fused_ops_only_on_the_dynamic_path(monkeypatch, spy, mode):
    """As in the JAX model, FUSED_QUANT gates mode "dynamic" alone:
    dynamic_int4 keeps its shared rowquant, weight_only reads bf16."""
    dims = dict(DIMSF, intermediate_size=96)
    m = LlamaModel(ModelConfig(**dims), mode=mode, int4_group=32, dtype=torch.float32,
                   device="cpu").init_random_(2)
    tokens = torch.from_numpy(_prompt(2, 7, seed=7))
    want = greedy_generate(m, tokens, 4, 32, kv_dtype="int8")
    monkeypatch.setattr(ops, "FUSED_QUANT", "on")
    assert torch.equal(greedy_generate(m, tokens, 4, 32, kv_dtype="int8"), want)
    assert spy == {"rms_norm_quant": 0, "swiglu_quant": 0}


def test_fused_quant_knob_resolves_as_jax(monkeypatch):
    assert ops.resolve_fused_quant() == jops.resolve_fused_quant()
    for value, on in (("auto", False), ("off", False), ("on", True)):
        monkeypatch.setattr(ops, "FUSED_QUANT", value)
        assert ops.resolve_fused_quant() is on


def test_fused_scoring_logits_close(fused_pair, fused_on, spy, monkeypatch):
    import protoquant_tpu.ops.fused_quant as jfq

    jm, params, tm = fused_pair
    j_calls = []
    monkeypatch.setattr(jfq, "rms_norm_quant",
                        lambda *a, **k: j_calls.append(1) or j_rms_norm_quant(*a, **k))
    tokens = _prompt(2, 12, seed=0)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens)).numpy()
    # both models took the fused path
    assert len(j_calls) == spy["rms_norm_quant"] == 2 * DIMSF["num_hidden_layers"]
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_fused_greedy_tokens_identical(fused_pair, fused_on):
    jm, params, tm = fused_pair
    prompt = _prompt(2, 6, seed=3)
    want = np.asarray(j_greedy(jm, params, jnp.asarray(prompt), 16, 32, kv_dtype=jnp.int8))
    got = greedy_generate(tm, torch.from_numpy(prompt), 16, 32, kv_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_engine_matches_jax_engine(fused_pair, fused_on):
    jm, params, tm = fused_pair
    rng = np.random.default_rng(8)
    prompts = [list(map(int, rng.integers(1, DIMSF["vocab_size"], n))) for n in (3, 20, 9)]
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_chunk=16, max_new_tokens=8)
    je = JEngine(jm, params, JEngineConfig(**kw), kv_dtype=jnp.int8)
    te = Engine(tm, EngineConfig(**kw))
    jr = [je.add_request(p) for p in prompts]
    tr = [te.add_request(p) for p in prompts]
    jout, tout = je.run(), te.run()
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
