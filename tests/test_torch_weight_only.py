"""The port's weight-only int8 linears against the JAX package's.

``weight_only_matmul`` takes its plain version on the CPU. It is held
against the JAX Pallas kernel in interpret mode at bf16 x, and against
``weight_only_matmul_xla`` (what the JAX model runs on every backend under
``LINEAR_BACKEND="auto"``) at f32 x, which both round to bf16 first.
Every product bf16 x int8 is exact in f32, so two correct versions differ
only in the order of the f32 sum: by at most K * 2**-24 * sum_k |x * w| *
s_w, then one ulp of the output type (``ops.weight_only_tolerance``). The
XLA-compiled epilogue may contract the bias add into an FMA; that stays
inside the same ulp.

A 2-layer model in mode ``weight_only`` against the JAX model with
``QuantConfig(mode="weight_only")`` params: logits within LOGIT_ATOL (sum
order, plus RoPE/RMSNorm/SiLU rounding an ulp apart between the frameworks,
which can move an activation across a bf16 rounding boundary), and the
same 16 greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.models import greedy_generate as j_greedy
from protoquant_tpu.nn.convert import quantize_params
from protoquant_tpu.ops.wo_matmul import weight_only_matmul as j_wo
from protoquant_tpu.ops.xla_backend import weight_only_matmul_xla as j_wo_xla
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu.utils.config import QuantConfig
from protoquant_tpu_torch import LlamaModel, ModelConfig, greedy_generate, ops
from protoquant_tpu_torch.models import params_from_numpy
from protoquant_tpu_torch.nn import QLinear, quantize_model
from test_torch_model import DIMS, to_numpy_tree

LOGIT_ATOL = 1e-3


def _operands(m, k, n, with_bias, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)  # JAX layout [K, N]
    sw = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if with_bias else None
    return x, wq, sw, b


def _port(x, wq, sw, b, x_dtype, out_dtype):
    return ops.weight_only_matmul(
        torch.from_numpy(x).to(x_dtype), torch.from_numpy(wq.T.copy()),
        torch.from_numpy(sw), None if b is None else torch.from_numpy(b),
        out_dtype=out_dtype)


def _assert_within_sum_bound(got, want, x, wq, sw):
    tol = ops.weight_only_tolerance(torch.from_numpy(x), torch.from_numpy(wq.T.copy()),
                                    torch.from_numpy(sw), got)
    diff = (got.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
    assert (diff <= tol).all(), float((diff - tol).max())


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(4, 256, 128), (13, 80, 130), (1, 512, 48)])
def test_weight_only_matmul_vs_pallas_interpret(m, k, n, with_bias, out):
    x, wq, sw, b = _operands(m, k, n, with_bias, seed=m + n)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = j_wo(xb, jnp.asarray(wq), jnp.asarray(sw), None if b is None else jnp.asarray(b),
                out_dtype=getattr(jnp, out), interpret=True)
    got = _port(np.array(xb.astype(jnp.float32)), wq, sw, b, torch.bfloat16,
                getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    _assert_within_sum_bound(got, np.asarray(want.astype(jnp.float32)), x, wq, sw)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(2, 64, 96), (33, 200, 72)])
def test_weight_only_matmul_f32_x_vs_xla(m, k, n, with_bias):
    x, wq, sw, b = _operands(m, k, n, with_bias, seed=7 * m)
    want = j_wo_xla(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw),
                    None if b is None else jnp.asarray(b))
    got = _port(x, wq, sw, b, torch.float32, None)
    assert got.dtype == torch.float32  # out_dtype defaults to x's
    _assert_within_sum_bound(got, np.asarray(want), x, wq, sw)


def test_weight_only_matmul_batched_shape_and_cpu_dispatch():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 64)
    wq = torch.randint(-127, 128, (40, 64), dtype=torch.int8)
    y = ops.weight_only_matmul(x, wq, torch.rand(40))
    assert y.shape == (2, 3, 40) and y.dtype == torch.float32
    assert ops.launch_counts()["weight_only_matmul"] == 0  # plain version on the CPU


@pytest.fixture(scope="module")
def wo_pair():
    """A fp JAX model's params quantized with QuantConfig(mode="weight_only"),
    carried into the port's LlamaModel(mode="weight_only")."""
    cfg = JModelConfig(**DIMS)
    fp = JLlamaModel(cfg, mode="fp", dtype=jnp.float32)
    fp_params = fp.init(jax.random.PRNGKey(5), jnp.zeros((1, 4), jnp.int32))
    params = quantize_params(fp_params, QuantConfig(mode="weight_only"))
    jm = JLlamaModel(cfg, mode="weight_only", dtype=jnp.float32)
    tm = LlamaModel(ModelConfig(**DIMS), mode="weight_only", dtype=torch.float32,
                    device="cpu")
    tm.load_state_dict(params_from_numpy(to_numpy_tree(params)), strict=True)
    return jm, params, tm, fp_params


def test_from_jax_carries_weight_only_params(wo_pair):
    _, params, tm, fp_params = wo_pair
    q = params["params"]["layers_1"]["mlp"]["down_proj"]["qkernel"]
    lin = tm.layers_1.mlp.down_proj
    assert lin.mode == "weight_only"
    np.testing.assert_array_equal(lin.qweight.numpy(), np.asarray(q.data).T)
    np.testing.assert_array_equal(lin.qscale.numpy(), np.asarray(q.scale))
    # quantize_model(mode="weight_only") of the fp port model gives the same
    # int8 weights as the JAX conversion
    fm = LlamaModel(ModelConfig(**DIMS), mode="fp", dtype=torch.float32, device="cpu")
    fm.load_state_dict(params_from_numpy(to_numpy_tree(fp_params)), strict=True)
    quantize_model(fm, mode="weight_only")
    assert all(m.mode == "weight_only" for m in fm.modules() if isinstance(m, QLinear))
    for (name, a), (_, b) in zip(fm.state_dict().items(), tm.state_dict().items()):
        assert torch.equal(a, b), name


def test_weight_only_logits_close(wo_pair):
    jm, params, tm, _ = wo_pair
    tokens = np.random.default_rng(8).integers(1, DIMS["vocab_size"], (2, 12)).astype(np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_weight_only_greedy_tokens_identical_16_steps(wo_pair):
    jm, params, tm, _ = wo_pair
    prompt = np.random.default_rng(9).integers(1, DIMS["vocab_size"], (2, 6)).astype(np.int32)
    want = np.asarray(j_greedy(jm, params, jnp.asarray(prompt), 16, 32, kv_dtype=jnp.int8))
    got = greedy_generate(tm, torch.from_numpy(prompt), 16, 32, kv_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)


def test_weight_only_layers_launch_no_rowquant(monkeypatch):
    """Mode weight_only sends x itself to every projection: no shared
    rowquant, no qmatmul."""
    cfg = ModelConfig(**DIMS)
    m = LlamaModel(cfg, mode="weight_only", dtype=torch.float32, device="cpu").init_random_(0)
    calls = []
    for name in ("weight_only_matmul", "rowquant", "qmatmul"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    m(torch.tensor([[1, 2, 3]]))
    assert calls == ["weight_only_matmul"] * (7 * cfg.num_hidden_layers + 1)
