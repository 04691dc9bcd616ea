"""Tensor parallelism in the port against the JAX package's, on the CPU.

The JAX TP model runs under ``shard_map`` over tp of the 8 virtual CPU
devices (``tests/conftest.py``); the port's runs on a mesh of tp ranks on
the CPU, each rank a thread (``make_mesh(devices=["cpu"] * tp)``). Both get
the same global weights: the JAX tree is converted once
(``params_from_numpy``) and split by the port's ``shard_params``. The
config is ``tests/test_parallel.py``'s: 2 layers, D = 64, 8 heads over 4
KV heads.

Limits: fp logits within 1e-5 (the ranks' partial sums are added in
another order); dynamic logits within the port's model tolerance
(``tests/test_torch_model.py``, LOGIT_ATOL); greedy engine tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu import parallel as jpar
from protoquant_tpu.core.qtensor import QTensor as JQTensor
from protoquant_tpu.engine import Engine as JEngine
from protoquant_tpu.engine import EngineConfig as JEngineConfig
from protoquant_tpu.models import LlamaModel as JLlamaModel
from protoquant_tpu.nn import quantize_params
from protoquant_tpu.parallel import collective as jcoll
from protoquant_tpu.utils.config import MeshConfig as JMeshConfig
from protoquant_tpu.utils.config import ModelConfig as JModelConfig
from protoquant_tpu_torch import Engine, EngineConfig, LlamaModel, ModelConfig, ops
from protoquant_tpu_torch.models import init_cache, params_from_numpy
from protoquant_tpu_torch.models.kv_cache import BF16KVCache, Int8KVCache
from protoquant_tpu_torch.parallel import (build_cp_score, build_tp_score, build_tp_step,
                                           init_multihost, make_mesh, make_tp_caches,
                                           params_shard_dims, shard_params, tp_model)
from protoquant_tpu_torch.parallel import collective as coll
from protoquant_tpu_torch.utils import MeshConfig

DIMS = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=64)
LOGIT_ATOL = 1e-3

needs_8dev = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")


def to_numpy_tree(tree):
    """flax params -> nested dicts of numpy arrays, a QTensor as {data, scale}."""
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def params():
    fp = JLlamaModel(JModelConfig(**DIMS), mode="fp", dtype=jnp.float32)
    p = fp.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return {"fp": p, "dynamic": quantize_params(p)}


def _jmesh(tp):
    return jpar.make_mesh(JMeshConfig(dp=1, tp=tp), jax.devices()[:tp])


def _mesh(tp):
    return make_mesh(MeshConfig(tp=tp), ["cpu"] * tp)


def _port_tp(params, mode, tp, collective=False, mesh=None):
    mesh = mesh or _mesh(tp)
    sd = params_from_numpy(to_numpy_tree(params))
    model = tp_model(ModelConfig(**DIMS), mode, mesh, torch.float32, collective=collective)
    return model.load_shards(shard_params(sd, mesh)), mesh


def _tokens(seed, b=2, t=10):
    return np.random.default_rng(seed).integers(0, DIMS["vocab_size"], (b, t)).astype(np.int32)


def _jax_score(params, mode, tp, tokens, collective=False):
    jmesh = _jmesh(tp)
    model = jpar.tp_model(JModelConfig(**DIMS), mode, jmesh, dtype=jnp.float32,
                          collective=collective)
    sparams = jpar.shard_params(params, jmesh)
    with jmesh:
        return np.asarray(jpar.build_tp_score(model, jmesh, params)(sparams,
                                                                     jnp.asarray(tokens)))


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["fp", "dynamic"])
def test_shard_params_match_jax_shards(params, mode, tp):
    """Rank r's state dict is the port's conversion of the shards JAX
    ``shard_params`` (``params_pspecs``) puts on device r: column-parallel
    payloads and scales split on N, row-parallel payloads on K with their
    scales replicated, norms and the embedding replicated."""
    p = params[mode]
    jmesh = _jmesh(tp)
    jsharded = jpar.shard_params(p, jmesh)
    shards = shard_params(params_from_numpy(to_numpy_tree(p)), _mesh(tp))
    for r, dev in enumerate(jax.devices()[:tp]):
        on_r = jax.tree_util.tree_map(
            lambda leaf: next(np.asarray(s.data) for s in leaf.addressable_shards
                              if s.device == dev), jsharded)
        want = params_from_numpy(to_numpy_tree(on_r))
        assert set(want) == set(shards[r])
        for name, t in want.items():
            assert shards[r][name].is_contiguous(), name
            assert torch.equal(shards[r][name], t), name
    dims = params_shard_dims(params_from_numpy(to_numpy_tree(p)))
    w = "weight" if mode == "fp" else "qweight"
    assert dims[f"layers_0.self_attn.q_proj.{w}"] == 0
    assert dims[f"layers_0.mlp.down_proj.{w}"] == 1
    assert dims["embed_tokens.weight"] is None
    if mode == "dynamic":
        assert dims["layers_0.mlp.up_proj.qscale"] == 0
        assert dims["layers_0.self_attn.o_proj.qscale"] is None


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_fp_matches_jax(params, tp):
    tokens = _tokens(1)
    want = _jax_score(params["fp"], "fp", tp, tokens)
    model, mesh = _port_tp(params["fp"], "fp", tp)
    got = build_tp_score(model, mesh)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("collective,backend", [(False, "ppermute"), (True, "ppermute"),
                                                (True, "dma")])
def test_tp_forward_dynamic_matches_jax(params, tp, collective, backend, monkeypatch):
    """Dynamic int8 under TP, the row-parallel reductions by psum or through
    the ring of either backend, on both sides alike (each rank quantizes
    its own K slice, so neither equals the one-device model)."""
    monkeypatch.setattr(coll, "RING_BACKEND", backend)
    monkeypatch.setattr(jcoll, "RING_BACKEND", backend)
    tokens = _tokens(3, t=8)
    want = _jax_score(params["dynamic"], "dynamic", tp, tokens, collective)
    model, mesh = _port_tp(params["dynamic"], "dynamic", tp, collective)
    ops.reset_launch_counts()
    got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) == 1.0
    assert not any(ops.launch_counts().values())  # plain versions on the CPU


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_step_prefill_and_decode_match_one_device(params, tp):
    """fp: the TP step over ``make_tp_caches`` (prefill, then one decode
    token) gives the one-device model's logits."""
    mesh = _mesh(tp)
    model, _ = _port_tp(params["fp"], "fp", tp, mesh=mesh)
    single = LlamaModel(ModelConfig(**DIMS), "fp", torch.float32, device="cpu")
    single.load_state_dict(params_from_numpy(to_numpy_tree(params["fp"])))
    B, T = 2, 6
    caches = make_tp_caches(model.cfg, mesh, B, 32, torch.float32)
    assert caches[0].shards[0].k.shape == (B, 32, DIMS["num_key_value_heads"] // tp, 8)
    ref_caches = init_cache(single.cfg, B, 32, "cpu", torch.float32)
    step = build_tp_step(model, mesh)
    tokens = torch.from_numpy(_tokens(4, B, T))
    pos = torch.arange(T)[None].expand(B, T)
    got, want = step(tokens, pos, caches), single(tokens, pos, ref_caches)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    nxt = got[:, -1].argmax(-1)[:, None]
    got2 = step(nxt, caches[0].lengths.long()[:, None], caches)
    want2 = single(nxt, ref_caches[0].lengths.long()[:, None], ref_caches)
    np.testing.assert_allclose(got2.numpy(), want2.numpy(), rtol=1e-5, atol=1e-5)
    assert all(c.lengths.tolist() == [T + 1] * B for layer in caches for c in layer.shards)


PROMPTS = [[3, 17, 5, 9], [1, 2, 3], [7, 8, 9, 10, 11], [2, 4, 6, 8, 10, 12, 14], [5, 5]]


@needs_8dev
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_tp_engine_matches_jax_mesh_engine(params, tp, kv):
    """The TP engine's greedy tokens equal the JAX mesh engine's
    (``tests/test_parallel.py``), five requests through four slots."""
    kw = dict(max_batch_size=4, max_seq_len=32, prefill_chunk=16, max_new_tokens=6,
              temperature=0.0)
    jmesh = _jmesh(tp)
    jmodel = jpar.tp_model(JModelConfig(**DIMS), "fp", jmesh, dtype=jnp.float32)
    with jmesh:
        je = JEngine(jmodel, jpar.shard_params(params["fp"], jmesh), JEngineConfig(**kw),
                     kv_dtype={"int8": jnp.int8, "bf16": jnp.bfloat16}[kv], mesh=jmesh)
        jr = [je.add_request(p, 6) for p in PROMPTS]
        jouts = je.run()
    model, mesh = _port_tp(params["fp"], "fp", tp)
    te = Engine(model, EngineConfig(**kw),
                kv_dtype={"int8": "int8", "bf16": torch.bfloat16}[kv], mesh=mesh)
    cls = Int8KVCache if kv == "int8" else BF16KVCache
    assert all(isinstance(c, cls) for layer in te.caches for c in layer.shards)
    tr = [te.add_request(p, 6) for p in PROMPTS]
    touts = te.run()
    assert [jouts[r] for r in jr] == [touts[r] for r in tr]


@needs_8dev
def test_tp_engine_dynamic_ring_matches_jax_mesh_engine(params, monkeypatch):
    """The slice's path: ``collective=True`` under the "dma" ring, over the
    int8 cache, against the JAX mesh engine's ring. The JAX side takes its
    "ppermute" tier: its "dma" tier in TPU interpret mode under the engine's
    jit takes minutes on the CPU, and the two tiers are one function (the
    collective tests hold each against the JAX one)."""
    monkeypatch.setattr(coll, "RING_BACKEND", "dma")
    monkeypatch.setattr(jcoll, "RING_BACKEND", "ppermute")
    tp = 2
    # a config of its own: the JAX engine's jit traces are reused for equal models
    dims = dict(DIMS, vocab_size=136)
    fp = JLlamaModel(JModelConfig(**dims), mode="fp", dtype=jnp.float32)
    qparams = quantize_params(fp.init(jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32)))
    kw = dict(max_batch_size=4, max_seq_len=32, prefill_chunk=16, max_new_tokens=6,
              temperature=0.0)
    jmesh = _jmesh(tp)
    jmodel = jpar.tp_model(JModelConfig(**dims), "dynamic", jmesh, dtype=jnp.float32,
                           collective=True)
    with jmesh:
        je = JEngine(jmodel, jpar.shard_params(qparams, jmesh), JEngineConfig(**kw),
                     kv_dtype=jnp.int8, mesh=jmesh)
        jr = [je.add_request(p, 6) for p in PROMPTS]
        jouts = je.run()
    mesh = _mesh(tp)
    model = tp_model(ModelConfig(**dims), "dynamic", mesh, torch.float32, collective=True)
    model.load_shards(shard_params(params_from_numpy(to_numpy_tree(qparams)), mesh))
    te = Engine(model, EngineConfig(**kw), kv_dtype="int8", mesh=mesh)
    tr = [te.add_request(p, 6) for p in PROMPTS]
    touts = te.run()
    assert [jouts[r] for r in jr] == [touts[r] for r in tr]


def test_tp_scope_not_ported_raises(params):
    """What this slice does not take under a mesh raises before it runs."""
    mesh = _mesh(2)
    cfg = ModelConfig(**DIMS)
    model = tp_model(cfg, "fp", mesh, torch.float32)
    ecfg = EngineConfig(max_batch_size=2, max_seq_len=32, page_size=8, prefill_chunk=16)
    with pytest.raises(NotImplementedError):
        Engine(model, ecfg, kv_layout="paged", mesh=mesh)
    for kv in ("k8v4", "k4v8", "int4"):
        with pytest.raises(NotImplementedError):
            Engine(model, ecfg, kv_dtype=kv, mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        Engine(model, ecfg)  # a TP model needs its mesh
    with pytest.raises(ValueError, match="mesh"):
        Engine(LlamaModel(cfg, "fp", torch.float32, device="cpu"), ecfg, mesh=mesh)
    for mode in ("weight_only", "weight_only_int4", "dynamic_int4"):
        with pytest.raises(NotImplementedError):
            tp_model(cfg, mode, mesh, torch.float32)
    for bad in (ModelConfig.gpt_oss_20b(), ModelConfig.bloom_560m()):
        with pytest.raises(NotImplementedError):
            LlamaModel(bad, "dynamic", device="meta", tp_group=mesh.group)
    with pytest.raises(NotImplementedError):
        make_mesh(MeshConfig(dp=2, tp=2), ["cpu"] * 4)
    with pytest.raises(NotImplementedError):
        init_multihost()
    with pytest.raises(NotImplementedError):
        build_cp_score(cfg, "fp", mesh)
    with pytest.raises(NotImplementedError):
        init_cache(cfg, 2, 32, "cpu", "k4v8", tp=2)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(MeshConfig(tp=2), ["cpu"] * 3)
    with pytest.raises(NotImplementedError):
        shard_params({"layers_0.block_sparse_moe.gate.weight": torch.zeros(4, 4)}, mesh)
