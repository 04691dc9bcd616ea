"""The port stands alone: no module of ``protoquant_tpu_torch``, and not
``chip_smoke.py``, the card tests or the timing tools, imports ``jax`` or
the JAX package, and an entry point asked for CUDA without a card raises
instead of falling back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import protoquant_tpu_torch
from protoquant_tpu_torch import Engine, LlamaModel, ModelConfig, QLinear
from protoquant_tpu_torch.engine import PagedInt8KVCache
from protoquant_tpu_torch.models import cache_from_numpy, init_cache
from protoquant_tpu_torch.models.kv_cache import (BF16KVCache, Int4KVCache, Int8KVCache,
                                                  K4V8KVCache, MixedKVCache, RingInt8KVCache)
from protoquant_tpu_torch.models.llama import MLP, Attention, DecoderLayer, LayerNorm, RMSNorm
from protoquant_tpu_torch.models.moe import MoEMLP, StackedWeight
from protoquant_tpu_torch.parallel import Mesh, make_mesh, make_tp_caches, tp_model
from protoquant_tpu_torch.utils import MeshConfig, resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "protoquant_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "test_torch_int4_decode_cuda.py",
    ROOT / "tests" / "test_torch_int4_tile_cuda.py",
    ROOT / "tests" / "test_torch_weight_only_cuda.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "protoquant_tpu")


def _forbidden(module: str) -> bool:
    """True for a forbidden top-level package or one of its submodules;
    ``protoquant_tpu_torch`` merely starts with the same letters."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_guard_matches_names_exactly():
    assert _forbidden("protoquant_tpu") and _forbidden("protoquant_tpu.ops")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")
    assert not _forbidden("protoquant_tpu_torch")
    assert not _forbidden("protoquant_tpu_torch.ops")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, protoquant_tpu_torch, protoquant_tpu_torch.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'protoquant_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


CFG = ModelConfig(vocab_size=32, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=1, num_attention_heads=2,
                  num_key_value_heads=1, max_position_embeddings=32)
BLOOM_CFG = ModelConfig(vocab_size=32, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
                        max_position_embeddings=32, norm_type="layernorm", mlp_gated=False,
                        mlp_bias=True, attention_bias=True, attention_out_bias=True,
                        hidden_act="gelu", position_embedding="alibi",
                        embedding_layernorm=True)
MOE_CFG = ModelConfig(vocab_size=32, hidden_size=32, intermediate_size=16,
                      num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                      max_position_embeddings=32, learned_attention_sinks=True,
                      num_local_experts=4, moe_variant="gpt_oss", moe_router_bias=True,
                      moe_softmax_after_topk=True, rope_scaling_type="yarn")
_INT8_STATE = {f: getattr(Int8KVCache.init(1, 8, 1, 16, device="cpu"), f).numpy()
               for f in ("kq", "ks", "vq", "vs", "lengths")}

# Every public constructor that makes tensors, called with ``device`` (the
# keyword each takes) and nothing else of where to put them.
CONSTRUCTORS = {
    "LlamaModel": lambda **d: LlamaModel(CFG, **d),
    "QLinear": lambda **d: QLinear(32, 16, "dynamic", **d),
    "QLinear_int4": lambda **d: QLinear(32, 16, "dynamic_int4", int4_group=16, **d),
    "init_cache": lambda **d: init_cache(CFG, 2, 16, kv_dtype="int8", **d),
    "init_cache_default": lambda **d: init_cache(CFG, 2, 16, **d),  # bf16
    "init_cache_k8v4": lambda **d: init_cache(CFG, 2, 16, kv_dtype="k8v4", **d),
    "Int8KVCache.init": lambda **d: Int8KVCache.init(2, 16, 1, 16, **d),
    "K4V8KVCache.init": lambda **d: K4V8KVCache.init(2, 16, 1, 16, **d),
    "Int4KVCache.init": lambda **d: Int4KVCache.init(2, 16, 1, 16, **d),
    "MixedKVCache.init": lambda **d: MixedKVCache.init(2, 16, 1, 16, **d),
    "BF16KVCache.init": lambda **d: BF16KVCache.init(2, 16, 1, 16, **d),
    "init_cache_int4": lambda **d: init_cache(CFG, 2, 16, kv_dtype="int4", **d),
    "PagedInt8KVCache.init": lambda **d: PagedInt8KVCache.init(2, 5, 2, 8, 1, 16, **d),
    "RingInt8KVCache.init": lambda **d: RingInt8KVCache.init(2, 8, 4, 1, 16, sinks=2, **d),
    "cache_from_numpy": lambda **d: cache_from_numpy(Int8KVCache, _INT8_STATE, **d),
    "LlamaModel_bloom": lambda **d: LlamaModel(BLOOM_CFG, **d),
    "LayerNorm": lambda **d: LayerNorm(32, **d),
    "RMSNorm": lambda **d: RMSNorm(32, **d),
    "Attention": lambda **d: Attention(CFG, "dynamic", torch.float32, **d),
    "MLP": lambda **d: MLP(CFG, "dynamic", torch.float32, **d),
    "DecoderLayer": lambda **d: DecoderLayer(CFG, "dynamic", torch.float32, **d),
    "LlamaModel_gpt_oss": lambda **d: LlamaModel(MOE_CFG, **d),
    "MoEMLP": lambda **d: MoEMLP(MOE_CFG, "dynamic", torch.float32, **d),
    "StackedWeight_int4": lambda **d: StackedWeight(2, 32, 16, "weight_only_int4", **d),
}


def _tensors(obj):
    """Every tensor an object holds: a module's parameters and buffers, a
    cache's fields, or those of a list of caches."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, list):
        return [t for o in obj for t in _tensors(o)]
    return [v for v in vars(obj).values() if isinstance(v, torch.Tensor)]


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaModel(ModelConfig.tiny())  # default device is cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaModel(ModelConfig.tiny(), device="cuda:0")
    for name, make in CONSTRUCTORS.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()  # no device given: cuda, which is missing
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device="cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cpu_entry_points_run_on_cpu():
    m = LlamaModel(CFG, device="cpu", dtype=torch.float32).init_random_(0)
    e = Engine(m, protoquant_tpu_torch.EngineConfig(max_batch_size=2, max_seq_len=32,
                                                     prefill_chunk=8, max_new_tokens=3))
    rid = e.add_request([1, 2, 3])
    assert len(e.run()[rid]) == 3
    assert e.caches[0].kq.device.type == "cpu"
    for name, make in CONSTRUCTORS.items():
        tensors = _tensors(make(device="cpu"))
        assert tensors and all(t.device.type == "cpu" for t in tensors), name


TP_CFG = ModelConfig(vocab_size=32, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                     num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=32)


def test_mesh_and_tp_model_resolve_to_cuda(monkeypatch):
    """A mesh puts rank r on cuda:r unless the caller names the devices, and
    raises on a machine with fewer cards than ranks; the TP model and its
    caches go where the mesh says (cuda: raise without a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards"):
        make_mesh(MeshConfig(tp=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshConfig(tp=2), ["cuda:0"] * 2)
    cuda_mesh = Mesh(MeshConfig(tp=2), [torch.device("cuda", 0)] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp_model(TP_CFG, "dynamic", cuda_mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tp_caches(TP_CFG, cuda_mesh, 2, 16, "int8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards, this machine has 1"):
        make_mesh(MeshConfig(tp=2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh(MeshConfig(tp=2)).devices == [torch.device("cuda", 0),
                                                   torch.device("cuda", 1)]


def test_cpu_mesh_runs_on_cpu():
    mesh = make_mesh(MeshConfig(tp=2), ["cpu"] * 2)
    model = tp_model(TP_CFG, "dynamic", mesh, torch.float32)
    tensors = _tensors(model) + [t for c in make_tp_caches(TP_CFG, mesh, 2, 16, "int8")
                                 for s in c.shards for t in _tensors(s)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
