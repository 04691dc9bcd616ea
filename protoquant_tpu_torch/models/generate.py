"""Greedy decode without the batching engine (eval and tests)."""

from __future__ import annotations

import torch

from .llama import LlamaModel, init_cache


@torch.no_grad()
def greedy_generate(model: LlamaModel, prompt, max_new_tokens: int,
                    max_seq: int | None = None, kv_dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy decode over a dense KV cache of ``kv_dtype`` (``init_cache``;
    the default is the JAX package's bf16 cache); returns [B,
    max_new_tokens] int64 ids on the model's device. ``prompt`` is [B, T]
    token ids. ``max_seq`` defaults to T + max_new_tokens, which "k8v4"
    needs even."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    B, T = prompt.shape
    if max_new_tokens == 0:
        return torch.zeros((B, 0), dtype=torch.long, device=model.device)
    max_seq = max_seq or (T + max_new_tokens)
    caches = init_cache(model.cfg, B, max_seq, model.device, kv_dtype)
    logits = model(prompt, None, caches)
    token = logits[:, -1].argmax(dim=-1)
    out = [token]
    for _ in range(max_new_tokens - 1):
        positions = caches[0].lengths.long()[:, None]
        logits = model(token[:, None], positions, caches)
        token = logits[:, -1].argmax(dim=-1)
        out.append(token)
    return torch.stack(out, dim=1)
