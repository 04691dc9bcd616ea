"""Mixture-of-experts MLP (Mixtral and GPT-OSS), a port of
``protoquant_tpu/models/moe.py`` on one device.

Routing is the JAX package's GShard capacity form: every token picks its
top-k experts, each expert holds at most ``expert_capacity(N, cfg)`` tokens
of a forward of N tokens, and a (token, choice) past that is dropped (its
contribution is 0 and the residual stream carries the token on). Priority
is choice-major, then token order (``dispatch_combine``). Capacity depends
on the number of tokens in the forward, idle decode slots and prefill
padding included, so a caller that batches differently routes differently.

Variants (``cfg.moe_variant``):

* ``"mixtral"``: ``w1`` (gate), ``w3`` (up), ``w2`` (down), SwiGLU; softmax
  over the router logits, then top-k, the k weights normalized to sum 1
  (``moe_norm_topk``) and scaled by ``routed_scaling_factor``.
* ``"gpt_oss"``: one fused ``gate_up_proj`` whose output columns interleave
  gate (even) and up (odd), per-expert biases on it and on ``down_proj``,
  the clamped glu ``(clip(up, -7, 7) + 1) * g * sigmoid(1.702 g)`` with g =
  min(gate, 7); top-k on the raw router logits, then a softmax over the k.

The router is an f32 linear (with a bias under ``moe_router_bias``) and
stays f32. Expert weights are stacked [E, N, K] (the port's [N, K] layout
per expert; ``models.from_jax`` transposes the JAX [E, K, N]). The expert
products, by mode:

* ``dynamic``: one rowquant of the dispatched input [E, C, K] serves the
  gate and up products (and one of the hidden state the down product), then
  each expert's int8 [C, K] x [K, N] through ``ops.qmatmul`` (the qmatmul
  kernel on CUDA, one launch per expert and product) with an f32 output,
  so the weights stream as int8 bytes. The JAX package sums the same exact
  int8 products in f32 (bf16 lanes), which equals the int32 accumulator
  while partial sums stay below 2^24.
* ``weight_only_int4``: each expert through ``ops.weight_only_int4_matmul``
  (the ``split`` kernel on CUDA), as the JAX package loops over experts.
* ``fp`` and ``weight_only``: one torch einsum over the experts, as the
  JAX package's XLA einsums (outside any TPU kernel).

Every expert runs on every forward, whether it holds tokens or not (its
empty slots are zero rows whose combine weights are 0), as in the JAX
package: the number of launches per forward is fixed by the model. Expert
parallelism, the all-to-all path and shared experts are not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .. import ops
from ..core.qtensor import QTensor, QTensor4
from ..nn.qlinear import pick_int4_group
from ..utils.config import ModelConfig
from ..utils.device import resolve_device

MODES = ("fp", "dynamic", "weight_only", "weight_only_int4")


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Static per-expert token capacity (GShard): ceil(k N / E * factor)."""
    e, k = cfg.num_local_experts, cfg.num_experts_per_tok
    return max(1, math.ceil(k * n_tokens / e * cfg.expert_capacity_factor))


def dispatch_combine(gate_idx: torch.Tensor, gate_vals: torch.Tensor, num_experts: int,
                     capacity: int):
    """Dense dispatch and combine tensors from top-k routing.

    gate_idx [N, k] int, gate_vals [N, k]. Each expert queues its
    assignments choice-major (every token's first choice before any
    token's second), then in token order; those past ``capacity`` are
    dropped. Returns (dispatch [N, E, C] f32 in {0, 1}, combine [N, E, C]
    f32, the gate weight of each kept assignment), as the JAX function."""
    n, k = gate_idx.shape
    flat = gate_idx.t().reshape(-1)  # choice-major: rows 0..N-1 the first choices
    oh = F.one_hot(flat.long(), num_experts).float()  # [kN, E]
    pos = torch.cumsum(oh, dim=0) - 1.0  # queue position within each expert
    keep = (pos < capacity) & (oh > 0)
    slot = torch.where(keep, pos, torch.full_like(pos, -1.0)).amax(dim=-1).long()  # [kN]
    slot_oh = F.one_hot(slot.clamp_min(0), capacity).float() * (slot >= 0)[:, None]
    assign = (oh * keep)[:, :, None] * slot_oh[:, None, :]  # [kN, E, C]
    assign = assign.reshape(k, n, num_experts, capacity).transpose(0, 1)
    dispatch = assign.sum(dim=1)
    combine = (assign * gate_vals.float()[:, :, None, None]).sum(dim=1)
    return dispatch, combine


class StackedWeight(nn.Module):
    """E expert weights [N, K] of one projection, stacked: ``weight`` f32
    [E, N, K] (mode ``fp``); ``qweight`` int8 [E, N, K] and ``qscale`` f32
    [E, N] (``dynamic``, ``weight_only``: a 3-D ``QTensor``); ``qweight``
    int8 [E, N, K/2] and ``qscale`` f32 [E, N, K/group]
    (``weight_only_int4``: a 3-D ``QTensor4``, group ``pick_int4_group(K,
    int4_group)``, as the JAX package's ``_StackedWeight``)."""

    def __init__(self, E: int, K: int, N: int, mode: str, device=None, int4_group: int = 128):
        super().__init__()
        self.E, self.K, self.N = E, K, N
        self.mode, self.group = mode, None
        device = resolve_device(device)
        if mode == "fp":
            self.weight = nn.Parameter(torch.empty(E, N, K, device=device),
                                       requires_grad=False)
            return
        if mode == "weight_only_int4":
            self.group = pick_int4_group(K, int4_group)
            shapes = ((E, N, K // 2), (E, N, K // self.group))
        else:
            shapes = ((E, N, K), (E, N))
        self.register_buffer("qweight", torch.zeros(shapes[0], dtype=torch.int8, device=device))
        self.register_buffer("qscale", torch.ones(shapes[1], device=device))

    @torch.no_grad()
    def set_expert(self, e: int, w: torch.Tensor, int4_clip: str = "mse") -> None:
        """Load expert ``e``'s fp weight [N, K], quantized in this mode."""
        if self.mode == "fp":
            self.weight[e].copy_(w)
            return
        qt = (QTensor4.quantize(w, self.group, clip=int4_clip) if self.group
              else QTensor.quantize(w, axis=1))
        self.qweight[e].copy_(qt.data)
        self.qscale[e].copy_(qt.scale)


class MoEMLP(nn.Module):
    """The sparse MoE block in place of the dense MLP (the JAX module's name
    ``block_sparse_moe``): the router ``gate`` and the stacked experts of
    ``cfg.moe_variant``. ``forward(x [B, T, D]) -> [B, T, D]`` in the
    activation dtype. ``kept`` and ``assignments`` count, over every forward
    since they were last zeroed, the (token, choice) assignments kept and
    made (``kept`` a device tensor, so reading it is the only sync)."""

    def __init__(self, cfg: ModelConfig, mode: str, dtype, device=None, int4_group: int = 128):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"MoE mode {mode!r}: the port has {MODES}")
        self.cfg, self.mode, self.dtype = cfg, mode, dtype
        device = resolve_device(device)
        E, D = cfg.num_local_experts, cfg.hidden_size
        inter = cfg.moe_intermediate_size or cfg.intermediate_size
        self.gate = nn.Linear(D, E, bias=cfg.moe_router_bias, device=device)
        self.gate.requires_grad_(False)
        stacked = lambda k, n: StackedWeight(E, k, n, mode, device, int4_group)
        if cfg.moe_variant == "gpt_oss":
            self.gate_up_proj = stacked(D, 2 * inter)
            self.gate_up_proj_bias = nn.Parameter(torch.zeros(E, 2 * inter, device=device),
                                                  requires_grad=False)
            self.down_proj = stacked(inter, D)
            self.down_proj_bias = nn.Parameter(torch.zeros(E, D, device=device),
                                               requires_grad=False)
        else:
            self.w1 = stacked(D, inter)
            self.w3 = stacked(D, inter)
            self.w2 = stacked(inter, D)
        self.assignments = 0
        self.kept = torch.zeros((), device=device)

    def router_logits(self, xf: torch.Tensor) -> torch.Tensor:
        """Router logits of xf [N, D] in f32: x W^T, then the bias."""
        logits = xf.float() @ self.gate.weight.t()
        return logits if self.gate.bias is None else logits + self.gate.bias

    def gate_values(self, logits: torch.Tensor, gate_idx: torch.Tensor) -> torch.Tensor:
        """The combine weights [N, k] of the experts ``gate_idx`` [N, k]:
        a softmax over their raw logits (GPT-OSS), or their share of the
        softmax over all logits, normalized and scaled as the config says."""
        cfg = self.cfg
        if cfg.moe_softmax_after_topk:
            return torch.softmax(torch.gather(logits, -1, gate_idx), dim=-1)
        gate_vals = torch.gather(torch.softmax(logits, dim=-1), -1, gate_idx)
        if cfg.moe_norm_topk:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        if cfg.routed_scaling_factor != 1.0:
            gate_vals = gate_vals * cfg.routed_scaling_factor
        return gate_vals

    def route(self, xf: torch.Tensor):
        """Each token's top-k experts [N, k] and their combine weights: top-k
        of the raw logits (GPT-OSS) or of their softmax."""
        logits = self.router_logits(xf)
        scores = logits if self.cfg.moe_softmax_after_topk else torch.softmax(logits, dim=-1)
        gate_idx = torch.topk(scores, self.cfg.num_experts_per_tok, dim=-1).indices
        return gate_idx, self.gate_values(logits, gate_idx)

    def _matmul(self, x: torch.Tensor, w: StackedWeight, preq=None, bias=None) -> torch.Tensor:
        """Per-expert x [E, C, K] @ w[e]^T (+ bias [E, N]) -> [E, C, N] f32,
        through the mode's formulation (the module docstring)."""
        if self.mode == "fp":
            y = torch.einsum("eck,enk->ecn", x.to(self.dtype).float(),
                             w.weight.to(self.dtype).float())
        elif self.mode == "weight_only":
            y = torch.einsum("eck,enk->ecn", x.to(torch.bfloat16).float(),
                             w.qweight.float()) * w.qscale[:, None, :]
        elif self.mode == "dynamic":
            xq, s_x = preq if preq is not None else ops.rowquant(x.to(self.dtype))
            return torch.stack([
                ops.qmatmul(xq[e], w.qweight[e], s_x[e], w.qscale[e],
                            None if bias is None else bias[e], out_dtype=torch.float32)
                for e in range(xq.shape[0])])
        else:  # weight_only_int4: the JAX kernel's output is in the model's dtype
            y = torch.stack([
                ops.weight_only_int4_matmul(x[e].to(torch.bfloat16), w.qweight[e],
                                            w.qscale[e], w.group, out_dtype=self.dtype,
                                            formulation="split").float()
                for e in range(x.shape[0])])
        return y if bias is None else y + bias[:, None, :]

    def _experts(self, xin: torch.Tensor) -> torch.Tensor:
        """Every expert's FFN over its slots: xin [E, C, D] -> [E, C, D] f32."""
        preq = ops.shared_rowquant(xin) if self.mode == "dynamic" else None
        if self.cfg.moe_variant == "gpt_oss":
            gu = self._matmul(xin, self.gate_up_proj, preq, self.gate_up_proj_bias)
            gate = torch.clamp_max(gu[..., 0::2], 7.0)
            up = torch.clamp(gu[..., 1::2], -7.0, 7.0)
            h = ((up + 1.0) * (gate * torch.sigmoid(1.702 * gate))).to(self.dtype)
            return self._matmul(h, self.down_proj, bias=self.down_proj_bias)
        gate = self._matmul(xin, self.w1, preq)
        up = self._matmul(xin, self.w3, preq)
        return self._matmul((F.silu(gate) * up).to(self.dtype), self.w2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        n, E = B * T, self.cfg.num_local_experts
        xf = x.to(self.dtype).reshape(n, D)
        gate_idx, gate_vals = self.route(xf)
        cap = expert_capacity(n, self.cfg)
        dispatch, combine = dispatch_combine(gate_idx, gate_vals, E, cap)
        self.assignments += n * self.cfg.num_experts_per_tok
        self.kept += dispatch.sum()
        # the token in each (expert, slot), zero where the slot is empty
        filled = dispatch.sum(dim=0) > 0  # [E, C]
        xin = torch.where(filled[..., None], xf[dispatch.argmax(dim=0)],
                          torch.zeros((), dtype=xf.dtype, device=xf.device))
        y = self._experts(xin)  # [E, C, D] f32
        out = combine.reshape(n, E * cap) @ y.reshape(E * cap, D)
        return out.to(self.dtype).reshape(B, T, D)
