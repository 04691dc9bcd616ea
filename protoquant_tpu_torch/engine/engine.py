"""Continuous-batching serving engine over a ``LlamaModel`` with a KV
cache, dense or paged (the non-speculative core of the JAX package's
engine, single replica).

The host owns request bookkeeping (queue, slots, stop conditions); the
device runs one forward per prefill chunk and one batched decode forward per
tick. Requests are admitted into free slots, prefilled chunk by chunk (one
chunk per tick, so decoding slots emit a token between chunks), decoded in
lock-step and retired, and their slots reused. Inactive slots run the same
decode forward with advance 0, so their lengths stay put and their rows
stay masked.

``kv_layout="dense"`` allocates the cache once at [max_batch, max_seq], of
``kv_dtype`` "int8" (default, as the JAX engine's), "k8v4" (int8 K, int4
V), "k4v8" or "int4" (the KIVI capacity tiers), or torch.bfloat16 (K/V
unquantized). A KIVI engine refuses a ``prefill_chunk`` whose padded
pieces could overwrite live tail rows (``kivi_pad_overwrites``).
``kv_layout="paged"`` allocates one pool of B * max_seq / page_size pages
(+1 trash page) per layer; a request reserves only the pages it can touch,
from the native page allocator, when it is admitted, and waits while the
pool is short. With ``EngineConfig.prefix_cache`` a request adopts the
longest chain of resident pages that hold its prompt's prefix and prefills
only the tail (``engine/prefix_cache.py``). ``kv_layout="ring"`` (int8
only) serves a sliding window, the model's or ``EngineConfig.
stream_window`` (StreamingLLM, with ``attention_sinks``), from
``RingInt8KVCache``s of O(window) columns; on a model whose window skips
some layers (Gemma-2) those layers keep dense int8 caches. A model with
learned attention sinks (GPT-OSS) is served over the dense bf16, int8,
K4V8 and Int4 caches only: the JAX package's paged, ring and K8V4 caches
take no sinks, so the engine refuses those before it admits a request.

With ``mesh`` (a ``parallel.make_mesh`` mesh of one replica of tp ranks)
the model is a ``parallel.tp_model`` of that mesh: each layer's cache is a
``TPCache`` of one dense cache per rank (KV/tp heads, bf16 or int8),
prefill chunks and decode steps run every rank through ``Mesh.run``, and
sampling runs once, on the gathered logits (the dp = 1 case of the JAX
engine's ``_build_tp_engine_fns``). Under a mesh the paged and ring
layouts, the K8V4 and KIVI caches, and more than one replica are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import torch

from ..models.kv_cache import (BF16KVCache, Int4KVCache, Int8KVCache, K4V8KVCache,
                               MixedKVCache, RingInt8KVCache)
from ..models.llama import LlamaModel, init_cache, kv_cache_class
from ..native import PageAllocator
from ..parallel.tp import TPModel, make_tp_caches
from ..utils.config import EngineConfig
from .paged_kv import PagedInt8KVCache
from .prefix_cache import PrefixCache
from .sampling import sample_batched, token_logprob


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    eos_id: "int | None" = None  # per-request stop token
    on_token: "object" = None  # optional callback(rid, token) for streaming
    prefill_off: int = 0  # prompt tokens already written into the KV cache
    # Per-request sampling overrides (None = engine-config default).
    temperature: "float | None" = None
    top_k: "int | None" = None
    top_p: "float | None" = None
    min_p: "float | None" = None
    last_logits: "object" = None  # final-position logits of the last chunk
    logprobs: list = dataclasses.field(default_factory=list)  # per out token
    want_logprobs: bool = False
    t_admit: float = 0.0  # perf_counter at slot assignment
    t_enqueue: float = 0.0  # perf_counter at add_request
    # paged layout: private pages, adopted prefix pages, and the pages this
    # request holds references on once its prompt is published
    pages: list = dataclasses.field(default_factory=list)
    shared_pages: list = dataclasses.field(default_factory=list)
    held_pages: list = dataclasses.field(default_factory=list)


def _bucket(n: int, chunk: int, lo: int = 16) -> int:
    """Pad a prefill piece to a power-of-two length (at least ``lo``, at
    most the chunk)."""
    b = lo
    while b < n:
        b *= 2
    return min(b, max(chunk, lo))


def kivi_pad_overwrites(chunk: int, G: int) -> bool:
    """Whether a prefill piece of a KIVI cache with group G, padded by
    :func:`_bucket`, can write a pad row into a tail row that a valid
    position still reads.

    A piece starts at a multiple L of the chunk and holds n <= chunk valid
    tokens, padded to T = _bucket(n, chunk). Its pad positions [L + n, L +
    T) land on tail rows q mod 2G; the valid positions read from the tail
    are those of the open chunk, [F, L + n) with F = floor((L + n) / G) G.
    The differences q - p of the two ranges fill [1, L + T - 1 - F], so
    they meet modulo 2G iff both are non-empty and L + T - 1 - F >= 2G.
    Everything shifts with L by multiples of 2G, so L's residues mod 2G
    decide."""
    starts = {k * chunk % (2 * G) for k in range(2 * G)}
    for L in starts:
        for n in range(1, chunk + 1):
            T = _bucket(n, chunk)
            front = (L + n) // G * G
            if front < L + n < L + T and L + T - 1 - front >= 2 * G:
                return True
    return False


class Engine:
    """Continuous-batching inference engine; runs on the model's device."""

    def __init__(self, model: LlamaModel, config: EngineConfig | None = None,
                 kv_layout: str = "dense", kv_dtype="int8", mesh=None):
        if (mesh is not None) != isinstance(model, TPModel) or (
                mesh is not None and model.mesh is not mesh):
            raise ValueError("a mesh engine serves parallel.tp_model(cfg, mode, mesh) with "
                             "that mesh, and a TP model needs its mesh")
        self.model = model
        self.mesh = mesh
        self.cfg = config or EngineConfig()
        self.device = model.device
        self.kv_layout = kv_layout
        B = self.cfg.max_batch_size
        self.allocator: Optional[PageAllocator] = None
        self.prefix: Optional[PrefixCache] = None
        if self.cfg.prefix_cache and kv_layout != "paged":
            raise ValueError("prefix_cache requires kv_layout='paged'")
        if kv_layout in ("paged", "ring") and kv_cache_class(kv_dtype) is not Int8KVCache:
            raise ValueError(f"the {kv_layout} layout is int8 only; use kv_layout='dense' "
                             f"for kv_dtype {kv_dtype!r}")
        if model.cfg.learned_attention_sinks and (
                kv_layout != "dense" or kv_cache_class(kv_dtype) is MixedKVCache):
            raise ValueError(
                f"kv_layout {kv_layout!r}, kv_dtype {kv_dtype!r}: learned attention sinks "
                "(GPT-OSS) are served over the dense bf16, int8, k4v8 and int4 caches only, "
                "as in the JAX package (its paged, ring and K8V4 caches take no sinks)")
        if mesh is not None:
            if kv_layout != "dense" or kv_cache_class(kv_dtype) not in (Int8KVCache,
                                                                        BF16KVCache):
                raise NotImplementedError(
                    f"kv_layout {kv_layout!r}, kv_dtype {kv_dtype!r} under a mesh: only the "
                    "dense bf16 and int8 caches are ported under tensor parallelism")
            self.caches = make_tp_caches(model.cfg, mesh, B, self.cfg.max_seq_len, kv_dtype)
        elif kv_layout == "dense":
            self.caches = init_cache(model.cfg, B, self.cfg.max_seq_len, self.device,
                                     kv_dtype)
            if isinstance(self.caches[0], (K4V8KVCache, Int4KVCache)):
                self._check_kivi_chunk(self.caches[0].group)
        elif kv_layout == "paged":
            ps = self.cfg.page_size
            if self.cfg.max_seq_len % ps:
                raise ValueError("max_seq_len must be a multiple of page_size")
            # the pool's last page is the trash page (writes through
            # unmapped table entries land there); the allocator hands out
            # the others
            num_pages = B * self.cfg.max_seq_len // ps + 1
            mcfg = model.cfg
            self.caches = [
                PagedInt8KVCache.init(B, num_pages, self.cfg.max_seq_len // ps, ps,
                                      mcfg.num_key_value_heads, mcfg.head_dim,
                                      self.device)
                for _ in range(mcfg.num_hidden_layers)]
            self.allocator = PageAllocator(num_pages - 1)
            if self.cfg.prefix_cache:
                self.prefix = PrefixCache(self.allocator)
        elif kv_layout == "ring":
            self.caches = self._ring_caches(model.cfg)
        else:
            raise ValueError(f"kv_layout {kv_layout!r}: the port has 'dense', 'paged' and "
                             "'ring'")
        c, dev = self.cfg, self.device
        self._samp_host = {
            "temps": [c.temperature] * B, "top_ks": [c.top_k] * B,
            "top_ps": [c.top_p] * B, "min_ps": [c.min_p] * B,
        }
        self.samp = self._samp_tensors()
        self.last_tokens = torch.zeros(B, dtype=torch.long, device=dev)
        self.active = [False] * B
        self.slot_req: list[Optional[Request]] = [None] * B
        self.waiting: deque[Request] = deque()
        self.prefilling: deque[Request] = deque()
        self.finished: list[Request] = []
        self._next_rid = 0
        self.generator = torch.Generator(device=dev).manual_seed(c.seed)
        self.eos_id: Optional[int] = None
        self.stats = {
            "steps": 0,
            "tokens_generated": 0,
            "prefills": 0,
            "step_times": deque(maxlen=256),
            "prefill_times": deque(maxlen=256),
            "queue_waits": deque(maxlen=256),
        }

    def _ring_caches(self, mcfg) -> list:
        """The ring layout's caches (``protoquant_tpu/engine/engine.py``'s):
        a ``RingInt8KVCache`` on every sliding layer, whose slack covers a
        padded prefill piece, and a dense int8 cache on the layers the
        model's window pattern leaves global."""
        c = self.cfg
        window = c.stream_window or mcfg.sliding_window
        if window <= 0:
            raise ValueError("kv_layout='ring' needs cfg.sliding_window > 0 or "
                             "EngineConfig.stream_window > 0 (StreamingLLM serving)")
        max_chunk = _bucket(c.prefill_chunk, c.prefill_chunk)
        pattern = mcfg.sliding_window_pattern or (2 if mcfg.alternating_sliding_window else 0)
        B, KV, Dh = c.max_batch_size, mcfg.num_key_value_heads, mcfg.head_dim
        return [RingInt8KVCache.init(B, window, max_chunk, KV, Dh, sinks=c.attention_sinks,
                                     device=self.device)
                if pattern == 0 or (i + 1) % pattern
                else Int8KVCache.init(B, c.max_seq_len, KV, Dh, device=self.device)
                for i in range(mcfg.num_hidden_layers)]

    def _check_kivi_chunk(self, G: int) -> None:
        """A KIVI cache writes a padded prefill piece's pad rows into its
        2G-row tail too, where they can overwrite rows that valid positions
        still read: refuse the prefill chunks for which that can happen."""
        chunk = self.cfg.prefill_chunk
        if kivi_pad_overwrites(chunk, G):
            raise ValueError(f"prefill_chunk {chunk} with a KIVI group of {G}: padded "
                             f"pieces could overwrite live tail rows")

    def _samp_tensors(self) -> dict:
        h, dev = self._samp_host, self.device
        return {
            "temps": torch.tensor(h["temps"], dtype=torch.float32, device=dev),
            "top_ks": torch.tensor(h["top_ks"], dtype=torch.int64, device=dev),
            "top_ps": torch.tensor(h["top_ps"], dtype=torch.float32, device=dev),
            "min_ps": torch.tensor(h["min_ps"], dtype=torch.float32, device=dev),
        }

    # -- request API -------------------------------------------------------

    def add_request(self, prompt_tokens, max_new_tokens: int | None = None,
                    eos_id: int | None = None, on_token=None,
                    temperature: "float | None" = None, top_k: "int | None" = None,
                    top_p: "float | None" = None, min_p: "float | None" = None,
                    logprobs: bool = False) -> int:
        """Queue a request and return its id. ``eos_id`` stops decode on
        that token (else the engine-wide ``eos_id``); ``on_token(rid, tok)``
        streams tokens; ``logprobs`` records each emitted token's
        log-probability."""
        prompt = [int(t) for t in prompt_tokens]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt)} > max_seq_len {self.cfg.max_seq_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(
            rid=rid, prompt=prompt,
            max_new_tokens=(self.cfg.max_new_tokens if max_new_tokens is None
                            else max_new_tokens),
            eos_id=eos_id, on_token=on_token, temperature=temperature,
            top_k=top_k, top_p=top_p, min_p=min_p, want_logprobs=bool(logprobs),
            t_enqueue=time.perf_counter()))
        return rid

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.prefilling) or any(self.active)

    # -- engine loop -------------------------------------------------------

    def _reserve_pages(self, req: Request, slot: int) -> bool:
        """Paged layout: reserve the pages ``req`` can touch, adopting the
        longest resident prefix chain, and map them to ``slot``. False (and
        nothing reserved) when the pool is short."""
        ps = self.cfg.page_size
        budget = min(len(req.prompt) + req.max_new_tokens, self.cfg.max_seq_len)
        need = -(-budget // ps)
        matched_tokens = 0
        if self.prefix is not None:
            req.shared_pages, matched_tokens = self.prefix.match(req.prompt, ps)
            pages = self.prefix.alloc(need - len(req.shared_pages))
        else:
            pages = self.allocator.alloc(need)
        if pages is None:
            if req.shared_pages:
                self.prefix.unref(req.shared_pages)
                req.shared_pages = []
            return False
        req.pages = pages
        req.prefill_off = matched_tokens
        if self.prefix is not None:
            self.prefix.hit_tokens += matched_tokens
        for c in self.caches:
            c.map_slot(slot, req.shared_pages + pages, start_len=matched_tokens)
        return True

    def _assign_slots(self):
        """Move waiting requests (first come, first served) into free slots.
        A slot is held from assignment to retirement, prefill included. In
        the paged layout a request whose pages the pool cannot supply stays
        waiting (and so do the ones behind it) until something retires."""
        changed = False
        for slot in range(self.cfg.max_batch_size):
            if self.slot_req[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            if self.allocator is not None and not self._reserve_pages(req, slot):
                break
            self.waiting.popleft()
            req.slot = slot
            req.t_admit = time.perf_counter()
            self.stats["queue_waits"].append(req.t_admit - req.t_enqueue)
            self.slot_req[slot] = req
            self.prefilling.append(req)
            c = self.cfg
            for name, override, default in (
                    ("temps", req.temperature, c.temperature),
                    ("top_ks", req.top_k, c.top_k),
                    ("top_ps", req.top_p, c.top_p),
                    ("min_ps", req.min_p, c.min_p)):
                self._samp_host[name][slot] = default if override is None else override
            changed = True
        if changed:
            self.samp = self._samp_tensors()

    def _sample(self, logits: torch.Tensor, rows: list, live: list) -> torch.Tensor:
        """Next tokens for ``logits`` [n, V] whose rows are the slots
        ``rows``; argmax alone when every slot in ``live`` is greedy."""
        if all(self._samp_host["temps"][r] == 0.0 for r in live):
            return logits.argmax(dim=-1)
        idx = torch.as_tensor(rows, device=self.device)
        s = {k: v[idx] for k, v in self.samp.items()}
        return sample_batched(logits, self.generator, s["temps"], s["top_ks"],
                              s["top_ps"], s["min_ps"])

    def _extend_slot(self, tokens: torch.Tensor, true_len: int, slot: int):
        """Prefill one padded chunk [1, Tpad] into ``slot``; return the
        logits [V] at its last real token. The slot's length advances by
        ``true_len``; pad rows past it stay masked (rows past S are
        dropped)."""
        sub = [c.slot_view(slot) for c in self.caches]
        start = int(sub[0].lengths[0])
        positions = start + torch.arange(tokens.shape[1], device=self.device)[None, :]
        positions = positions.clamp_max(self.model.cfg.max_position_embeddings - 1)
        adv = torch.full((1,), true_len, dtype=torch.int32, device=self.device)
        logits = self.model(tokens, positions, sub, advance=adv)
        for big, small in zip(self.caches, sub):
            big.merge_slot(small, slot)
        return logits[0, true_len - 1]

    def _prefill_tick(self):
        """Run ONE prefill chunk of the oldest mid-prefill request; on its
        last chunk emit the first token and activate the slot."""
        req = self.prefilling[0]
        slot = req.slot
        chunk = self.cfg.prefill_chunk
        piece = req.prompt[req.prefill_off:req.prefill_off + chunk]
        tpad = _bucket(len(piece), chunk)
        tokens = torch.tensor([piece + [0] * (tpad - len(piece))],
                              dtype=torch.long, device=self.device)
        req.last_logits = self._extend_slot(tokens, len(piece), slot)
        req.prefill_off += len(piece)
        if req.prefill_off < len(req.prompt):
            return  # more chunks next tick; decoding slots proceed meanwhile

        self.prefilling.popleft()
        if self.prefix is not None:
            # publish this prompt's full pages for later prefix hits
            req.held_pages = self.prefix.publish(
                req.prompt, req.shared_pages + req.pages, self.cfg.page_size,
                len(req.shared_pages))
        if req.max_new_tokens > 0:
            last = req.last_logits[None, :]
            first = self._sample(last, [slot], [slot])
            if self.cfg.return_logprobs or req.want_logprobs:
                req.logprobs.append(float(token_logprob(last, first)[0]))
            tok = int(first[0])
            req.out.append(tok)
            self.stats["tokens_generated"] += 1
            if req.on_token is not None:
                req.on_token(req.rid, tok)
            self.last_tokens[slot] = tok
        req.last_logits = None
        self.active[slot] = True
        self.stats["prefills"] += 1
        self._maybe_finish(slot)
        self.stats["prefill_times"].append(time.perf_counter() - req.t_admit)

    def _maybe_finish(self, slot: int):
        req = self.slot_req[slot]
        if req is None:
            return
        tok = req.out[-1] if req.out else None
        eos = req.eos_id if req.eos_id is not None else self.eos_id
        if (len(req.out) >= req.max_new_tokens
                or (eos is not None and tok == eos)
                or len(req.prompt) + len(req.out) >= self.cfg.max_seq_len):
            self._retire_slot(slot)

    def _retire_slot(self, slot: int):
        """Mark the slot's request done and free the slot for the next one."""
        req = self.slot_req[slot]
        req.done = True
        self.finished.append(req)
        self.active[slot] = False
        self.slot_req[slot] = None
        if req in self.prefilling:
            self.prefilling.remove(req)
        for c in self.caches:
            c.reset_slot(slot)
        if self.prefix is not None:
            # drop references on shared and published pages (zero-ref pages
            # stay cached for later hits); free the private ones (decode
            # tail, partial prompt page, pages whose key was already there)
            held = req.held_pages or list(req.shared_pages)
            held_set = set(held)
            self.prefix.unref(held)
            self.allocator.free([p for p in req.pages if p not in held_set])
        elif self.allocator is not None:
            self.allocator.free(req.pages)
        req.pages, req.shared_pages, req.held_pages = [], [], []

    def _decode_step(self):
        """One batched decode forward over every slot; returns (next tokens
        [B], logits of the last position [B, V]).

        The paged layout passes the full-width page table: the JAX engine
        slices it to a power-of-two bucket of pages covering the longest
        active context, which bounds what its gathered window reads, but the
        port's paged attention kernel already stops at each row's own last
        page. That changes speed only, not results."""
        max_pos = self.model.cfg.max_position_embeddings - 1
        positions = self.caches[0].lengths.clamp_max(max_pos).long()[:, None]
        advance = torch.tensor(self.active, dtype=torch.int32, device=self.device)
        logits = self.model(self.last_tokens[:, None], positions, self.caches,
                            advance=advance)
        last = logits[:, -1]
        live = [s for s, a in enumerate(self.active) if a]
        return self._sample(last, list(range(len(self.active))), live), last

    def step(self):
        """One tick: assign slots, run at most ONE prefill chunk, then one
        batched decode for every active slot."""
        t0 = time.perf_counter()
        self._assign_slots()
        if self.prefilling:
            self._prefill_tick()
        if not any(self.active):
            return
        next_tokens, last = self._decode_step()
        self.last_tokens = next_tokens
        toks = next_tokens.tolist()
        want_lp = self.cfg.return_logprobs or any(
            r is not None and r.want_logprobs for r in self.slot_req)
        lps = token_logprob(last, next_tokens).tolist() if want_lp else None
        for slot in range(self.cfg.max_batch_size):
            if not self.active[slot]:
                continue
            req = self.slot_req[slot]
            req.out.append(toks[slot])
            if lps is not None and (self.cfg.return_logprobs or req.want_logprobs):
                req.logprobs.append(lps[slot])
            if req.on_token is not None:
                req.on_token(req.rid, toks[slot])
            self.stats["tokens_generated"] += 1
            self._maybe_finish(slot)
        self.stats["steps"] += 1
        self.stats["step_times"].append(time.perf_counter() - t0)

    def run(self) -> dict:
        """Drain all queued requests; returns {rid: generated token list}."""
        while self.has_work():
            self.step()
        return {r.rid: r.out for r in self.finished}

    # -- observability -----------------------------------------------------

    def metrics(self) -> dict:
        times = sorted(self.stats["step_times"])
        pct = lambda p: times[int(p * (len(times) - 1))] if times else 0.0
        out = {
            "steps": self.stats["steps"],
            "tokens_generated": self.stats["tokens_generated"],
            "prefills": self.stats["prefills"],
            "batch_occupancy": sum(self.active) / max(1, self.cfg.max_batch_size),
            "queue_depth": len(self.waiting),
            "prefilling": len(self.prefilling),
            "step_p50_ms": 1e3 * pct(0.5),
            "step_p99_ms": 1e3 * pct(0.99),
        }
        waits = sorted(self.stats["queue_waits"])
        if waits:
            wp = lambda p: waits[int(p * (len(waits) - 1))]
            out["queue_wait_p50_ms"] = 1e3 * wp(0.5)
            out["queue_wait_p99_ms"] = 1e3 * wp(0.99)
        if self.allocator is not None:
            out["kv_pages_free"] = self.allocator.num_free
            out["kv_pages_total"] = self.allocator.num_pages
        if self.prefix is not None:
            out["prefix_hit_tokens"] = self.prefix.hit_tokens
            out["prefix_cached_pages"] = self.prefix.cached_pages
            out["prefix_reusable_pages"] = self.prefix.reusable_pages
            out["prefix_evictions"] = self.prefix.evictions
        return out
