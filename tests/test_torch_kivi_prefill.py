"""The prefill kernel of the KIVI attentions (``csrc/attn_prefill.cuh`` with
``KIVI``), spelled out in plain PyTorch by ``kivi_attention_tiles_ref``,
against the plain versions and the JAX package.

The spelling lays the kernel's walk out as the columns of a dense cache for
``dense_attention_tiles_ref``: the packed store below the frontier F =
(min(new_lengths, S) // G) G, each K element nib * kchs[p // G] (the plain
version's f32 product), then the tails' 2G int8 rows, tail column c holding
the one position = c mod 2G in [F, F + 2G), below S. At ``lane=torch.float32``
it is held to the plain version (``k4v8_attention_ref`` /
``int4_kv_attention_ref``) at rtol = atol = 1e-5 (the same f32 sums
regrouped), and to the JAX ``k4v8_attention`` / ``int4_kv_attention`` in
interpret mode at 3e-5, ``test_torch_kivi_split.py``'s limit, on the batch
rows whose last query lies below S (the Pallas tail also admits positions at
or past S).

At ``lane=torch.bfloat16`` the spelling takes the kernel's terms: q and p *
vs split into bf16 terms (f32 q: 3 each, within 2^-25 of themselves; bf16
q: one of q, exact), and each packed K element into 2 (within 2^-17 of
itself; the tails' int8 codes exact in one). So each score moves by at most
delta = 2^-17 sm max_(r, c) sum_d |q_d k_d| from the plain version's (the
softcap's slope is at most 1; ALiBi adds exact offsets), each softmax weight
by a factor within e^(+-2 delta), and an output by at most (e^(2 delta) - 1)
sum_c |p v| / l, sum_c |p v| / l being the plain version over |v| (with
learned sinks the sink's share sits in l); the terms of q and p * vs add
2^-15 sum_c |p v| / l at most (``test_torch_attn_prefill.py``): held to
(2^-15 + 2.1 delta) sum_c |p v| / l + 1e-6. Planted faults, each spelled at
lane f32 and each missing the plain tolerance tenfold: the scale row of the
next chunk read for every packed key, and every tail column read one row
off.
Caches and q are random arrays made with numpy from a seed, the K4V8 V tail
mirroring vq/vs at the live tail positions as the cache's writes keep it; q
is drawn 8 times a standard normal, so that the scores spread over several
units and one bf16 term of K in place of two misses the bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.ops.attention import int4_kv_attention as j_int4_attention
from protoquant_tpu.ops.attention import k4v8_attention as j_k4v8_attention
from protoquant_tpu_torch.models.llama import alibi_slopes
from protoquant_tpu_torch.ops import attention as A

TOL_PLAIN, TOL_JAX = 1e-5, 3e-5
SPLIT_TERMS, K_TERM, SLACK = 2.0**-15, 2.0**-17, 1e-6
KV = 2
TIERS = {"k4v8": (A.k4v8_attention_ref, j_k4v8_attention),
         "int4": (A.int4_kv_attention_ref, j_int4_attention)}


def _cache(rng, tier, B, S, Dh, G, new_lengths):
    """kq, kchs, vq, vs, ktail, kts, vtail, vts as numpy arrays."""
    def i8(*shape):
        return rng.integers(-128, 128, shape, dtype=np.int8)

    def sc(*shape):
        return (rng.random(shape, dtype=np.float32) * 1e-2 + 1e-3).astype(np.float32)

    v = (i8(B, KV, S // 2, Dh), sc(B, KV, 2, S // 2)) if tier == "int4" else (
        i8(B, KV, S, Dh).clip(-127, 127), sc(B, KV, S))
    c = [i8(B, KV, S // 2, Dh), sc(B, KV, S // G, Dh), *v, i8(B, KV, 2 * G, Dh).clip(-127, 127),
         sc(B, KV, 2 * G), i8(B, KV, 2 * G, Dh).clip(-127, 127), sc(B, KV, 2 * G)]
    if tier == "k4v8":
        for b, nl in enumerate(new_lengths):
            F = (min(nl, S) // G) * G
            for pos in range(F, min(F + 2 * G, S)):
                c[6][b, :, pos % (2 * G)] = c[2][b, :, pos]
                c[7][b, :, pos % (2 * G)] = c[3][b, :, pos]
    return c


def _run(tier, seed, Dh, group, T, lens, *, S=512, G=16, q_gain=8.0, learned=False,
         alibi=False, with_jax=False, **kw):
    """One random case: a dict of numpy f32 arrays. "f32" the spelling at
    lane f32; "kern" at the kernel's terms for f32 q, "plain", "mass" (the
    plain version over |v|) and "delta" (the score bound) beside it; "bf16",
    "plain1", "mass1", "delta1" the same for q on the bf16 grid (one term of
    q); "chunk_fault" and "tail_fault" the planted faults at lane f32; "jax"
    the JAX function's on the rows below S (``with_jax``), and "below" those
    rows. ``kw`` takes the variants."""
    rng = np.random.default_rng(seed)
    B, H = len(lens), KV * group
    lengths = np.array(lens, np.int32)
    new_lengths = lengths + T
    cache = _cache(rng, tier, B, S, Dh, G, new_lengths)
    q = (rng.standard_normal((B, T, H, Dh)) * q_gain).astype(np.float32)
    if learned:
        kw["sink_logits"] = torch.from_numpy(rng.standard_normal(H).astype(np.float32) * 2)
    if alibi:
        kw["alibi_slopes"] = alibi_slopes(H)
    t_cache = [torch.from_numpy(x) for x in cache]
    tl, tn = torch.from_numpy(lengths), torch.from_numpy(new_lengths)
    tq = torch.from_numpy(q)
    tq1 = tq.to(torch.bfloat16).float()  # q on the bf16 grid
    v4 = tier == "int4"
    plain_fn = TIERS[tier][0]

    def tiles(qq, c=t_cache, **lk):
        return A.kivi_attention_tiles_ref(qq, *c, tl, tn, group=G, v4=v4, **lk, **kw)

    kq, kchs, vq, vs, kt, kts, vt, vts = t_cache
    k = A.kivi_dequant_k(kq, kchs, kt, kts, tn, G)
    v = A.kivi_dequant_v4(vq, vs, vt, vts, tn, G) if v4 else vq.float() * vs[..., None]
    ones = torch.ones(k.shape[:3])
    sm = A.score_scale(Dh, kw.get("scale", 0.0))

    def mass(qq):
        return A.int8_kv_attention_ref(qq, k, ones, v.abs(), ones, tl, **kw)

    def delta(qq):
        qk = torch.einsum("btkgd,bksd->bkgts", qq.abs().reshape(B, T, KV, group, Dh), k.abs())
        return K_TERM * sm * qk.max().item()

    roll = lambda x, dim: torch.roll(x, -1, dims=dim)
    got = {"f32": tiles(tq, lane=torch.float32), "kern": tiles(tq),
           "bf16": tiles(tq1, terms=A.prefill_terms(torch.bfloat16)),
           "plain": plain_fn(tq, *t_cache, tl, tn, group=G, **kw),
           "plain1": plain_fn(tq1, *t_cache, tl, tn, group=G, **kw),
           "mass": mass(tq), "mass1": mass(tq1),
           "chunk_fault": tiles(tq, [kq, roll(kchs, 2), *t_cache[2:]], lane=torch.float32),
           "tail_fault": tiles(tq, [*t_cache[:4], roll(kt, 2), roll(kts, 2), roll(vt, 2),
                                    roll(vts, 2)], lane=torch.float32)}
    got = {key: val.float().numpy() for key, val in got.items()}
    got["delta"], got["delta1"] = delta(tq), delta(tq1)
    got["below"] = lengths + T <= S
    got["jax"] = None
    if with_jax:
        jkw = {key: jnp.asarray(val.numpy()) if isinstance(val, torch.Tensor) else val
               for key, val in kw.items()}
        out = TIERS[tier][1](*(jnp.asarray(x) for x in (q, *cache, lengths, new_lengths)),
                             group=G, interpret=True, **jkw)
        got["jax"] = np.asarray(out, np.float32)[got["below"]]
    return got


def _check(got):
    """Every lane against its tolerance; returns the planted faults' largest
    errors over the plain tolerance."""
    np.testing.assert_allclose(got["f32"], got["plain"], rtol=TOL_PLAIN, atol=TOL_PLAIN)
    if got["jax"] is not None:
        np.testing.assert_allclose(got["f32"][got["below"]], got["jax"], rtol=TOL_JAX,
                                   atol=TOL_JAX)
    for key, plain, mass, delta in (("kern", "plain", "mass", "delta"),
                                    ("bf16", "plain1", "mass1", "delta1")):
        err = np.abs(got[key] - got[plain])
        bound = (SPLIT_TERMS + 2.1 * got[delta]) * got[mass] + SLACK
        assert (err <= bound).all(), (key, (err - bound).max())
    tol = TOL_PLAIN * (1 + np.abs(got["plain"]))
    return {fault: (np.abs(got[fault] - got["plain"]) / tol).max()
            for fault in ("chunk_fault", "tail_fault")}


@pytest.mark.parametrize("group,T", [(1, 97), (8, 70)])
@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_tiles_across_blocks_and_the_frontier(tier, Dh, group, T):
    """Chunks of 97 rows at Llama's group 1 and 70 at GPT-OSS's group 8 (one
    to nine 64-row blocks a kv head) from lengths 0 and 137 at G 16: the
    rows cross chunk boundaries and the frontier, T > 2G, the tail holds
    part of the chunk; both planted faults miss."""
    margins = _check(_run(tier, Dh + 7 * group + T, Dh, group, T, [0, 137]))
    assert min(margins.values()) > 10, margins


@pytest.mark.parametrize("G", [4, 8, 16, 64])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_chunk_below_and_above_the_key_tile(tier, Dh, G):
    """G 4 and 8 (many chunk-scale rows a 64- or 128-key tile; below 8 the
    kernel reads them from global memory), 16 and 64 (one or two a tile),
    with a 140-row chunk from 35 and 230 (T > 2G up to G 64); both planted
    faults miss."""
    margins = _check(_run(tier, G + Dh, Dh, 1, 140, [35, 230], G=G))
    assert min(margins.values()) > 10, margins


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_window_edge_inside_a_block(tier, group):
    """A window of 40 over 100 rows from lengths 0 and 300: the rows of one
    block start their windows in different tiles, the block walks from its
    first row's tile, and the tail is windowed too."""
    _check(_run(tier, 5 + group, 64, group, 100, [0, 300], window=40))


# (Dh, group, variants): Gemma-2's scale and softcap at Dh 256 (q drawn
# large so the cap bites), BLOOM's ALiBi after a softcap, GPT-OSS's learned
# sinks with a window of 8 (whole tiles of a block masked for some rows)
VARIANTS = {"softcap": (256, 2, dict(scale=0.0625, softcap=8.0, q_gain=8.0, window=50)),
            "alibi": (64, 1, dict(alibi=True, softcap=2.0, q_gain=20.0)),
            "sinks": (64, 8, dict(learned=True, window=8))}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_variants(tier, variant):
    """Softcap with a score scale, ALiBi after the softcap, learned sinks:
    each bites (the plain version without it moves tenfold the tolerance)."""
    Dh, group, kw = VARIANTS[variant]
    got = _run(tier, 11 + Dh + group, Dh, group, 70, [37, 290], **kw)
    _check(got)
    off = {k: v for k, v in kw.items() if k not in ("softcap", "alibi", "learned")}
    without = _run(tier, 11 + Dh + group, Dh, group, 70, [37, 290], **off)["plain"]
    assert np.abs(got["plain"] - without).max() > 10 * TOL_JAX


@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_padded_chunk_past_S(tier):
    """A chunk whose last rows sit past the capacity: the frontier is S, no
    tail column is visible, and those rows see every packed key."""
    _check(_run(tier, 37, 64, 2, 100, [512 - 10, 512 - 100]))


# (Dh, group, T, lengths, variants) held to the JAX functions too
JAX_CASES = {"full": (128, 1, 70, [0, 300], {}),
             "window softcap": (64, 2, 70, [20, 250], dict(window=40, softcap=2.0, q_gain=8.0)),
             "alibi sinks": (64, 8, 40, [5, 400], dict(alibi=True, learned=True))}


@pytest.mark.parametrize("case", list(JAX_CASES))
@pytest.mark.parametrize("tier", ["k4v8", "int4"])
def test_against_the_jax_functions(tier, case):
    """The spelling at lane f32 against ``k4v8_attention`` /
    ``int4_kv_attention`` of the JAX package in interpret mode."""
    Dh, group, T, lens, kw = JAX_CASES[case]
    _check(_run(tier, 3 + Dh + T, Dh, group, T, lens, with_jax=True, **kw))


def test_kivi_tile_terms_are_the_kernels():
    """The K terms are the kernel's (ApGeom::NK in csrc/attn_prefill.cuh),
    the key tile and q's and p * vs's terms the int8 prefill's."""
    assert A.KIVI_K_TERMS == 2
    assert [A.prefill_key_tile(d) for d in (32, 64, 128, 256)] == [64, 64, 128, 32]
