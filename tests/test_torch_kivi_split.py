"""The split-S decomposition of the KIVI attentions (``csrc/kivi_split.cuh``),
spelled out in plain PyTorch by ``kivi_attention_partials_ref`` and
``merge_partials_ref``, against the plain versions and the JAX package.

The partials cover the packed keys in splits of the kernel's span (256 keys
at Dh 64, 128 at Dh 128, at G = 16) and the tail as a split of its own; a split no row sees is empty; the learned sink
joins once, in the merge. The merged result is held to the plain version
(``k4v8_attention_ref`` / ``int4_kv_attention_ref``) at rtol = atol = 1e-5
(the same f32 sums regrouped), and to the JAX ``k4v8_attention`` /
``int4_kv_attention`` in interpret mode at 3e-5, the limit
``test_torch_kivi_kv.py::test_attention_plain_vs_pallas`` holds the plain
version to, on the batch rows whose last query position lies below the
capacity S: the Pallas kernel's tail also admits positions at or past S
(its tail mask is pos >= F alone), which the XLA formulation, the plain
version and the port's kernels never see (pos < S). Caches are random
arrays made with numpy from a seed, the K4V8 V tail mirroring vq/vs at the
live tail positions as the cache's writes keep it.
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
G, S, KV = 16, 512, 2
TIERS = {"k4v8": (A.k4v8_attention_ref, j_k4v8_attention),
         "int4": (A.int4_kv_attention_ref, j_int4_attention)}
# (head dim, GQA group): GPT-OSS's group 8 at 64, Llama's group 1 at 128
SHAPES = [(64, 8), (128, 1)]
# head dim -> the split kernel's span at G (ks_plan in csrc/kivi_split.cuh)
SPAN = {64: 256, 128: 128}


def _cache(rng, tier, B, Dh, new_lengths):
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


def _run(tier, seed, Dh, group, T, lens, *, window=0, scale=0.0, softcap=0.0, alibi=False,
         sinks=False, q_gain=1.0):
    """The merged split result, the plain version's, the JAX kernel's (all
    numpy f32) and the partials, on one random case."""
    rng = np.random.default_rng(seed)
    B, H = len(lens), KV * group
    lengths = np.array(lens, np.int32)
    new_lengths = lengths + T
    cache = _cache(rng, tier, B, Dh, new_lengths)
    q = (rng.standard_normal((B, T, H, Dh)) * q_gain).astype(np.float32)
    sink = rng.standard_normal(H).astype(np.float32) * 2 if sinks else None
    slopes = alibi_slopes(H).numpy() if alibi else None
    kw = dict(window=window, scale=scale, softcap=softcap)
    t = [torch.from_numpy(x) for x in (q, *cache, lengths, new_lengths)]
    tsink = None if sink is None else torch.from_numpy(sink)
    tslopes = None if slopes is None else torch.from_numpy(slopes)
    acc, m, l = A.kivi_attention_partials_ref(*t, group=G, v4=tier == "int4", span=SPAN[Dh],
                                              alibi_slopes=tslopes, **kw)
    merged = A.merge_partials_ref(acc, m, l, H, tsink)
    plain = TIERS[tier][0](*t, group=G, alibi_slopes=tslopes, sink_logits=tsink, **kw)
    jax_out = TIERS[tier][1](
        *(jnp.asarray(x) for x in (q, *cache, lengths, new_lengths)), group=G,
        sink_logits=None if sink is None else jnp.asarray(sink),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes), interpret=True, **kw)
    below = lengths + T <= S  # rows held to the JAX kernel too
    return (merged.numpy(), plain.numpy(), np.asarray(jax_out, np.float32)[below],
            (acc, m, l), below)


def _check(merged, plain, jax_out, below):
    np.testing.assert_allclose(merged, plain, rtol=TOL_PLAIN, atol=TOL_PLAIN)
    np.testing.assert_allclose(merged[below], jax_out, rtol=TOL_JAX, atol=TOL_JAX)


def _live(l):
    """Per (b, kv head), the splits with a visible key, as index lists."""
    return [[torch.nonzero(l[b, k].amax(dim=-1) > 0).flatten().tolist() for k in range(KV)]
            for b in range(l.shape[0])]


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("Dh,group", SHAPES)
@pytest.mark.parametrize("tier", TIERS)
def test_split_boundary_lengths(tier, Dh, group, T):
    """Lengths 0, G - 1, G, a split - 1, a split, S - 1 and S: the merge
    equals the plain version and the JAX kernel; the splits past each row's
    last key and the tail of a row on a chunk boundary are empty."""
    span = SPAN[Dh]
    lens = [0, G - 1, G, span - 1, span, S - 1, S]
    merged, plain, jax_out, (acc, m, l), below = _run(tier, 3 + T + Dh, Dh, group, T, lens)
    _check(merged, plain, jax_out, below)
    assert below.sum() >= len(lens) - 2
    n_split = S // span + 1
    assert acc.shape == (len(lens), KV, n_split, T * group, Dh)
    for b, ln in enumerate(lens):
        new = ln + T
        F = (min(new, S) // G) * G
        want = [i for i in range(n_split - 1) if i * span < min(F, new)]
        if F < min(new, S):
            want.append(n_split - 1)
        assert _live(l)[b] == [want] * KV, (ln, _live(l)[b])
    dead = l == 0
    assert torch.all(m[dead] == A.NEG_INF) and not acc[dead].any()


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("tier", TIERS)
def test_split_window_leaves_splits_dead(tier, T):
    """A window of 40 at lengths 300 to 480 (span 256): split 0 lies wholly
    below every row's window and is empty; the result holds."""
    lens = [300, 400, 480 - T]
    merged, plain, jax_out, (_, _, l), below = _run(tier, 11 + T, 64, 8, T, lens, window=40)
    _check(merged, plain, jax_out, below)
    assert all(0 not in per_head for row in _live(l) for per_head in row)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("tier", TIERS)
def test_split_sinks_with_only_the_tail_live(tier, T):
    """Learned sinks, a window of 8 at lengths 8 past a chunk boundary: every
    row sees tail positions only, so the tail split alone is live and the
    sink joins it once in the merge."""
    lens = [G + 8, 5 * G + 8, 20 * G + 8]
    merged, plain, jax_out, (_, _, l), below = _run(tier, 17 + T, 64, 8, T, lens, window=8,
                                                    sinks=True)
    _check(merged, plain, jax_out, below)
    n_split = S // SPAN[64] + 1
    assert _live(l) == [[[n_split - 1]] * KV] * len(lens)


@pytest.mark.parametrize("variant", ["alibi", "softcap_scale"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("tier", TIERS)
def test_split_variants(tier, T, variant):
    """ALiBi (BLOOM), and a softcap with a score scale (Gemma-2; q drawn large
    so the cap bites), over lengths that span several packed splits and
    the tail."""
    kw = (dict(alibi=True) if variant == "alibi"
          else dict(softcap=2.0, scale=0.0625, q_gain=100.0))
    lens = [37, 290, 511 - T]
    merged, plain, jax_out, _, below = _run(tier, 23 + T, 128, 1, T, lens, **kw)
    _check(merged, plain, jax_out, below)
    without = _run(tier, 23 + T, 128, 1, T, lens, q_gain=kw.get("q_gain", 1.0))[1]
    assert np.abs(plain - without).max() > 100 * TOL_JAX  # the variant bites
