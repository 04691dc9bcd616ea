"""The split-S decomposition of the int8 and K8V4 attentions
(``csrc/attn_split.cuh``), spelled out in plain PyTorch by
``dense_attention_partials_ref`` and ``merge_partials_ref``, against the
plain versions and the JAX package.

The partials cover the capacity S in splits of the kernel's span (128
columns); a split no row sees is empty; the learned sink
joins once, in the merge. The merged result is held to the plain version
(``int8_kv_attention_ref`` / ``mixed_kv_attention_ref``) at rtol = atol =
1e-5 (the same f32 sums regrouped), and to the JAX ``int8_kv_attention`` /
``mixed_kv_attention`` in interpret mode at 2e-5, ``test_torch_ops.py``'s
ATOL. StreamingLLM sinks over a contiguous cache are held to
``int8_kv_attention_xla`` instead: the Pallas kernel skips the tiles below
the window and drops the sinks there, which the port does not follow (fault
F2, ``test_torch_ring.py::test_sinks_on_contiguous_cache_follow_xla_not_pallas``).
Caches are random arrays made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.ops.attention import int8_kv_attention as j_int8_attention
from protoquant_tpu.ops.attention import int8_kv_attention_xla as j_int8_attention_xla
from protoquant_tpu.ops.attention import mixed_kv_attention as j_mixed_attention
from protoquant_tpu_torch.models import ring_positions
from protoquant_tpu_torch.models.llama import alibi_slopes
from protoquant_tpu_torch.ops import attention as A

TOL_PLAIN, TOL_JAX = 1e-5, 2e-5
S, KV = 512, 2
# (head dim, GQA group): GPT-OSS's group 8 at 64, Llama's group 1 at 128
SHAPES = [(64, 8), (128, 1)]
SPAN = 128  # the split kernel's span (AS_SPAN in csrc/attn_split.cuh)


def _cache(rng, kind, B, Dh):
    """kq, ks, vq, vs as numpy arrays (K8V4: vq packed, vs parity-split)."""
    def sc(*shape):
        return (rng.random(shape, dtype=np.float32) * 1e-2 + 1e-3).astype(np.float32)

    kq = rng.integers(-127, 128, (B, KV, S, Dh), dtype=np.int8)
    if kind == "k8v4":
        return [kq, sc(B, KV, S), rng.integers(-128, 128, (B, KV, S // 2, Dh), dtype=np.int8),
                sc(B, KV, 2, S // 2)]
    return [kq, sc(B, KV, S), rng.integers(-127, 128, (B, KV, S, Dh), dtype=np.int8),
            sc(B, KV, S)]


def _run(kind, seed, Dh, group, T, lens, *, q_gain=1.0, sink_scale=1.0, learned=False,
         jax_fn=None, with_jax=True, **kw):
    """The merged split result, the plain version's, the JAX function's (all
    numpy f32; None without ``with_jax``) and the partials, on one random
    case. ``kw`` takes the variants; ``k_positions`` as a numpy array."""
    rng = np.random.default_rng(seed)
    B, H = len(lens), KV * group
    lengths = np.array(lens, np.int32)
    cache = _cache(rng, kind, B, Dh)
    cache[1][:, :, :kw.get("sinks", 0)] *= sink_scale
    q = (rng.standard_normal((B, T, H, Dh)) * q_gain).astype(np.float32)
    sink = rng.standard_normal(H).astype(np.float32) * 2 if learned else None
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = alibi_slopes(H).numpy()
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    t = [torch.from_numpy(x) for x in (q, *cache, lengths)]
    tsink = None if sink is None else torch.from_numpy(sink)
    acc, m, l = A.dense_attention_partials_ref(*t, v4=kind == "k8v4", span=SPAN, **tkw)
    merged = A.merge_partials_ref(acc, m, l, H, tsink)
    jargs = [jnp.asarray(x) for x in (q, *cache, lengths)]
    if kind == "k8v4":
        plain = A.mixed_kv_attention_ref(*t, **tkw)
        jax_call = lambda: j_mixed_attention(*jargs, interpret=True, **jkw)
    else:
        plain = A.int8_kv_attention_ref(*t, sink_logits=tsink, **tkw)
        if sink is not None:
            jkw["sink_logits"] = jnp.asarray(sink)
        jax_call = lambda: (jax_fn(*jargs, **jkw) if jax_fn is not None
                            else j_int8_attention(*jargs, interpret=True, **jkw))
    jax_out = np.asarray(jax_call(), np.float32) if with_jax else None
    return merged.numpy(), plain.numpy(), jax_out, (acc, m, l)


def _check(merged, plain, jax_out):
    np.testing.assert_allclose(merged, plain, rtol=TOL_PLAIN, atol=TOL_PLAIN)
    np.testing.assert_allclose(merged, jax_out, rtol=TOL_JAX, atol=TOL_JAX)


def _live(l):
    """Per (b, kv head), the splits with a visible key, as index lists."""
    return [[torch.nonzero(l[b, k].amax(dim=-1) > 0).flatten().tolist() for k in range(KV)]
            for b in range(l.shape[0])]


def _window_splits(lens, T, window, sinks=0):
    """Per row, the splits holding a key of its window (or a sink column)."""
    return [sorted({c // SPAN for c in range(max(ln - window + 1, 0), ln + T)}
                   | {c // SPAN for c in range(min(sinks, ln + T))}) for ln in lens]


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("Dh,group", SHAPES)
@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_split_boundary_lengths(kind, Dh, group, T):
    """Lengths 0, a split - 1, a split, twice a split - 1, S - 1 and S (rows
    at or past the capacity see every column): the merge equals the plain
    version and the JAX kernel; the splits past each row's last key are
    empty."""
    span = SPAN
    lens = [0, span - 1, span, 2 * span - 1, S - 1, S]
    merged, plain, jax_out, (acc, m, l) = _run(kind, 3 + T + Dh, Dh, group, T, lens)
    _check(merged, plain, jax_out)
    n_split = S // span
    assert acc.shape == (len(lens), KV, n_split, T * group, Dh)
    for b, ln in enumerate(lens):
        want = [i for i in range(n_split) if i * span < min(ln + T, S)]
        assert _live(l)[b] == [want] * KV, (ln, _live(l)[b])
    dead = l == 0
    assert torch.all(m[dead] == A.NEG_INF) and not acc[dead].any()


@pytest.mark.parametrize("T", [1, 2])
def test_split_window_leaves_splits_dead(T):
    """A window of 40 at lengths 300 to 480: splits 0 and 1 lie wholly below
    every row's window and are empty; the result holds."""
    lens = [300, 400, 480 - T]
    merged, plain, jax_out, (_, _, l) = _run("int8", 11 + T, 64, 8, T, lens, window=40)
    _check(merged, plain, jax_out)
    assert _live(l) == [[want] * KV for want in _window_splits(lens, T, 40)]
    assert all(split >= 2 for row in _live(l) for per_head in row for split in per_head)


@pytest.mark.parametrize("T", [1, 2])
def test_split_streaming_sinks_on_contiguous_cache(T):
    """StreamingLLM sinks with a window over a contiguous cache: split 0
    holds the 4 sink columns, so it is live though every window lies in
    splits 2 and 3. Held to the XLA formulation, not the Pallas kernel
    (fault F2: the Pallas kernel drops the sinks here)."""
    lens = [300, 400, 480 - T]
    merged, plain, jax_out, (_, _, l) = _run(
        "int8", 13 + T, 64, 8, T, lens, window=40, sinks=4, sink_scale=10.0,
        jax_fn=j_int8_attention_xla)
    _check(merged, plain, jax_out)
    assert _live(l) == [[want] * KV for want in _window_splits(lens, T, 40, sinks=4)]
    assert all(per_head[0] == 0 for row in _live(l) for per_head in row)
    without = _run("int8", 13 + T, 64, 8, T, lens, window=40, with_jax=False)[1]
    assert np.abs(plain - without).max() > 100 * TOL_JAX  # the sinks bite


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("sinks", [0, 4])
def test_split_ring_positions(sinks, alibi):
    """A ring of S columns, window 200: a row inside it (columns never
    written), rows on both sides of its first wrap and one wrapped many
    times, with StreamingLLM sinks and ALiBi; 4 rows a kv head at Dh 128
    (Mistral's group)."""
    T, lens = 1, [30, S - sinks - 1, S - sinks, 3000]
    k_pos = ring_positions(torch.tensor(lens, dtype=torch.int32) + T, S, sinks).numpy()
    merged, plain, jax_out, (_, _, l) = _run(
        "int8", 17 + sinks + alibi, 128, 4, T, lens, window=200, k_positions=k_pos,
        sinks=sinks, sink_scale=10.0, alibi=alibi)
    _check(merged, plain, jax_out)
    as_columns = _run("int8", 17 + sinks + alibi, 128, 4, T, lens, window=200, sinks=sinks,
                      sink_scale=10.0, alibi=alibi, with_jax=False)[1]
    assert np.abs(plain - as_columns).max() > 100 * TOL_JAX  # the positions are read
    assert _live(l)[0] == [[0]] * KV  # the 31 positions of the short row: columns 0 to 30


@pytest.mark.parametrize("T", [1, 2])
def test_split_alibi_after_softcap(T):
    """ALiBi subtracted after the softcap, with a score scale (q drawn large
    so the cap bites), over lengths that span several splits."""
    lens = [37, 290, 511 - T]
    kw = dict(alibi=True, softcap=2.0, scale=0.0625, q_gain=100.0)
    merged, plain, jax_out, _ = _run("int8", 23 + T, 128, 1, T, lens, **kw)
    _check(merged, plain, jax_out)
    uncapped = _run("int8", 23 + T, 128, 1, T, lens, alibi=True, scale=0.0625, q_gain=100.0,
                    with_jax=False)[1]
    assert np.abs(plain - uncapped).max() > 100 * TOL_JAX  # the cap bites


@pytest.mark.parametrize("T", [1, 2])
def test_split_learned_sinks_with_one_split_live(T):
    """GPT-OSS's learned sinks, a window of 8 that keeps each row's keys in
    one split: the sink joins that split's partial once, in the merge."""
    lens = [20, 300, 470]
    merged, plain, jax_out, (_, _, l) = _run("int8", 29 + T, 64, 8, T, lens, window=8,
                                             learned=True)
    _check(merged, plain, jax_out)
    assert _live(l) == [[[0]] * KV, [[2]] * KV, [[3]] * KV]


@pytest.mark.parametrize("T", [1, 2])
def test_k8v4_split_with_score_scale(T):
    """The K8V4 cache with its only variant, a score scale of 0.1, at lengths
    across the splits."""
    lens = [3, 255, 260, 511 - T]
    merged, plain, jax_out, _ = _run("k8v4", 31 + T, 64, 8, T, lens, scale=0.1)
    _check(merged, plain, jax_out)
    unscaled = _run("k8v4", 31 + T, 64, 8, T, lens, with_jax=False)[1]
    assert np.abs(plain - unscaled).max() > 100 * TOL_JAX  # the scale bites
