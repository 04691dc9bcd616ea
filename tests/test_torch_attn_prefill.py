"""The prefill kernel of the int8 and K8V4 attentions
(``csrc/attn_prefill.cuh``), spelled out in plain PyTorch by
``dense_attention_tiles_ref``, against the plain versions and the JAX
package.

The spelling takes the kernel's walk (64-row blocks, tiles of 64 keys, 128
at Dh 128 and 32 at Dh 256, from the tile of each block's first visible key
to its last row's horizon, StreamingLLM sink tiles first, every tile of a
ring; a key outside the walk is dropped) and its online rescale per tile.
At ``lane=torch.float32`` it is held to the plain version
(``int8_kv_attention_ref`` / ``mixed_kv_attention_ref``) at rtol = atol =
1e-5 (the same f32 sums regrouped) and to the JAX ``int8_kv_attention`` /
``mixed_kv_attention`` in interpret mode at 2e-5, ``test_torch_ops.py``'s
ATOL. StreamingLLM sinks over a contiguous cache are held to
``int8_kv_attention_xla`` instead (fault F2: the Pallas kernel drops them).

At ``lane=torch.bfloat16`` the spelling takes bf16 terms of q and p * vs,
each term the rounded remainder of the ones before. With one term each (the
TPU kernel's lanes) and q drawn on the bf16 grid, the scores are exact and
only p * vs is rounded, each product p vs v by at most 2^-9 of itself, so
an output moves from the plain version's by at most 2^-9 sum_c |p vs v| /
l, plus f32 sums in another order: held to 2^-8 sum_c |p vs v| / l + 1e-6
(the form of the int4 path's 2^-8 sum |x q s|). The kernel's terms (bf16
q: one of q, three of p * vs; f32 q, any q: three of each) leave q and p *
vs within 2^-25 of themselves: held to 2^-15 sum_c |p vs v| / l + 1e-6. sum_c |p vs v| / l is the plain version over
|v| (vs > 0; with learned sinks the sink's share sits in l). A planted
fault, the mask shifted by one key (each row one position later), misses
every tolerance.
Caches and q are random arrays made with numpy from a seed.
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
ONE_TERM, SPLIT_TERMS, SLACK = 2.0**-8, 2.0**-15, 1e-6
S, KV = 512, 2


def _cache(rng, kind, B, S, Dh):
    """kq, ks, vq, vs as numpy arrays (K8V4: vq packed, vs parity-split)."""
    def sc(*shape):
        return (rng.random(shape, dtype=np.float32) * 1e-2 + 1e-3).astype(np.float32)

    kq = rng.integers(-127, 128, (B, KV, S, Dh), dtype=np.int8)
    if kind == "k8v4":
        return [kq, sc(B, KV, S), rng.integers(-128, 128, (B, KV, S // 2, Dh), dtype=np.int8),
                sc(B, KV, 2, S // 2)]
    return [kq, sc(B, KV, S), rng.integers(-127, 128, (B, KV, S, Dh), dtype=np.int8),
            sc(B, KV, S)]


def _plain(kind, q, cache, lengths, v_abs=False, **kw):
    """The plain version; with ``v_abs`` over |v|: sum_c |p vs v| / l."""
    kq, ks, vq, vs = cache
    if kind == "k8v4":
        vq, vs = A.unpack_v4(vq, vs)
    if v_abs:
        vq = vq.abs()
    return A.int8_kv_attention_ref(q, kq, ks, vq, vs, lengths, **kw)


def _run(kind, seed, Dh, group, T, lens, *, S=S, q_gain=1.0, sink_scale=1.0, learned=False,
         jax_fn=None, with_jax=True, **kw):
    """One random case: a dict of numpy f32 arrays. "f32", "one", "bf16",
    "three": the spelling at lane f32, at one bf16 term (q on the bf16 grid,
    "plain1" its plain version, "mass1" its sum |p vs v| / l), at the
    kernel's terms for bf16 q (the same q) and at three terms (f32 q, as
    "plain", "mass"); "jax" the JAX function's, without ``with_jax`` None.
    ``kw`` takes the variants (``k_positions`` as a numpy array; ``alibi``
    True for BLOOM's slopes)."""
    rng = np.random.default_rng(seed)
    B, H = len(lens), KV * group
    lengths = np.array(lens, np.int32)
    cache = _cache(rng, kind, B, S, Dh)
    cache[1][:, :, :kw.get("sinks", 0)] *= sink_scale
    q = (rng.standard_normal((B, T, H, Dh)) * q_gain).astype(np.float32)
    if learned:
        kw["sink_logits"] = rng.standard_normal(H).astype(np.float32) * 2
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = alibi_slopes(H).numpy()
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    t_cache = [torch.from_numpy(x) for x in cache]
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    tq1 = tq.to(torch.bfloat16).float()  # q on the bf16 grid
    v4 = kind == "k8v4"
    tiles = lambda qq, ll=tl, **lk: A.dense_attention_tiles_ref(qq, *t_cache, ll, v4=v4,
                                                                **lk, **tkw)
    got = {"f32": tiles(tq, lane=torch.float32), "one": tiles(tq1, terms=1),
           "bf16": tiles(tq1, terms=A.prefill_terms(torch.bfloat16)),
           "three": tiles(tq, terms=3),
           "plain": _plain(kind, tq, t_cache, tl, **tkw),
           "plain1": _plain(kind, tq1, t_cache, tl, **tkw),
           "mass": _plain(kind, tq, t_cache, tl, v_abs=True, **tkw),
           "mass1": _plain(kind, tq1, t_cache, tl, v_abs=True, **tkw),
           # a planted fault: every row one position later
           "shifted": tiles(tq, tl + 1, lane=torch.float32),
           "shifted1": tiles(tq1, tl + 1, terms=1)}
    got = {k: v.float().numpy() for k, v in got.items()}
    got["jax"] = None
    if with_jax:
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        jargs = [jnp.asarray(x) for x in (q, *cache, lengths)]
        if jax_fn is not None:
            out = jax_fn(*jargs, **jkw)
        elif v4:
            out = j_mixed_attention(*jargs, interpret=True, **jkw)
        else:
            out = j_int8_attention(*jargs, interpret=True, **jkw)
        got["jax"] = np.asarray(out, np.float32)
    return got


def _check(got):
    """Every lane against its tolerance; the planted fault misses each."""
    np.testing.assert_allclose(got["f32"], got["plain"], rtol=TOL_PLAIN, atol=TOL_PLAIN)
    if got["jax"] is not None:
        np.testing.assert_allclose(got["f32"], got["jax"], rtol=TOL_JAX, atol=TOL_JAX)
    bound1 = ONE_TERM * got["mass1"] + SLACK
    err1 = np.abs(got["one"] - got["plain1"])
    assert (err1 <= bound1).all(), (err1 - bound1).max()
    for key, plain, mass in (("bf16", "plain1", "mass1"), ("three", "plain", "mass")):
        err, bound = np.abs(got[key] - got[plain]), SPLIT_TERMS * got[mass] + SLACK
        assert (err <= bound).all(), (key, (err - bound).max())
    shifted = np.abs(got["shifted"] - got["plain"])
    assert (shifted > 10 * TOL_PLAIN * (1 + np.abs(got["plain"]))).any()  # 10x the tolerance
    assert not (np.abs(got["shifted1"] - got["plain1"]) <= bound1).all()
    return err1.max() / np.abs(got["plain1"]).max()


@pytest.mark.parametrize("group,T", [(1, 64), (1, 97), (1, 300), (8, 64), (8, 300)])
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_tiles_across_row_blocks(Dh, group, T):
    """Chunks of 64 to 2400 query rows a kv head (one block, a ragged second
    one, 5 to 38 blocks), full causal, at each head dim: the walk's tiles
    end at each block's last row; one bf16 term moves the output by a small
    share of its scale."""
    lens = [0, 137]
    rel = _check(_run("int8", Dh + group + T, Dh, group, T, lens))
    assert 0 < rel < 2.0**-7  # the bf16 lane rounds, within chip_smoke.py's ATTN_TOL


@pytest.mark.parametrize("group", [1, 2])
def test_window_edge_inside_a_block(group):
    """A window of 40 over 100 rows of a prefill chunk at lengths 0 and 300:
    the rows of one block start their windows in different tiles, so the
    block walks from its first row's tile and masks the rest."""
    _check(_run("int8", 5 + group, 64, group, 100, [0, 300], window=40))


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("sinks", [0, 4])
def test_ring_positions(sinks, alibi):
    """A ring of 256 columns, window 128, a 70-row chunk (4 rows a kv head at
    Dh 128, Mistral's group): a row inside the ring (columns never
    written) and one wrapped many times, with StreamingLLM sinks and
    ALiBi; every tile is walked."""
    C, T, lens = 256, 70, [30, 3000]
    k_pos = ring_positions(torch.tensor(lens, dtype=torch.int32) + T, C, sinks).numpy()
    got = _run("int8", 17 + sinks + alibi, 128, 4, T, lens, S=C, window=128, k_positions=k_pos,
               sinks=sinks, sink_scale=10.0, alibi=alibi)
    _check(got)
    as_columns = _run("int8", 17 + sinks + alibi, 128, 4, T, lens, S=C, window=128, sinks=sinks,
                      sink_scale=10.0, alibi=alibi, with_jax=False)["plain"]
    assert np.abs(got["plain"] - as_columns).max() > 100 * TOL_JAX  # the positions are read


def test_streaming_sinks_on_contiguous_cache():
    """70 StreamingLLM sinks (two 64-key tiles) with a window of 40 over a
    contiguous cache: each block walks the sink tiles first, then skips to
    its window. Held to the XLA formulation, not the Pallas kernel (fault
    F2: the Pallas kernel drops the sinks here)."""
    lens = [300, 400]
    got = _run("int8", 13, 64, 2, 70, lens, window=40, sinks=70, sink_scale=10.0,
               jax_fn=j_int8_attention_xla)
    _check(got)
    without = _run("int8", 13, 64, 2, 70, lens, window=40, with_jax=False)["plain"]
    assert np.abs(got["plain"] - without).max() > 100 * TOL_JAX  # the sinks bite


def test_alibi_after_softcap():
    """ALiBi subtracted after the softcap, with a score scale (q drawn large
    so the cap bites)."""
    lens = [37, 290]
    kw = dict(alibi=True, softcap=2.0, scale=0.0625, q_gain=100.0)
    got = _run("int8", 23, 128, 1, 70, lens, **kw)
    _check(got)
    uncapped = _run("int8", 23, 128, 1, 70, lens, alibi=True, scale=0.0625, q_gain=100.0,
                    with_jax=False)["plain"]
    assert np.abs(got["plain"] - uncapped).max() > 100 * TOL_JAX  # the cap bites


@pytest.mark.parametrize("window", [0, 8])
def test_learned_sinks(window):
    """GPT-OSS's learned sinks (group 8, Dh 64) as each row's initial state;
    with a window of 8 a row sees 8 keys, and whole tiles of a block are
    masked for some of its rows."""
    _check(_run("int8", 29 + window, 64, 8, 70, [20, 300], window=window, learned=True))


@pytest.mark.parametrize("Dh,group", [(64, 8), (128, 1), (256, 2)])
def test_k8v4_with_score_scale(Dh, group):
    """The K8V4 cache (nibbles unpacked at the tile's conversion, each
    token's scale from its parity's plane) with its only variant, a score
    scale of 0.1, at odd and even lengths."""
    got = _run("k8v4", 31 + Dh, Dh, group, 70, [3, 255], scale=0.1)
    _check(got)
    unscaled = _run("k8v4", 31 + Dh, Dh, group, 70, [3, 255], with_jax=False)["plain"]
    assert np.abs(got["plain"] - unscaled).max() > 100 * TOL_JAX  # the scale bites


@pytest.mark.parametrize("kind", ["int8", "k8v4"])
def test_padded_chunk_past_S(kind):
    """A padded chunk whose last rows sit past the capacity: the walk is
    clamped at S and those rows see every key."""
    _check(_run(kind, 37, 64, 2, 100, [S - 10, S - 100]))


def test_tile_and_terms_are_the_kernels():
    """The key tile and the bf16 terms are the kernel's (ApGeom::KT,
    ApTerms in csrc/attn_prefill.cuh)."""
    assert [A.prefill_key_tile(d) for d in (32, 64, 128, 256)] == [64, 64, 128, 32]
    assert [A.prefill_terms(t) for t in (torch.bfloat16, torch.float16, torch.float32)] == [
        (1, 3), (2, 3), (3, 3)]
