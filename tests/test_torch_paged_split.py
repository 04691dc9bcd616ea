"""The split-S decomposition of the paged int8 decode attention
(``csrc/attn_split.cuh`` with its paged addressing), spelled out in plain
PyTorch by ``paged_attention_partials_ref`` and ``merge_partials_ref``,
against the plain version and the JAX package.

The partials cover the table's max_pages * page_size virtual columns in
splits of the kernel's span (128 columns), each column read from the pool
through the table (an unmapped entry, -1, reads page 0); a split past a
row's length is empty. The merged result is held to the plain version
(``paged_int8_attention_ref``) at rtol = atol = 1e-5 (the same f32 sums
regrouped), and to the JAX ``paged_int8_attention`` in interpret mode at
2e-5, ``test_torch_paged.py``'s ATOL. Pools and tables are random arrays
made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoquant_tpu.ops.paged_attention import paged_int8_attention as j_paged_attention
from protoquant_tpu_torch.models.llama import alibi_slopes
from protoquant_tpu_torch.ops import attention as A
from protoquant_tpu_torch.ops import paged_attention as PA

TOL_PLAIN, TOL_JAX = 1e-5, 2e-5
KV = 2
SPAN = PA.SPLIT_SPAN  # the split kernel's span (AsGeom::SPAN in csrc/attn_split.cuh)


def _case(seed, ps, group, Dh, lens, width, unmapped=()):
    """q, the pools, the table and the lengths as numpy arrays: shuffled
    distinct pages below the last two, rows in ``unmapped`` all -1, each
    row's entries past its last key -1 too (pages a row never reached)."""
    rng = np.random.default_rng(seed)
    B, max_pages = len(lens), width // ps
    P = B * max_pages + 2
    kq = rng.integers(-127, 128, (P, KV, ps, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (P, KV, ps, Dh)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (P, KV, 1, ps)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (P, KV, 1, ps)).astype(np.float32)
    pt = rng.permutation(P - 2)[:B * max_pages].reshape(B, max_pages).astype(np.int32)
    for b, ln in enumerate(lens):
        pt[b, ln // ps + 1:] = -1
    for b in unmapped:
        pt[b] = -1
    q = rng.standard_normal((B, 1, KV * group, Dh)).astype(np.float32)
    return [q, kq, ks, vq, vs, pt, np.array(lens, np.int32)]


def _run(args, alibi):
    t = [torch.from_numpy(a) for a in args]
    H = args[0].shape[2]
    slopes = alibi_slopes(H) if alibi else None
    acc, m, l = PA.paged_attention_partials_ref(*t, span=SPAN, alibi_slopes=slopes)
    merged = A.merge_partials_ref(acc, m, l, H).numpy()
    plain = PA.paged_int8_attention_ref(*t, alibi_slopes=slopes).numpy()
    jkw = {"alibi_slopes": jnp.asarray(slopes.numpy())} if alibi else {}
    want = np.asarray(j_paged_attention(*map(jnp.asarray, args), interpret=True, **jkw))
    np.testing.assert_allclose(merged, plain, rtol=TOL_PLAIN, atol=TOL_PLAIN)
    np.testing.assert_allclose(merged, want, rtol=TOL_JAX, atol=TOL_JAX)
    return acc, m, l


def _lengths(ps, width):
    """A row of length 0 (unmapped), the last key of the first page, the
    first of the second, the last key of the first split, the first of the
    second, and a full table."""
    return [0, ps - 1, ps, SPAN - 1, SPAN, width - 1]


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("group,Dh", [(1, 64), (4, 32), (8, 64)])
@pytest.mark.parametrize("ps", [8, 16, 128, 256])
def test_paged_split_edges_vs_plain_and_pallas(ps, group, Dh, alibi):
    """Lengths at page and split edges, an unmapped row of length 0, pages
    of 8 and 16 keys (a split spans pages) and of 128 and 256 (a page spans
    splits), G 1, 4 and 8, ALiBi on and off: the merged partials equal the
    plain version and the Pallas kernel; the splits past each row's last
    key are empty."""
    width = max(3 * SPAN, 2 * ps)
    lens = _lengths(ps, width)
    args = _case(ps + 10 * group + Dh + alibi, ps, group, Dh, lens, width, unmapped=(0,))
    acc, m, l = _run(args, alibi)
    n_split = width // SPAN
    assert acc.shape == (len(lens), KV, n_split, group, Dh)
    for b, ln in enumerate(lens):
        live = torch.nonzero(l[b].amax(dim=(0, 2)) > 0).flatten().tolist()
        assert live == list(range(ln // SPAN + 1)), (ln, live)
    dead = l == 0
    assert torch.all(m[dead] == A.NEG_INF) and not acc[dead].any()


@pytest.mark.parametrize("ps", [8, 128])
def test_paged_split_unmapped_entries_read_page_zero(ps):
    """Entries of -1 inside a row's length read page 0, as the Pallas
    kernel's index map clamps them, in both the split and the plain
    version; a row whose table is all -1 sees page 0's keys at every
    entry."""
    width = 2 * SPAN
    lens = [width - 1, 3 * ps // 2, width - 1]
    args = _case(ps + 7, ps, 2, 64, lens, width)
    args[5][0, 1] = -1  # a hole in row 0's chain
    args[5][2] = -1  # row 2 wholly unmapped
    _run(args, alibi=False)


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_paged_split_plan_and_workspace(Dh):
    """The plan refuses the rows a block cannot hold (G > 4 at Dh 256, G > 8
    at 128, G > 16 at 64) and covers the table's width otherwise; the
    workspace the wrapper makes has the partials' shapes."""
    most = {64: 16, 128: 8, 256: 4}[Dh]
    for group in (1, 2, 4, 8):
        plan = PA.paged_split_plan(KV * group, KV, 8, 128, Dh)
        if group > most:
            assert plan is None
            continue
        assert plan == (SPAN, 8)
        acc_shape, ml_shape = PA.paged_split_workspace(3, KV * group, KV, Dh, plan)
        assert acc_shape == (3, KV, 8, group, Dh) and ml_shape == (3, KV, 8, group, 2)
    assert PA.paged_split_plan(KV * (most + 1), KV, 8, 128, Dh) is None
    assert PA.paged_split_plan(KV, KV, 5, 8, Dh) == (SPAN, 1)  # 40 columns
    assert PA.paged_split_plan(KV, KV, 9, 16, Dh) == (SPAN, 2)  # 144 columns
    assert PA.paged_split_plan(KV, KV, 3, 256, Dh) == (SPAN, 6)
    assert PA.paged_split_plan(KV, KV, 2049, 128, Dh) is None  # past the merge's splits


def test_paged_split_workspace_matches_the_partials():
    """The workspace shapes are those of ``paged_attention_partials_ref``'s
    acc and (m, l) at a 7B-like shape, cut small."""
    args = _case(5, 16, 4, 64, [40, 200, 300], 320)
    t = [torch.from_numpy(a) for a in args]
    plan = PA.paged_split_plan(KV * 4, KV, 20, 16, 64)
    acc, m, l = PA.paged_attention_partials_ref(*t, span=plan[0])
    acc_shape, ml_shape = PA.paged_split_workspace(3, KV * 4, KV, 64, plan)
    assert tuple(acc.shape) == acc_shape and tuple(m.shape) + (2,) == ml_shape
    assert tuple(l.shape) == tuple(m.shape)


def test_paged_split_dropped_split_is_caught():
    """A planted fault, as ``chip_smoke.py`` plants it: each row's last live
    split dropped moves the output far past the tolerance."""
    args = _case(9, 16, 1, 64, [300, 130, 383], 384)
    t = [torch.from_numpy(a) for a in args]
    acc, m, l = PA.paged_attention_partials_ref(*t, span=SPAN)
    idx = torch.arange(l.shape[2])[None, None, :, None]
    last = torch.where(l > 0, idx, -1).amax(dim=2, keepdim=True)
    dropped = A.merge_partials_ref(acc, m, torch.where(idx == last, 0.0, l), 2)
    plain = PA.paged_int8_attention_ref(*t)
    assert (dropped - plain).abs().max() > 100 * TOL_JAX
