"""Launch plans shared by the weight GEMMs' kernels: the split-K decode
kernels on ``csrc/int4_decode.cuh`` (the int4 bodies' and
``csrc/wo_decode.cu``), the ring reduce-scatter matmul
(``csrc/collective_matmul.cu``, on ``csrc/int8_mma.cuh``) and the register-A
tile kernels of ``csrc/int4_tile_sm90.cuh`` (the int4 bodies' and the
weight-only int8 body's). Each body's module gives its own unit of K and its
cost constants; this one holds the geometry the kernels share and the rules
that pick a plan.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# The decode kernels: weight rows a block (a tile), the most blocks a
# cluster splits K over.
DECODE_ROWS = 64
DECODE_MAX_SPLITS = 8
# The ring kernel: the blocks an SM its plan aims for, by route (from the
# split sweep of tools/gemm_timing.py --ring: at decode the ring's flags and
# cluster barriers cost more a block than the loads gain past ~1 block an
# SM; the prefill route's products want ~2 blocks an SM).
RING_BLOCKS_PER_SM = {"decode": 1.0, "prefill": 2.25}
# The tile kernels: weight rows a block, the cluster sizes K splits over, and
# the clusters of each size an H100 holds at once
# (cudaOccupancyMaxActiveClusters of a one-block-an-SM kernel; its GPCs' SM
# counts are not all multiples of the size).
TILE_ROWS = 128
TILE_SPLITS = (1, 2, 3, 4, 6, 8)
TILE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 6: 17, 8: 15}
# cudaOccupancyMaxActiveClusters of each decode kernel instance, by (card,
# entry, token fragments, the entry's other arguments): {cluster size:
# clusters the card holds at once}
_held: dict = {}


def decode_plan(n: int, units: int, held: dict) -> int:
    """A decode kernel's K splits (1 to 8: the blocks of a cluster) for
    ``n`` weight rows and ``units`` units of K: of the splits that leave
    each at least two units, the one with the most blocks (a tile of
    ``DECODE_ROWS`` weight rows, times the splits) whose clusters, one a
    tile, the card holds at once (``held[splits]``, :func:`decode_held`);
    where none fits one wave, 1."""
    tiles = -(-n // DECODE_ROWS)
    fits = [s for s in range(1, DECODE_MAX_SPLITS + 1)
            if (s == 1 or 2 * s <= units) and tiles <= held[s]]
    return max(fits, default=1)


def ring_plan(clusters: int, units: int, held: dict, sms: int, per_sm: float):
    """The ring kernel's K splits (1 to 8: the blocks of a cluster) for a
    launch of ``clusters`` clusters (a cluster a tile of ``DECODE_ROWS``
    columns of a chunk and a rank) over ``units`` 64-byte steps of a rank's
    K: :func:`decode_plan`'s rule (the most blocks whose clusters the card
    holds at once, ``held``, each split at least two units) over the splits
    whose blocks stay within ``per_sm`` (``RING_BLOCKS_PER_SM`` of the
    route) of each of ``sms`` SMs, and one split where even that is more.
    None where not even clusters of one block all fit at once: every block
    of the ring spins on others, so the launch must be resident whole (CUDA
    refuses it)."""
    if clusters > held[1]:
        return None
    target = per_sm * sms
    within = {s: held[s] if s == 1 or clusters * s <= target else 0 for s in held}
    return decode_plan(DECODE_ROWS * clusters, units, within)


def decode_held(entry: str, dev, m: int, *args) -> dict:
    """{splits: clusters of that many blocks the card holds at once} of the
    decode kernel instance that ``entry`` launches for ``m`` rows (1, 2 or
    4 fragments of 8 tokens): :func:`held_clusters` with the instance's
    rows and ``args``."""
    mf = 1 if m <= 8 else 2 if m <= 16 else 4
    return held_clusters(entry, dev, mf * 8, *args)


def held_clusters(entry: str, dev, *args) -> dict:
    """{splits: clusters of that many blocks the card holds at once} as the
    built library's ``entry + "_clusters"`` (``args``, splits, the count's
    address) answers it, asked once per card, entry and ``args``."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, entry, args)
    if key not in _held:
        query, held = getattr(_build.lib(), entry + "_clusters"), {}
        with torch.cuda.device(index):
            for s in range(1, DECODE_MAX_SPLITS + 1):
                count = ctypes.c_int(0)
                _build.check(query(*args, s, ctypes.byref(count)), entry + "_clusters")
                held[s] = count.value
        _held[key] = held
    return _held[key]


def tile_plan(m: int, n: int, stages: int, units: int, sms: int, stage_us: dict,
              fixed_us: tuple, min_units: int, share: float = 1.0,
              splits_taken: tuple = TILE_SPLITS):
    """The (tokens a tile, K splits) of least cost of a tile kernel (one
    block of ``TILE_ROWS`` weight rows an SM) for an [m, k] x [n, k]^T
    product of ``stages`` K stages in ``units`` units: of the token tiles
    (``stage_us``'s keys, microseconds a block's stage with every SM busy)
    and the splits of K over a cluster (``splits_taken``, by default every
    one of ``TILE_SPLITS``, at most ``TILE_CLUSTERS`` clusters of a size)
    that leave each split at least ``min_units`` units, the least waves times a block's cost (stages /
    splits x the stage's cost + f0 + f1 x splits, (f0, f1) = ``fixed_us``),
    the fewer splits and then the taller tile on a tie. ``share`` of a
    stage's cost holds however few SMs a wave fills, the rest scales with
    the busy share of the SMs (1: none scales)."""
    tiles_n = -(-n // TILE_ROWS)
    f0, f1 = fixed_us
    best = None
    for tokens, stage in stage_us.items():
        tiles = -(-m // tokens) * tiles_n
        for splits in splits_taken:
            if splits > 1 and units < splits * min_units:
                continue
            wave = splits * min(sms // splits, TILE_CLUSTERS[splits])
            load = share + (1 - share) * min(tiles * splits, wave) / sms
            cost = (-(-tiles * splits // wave)
                    * (stages / splits * stage * load + f0 + f1 * splits))
            key = (round(cost, 6), splits, -tokens)
            if best is None or key < best[0]:
                best = (key, (tokens, splits))
    return best[1]


def tile_blocks(m: int, n: int, tokens: int, slices: list) -> list:
    """The (tokens, weight rows, K range) of each block of a tile launch of
    ``tokens`` a tile, in grid order: ``TILE_ROWS``-row weight tiles of [0,
    n), each over the token tiles of [0, m), each over the K ranges
    ``slices`` of its cluster's splits."""
    return [((m0, min(m, m0 + tokens)), (n0, min(n, n0 + TILE_ROWS)), ks)
            for n0 in range(0, n, TILE_ROWS) for m0 in range(0, m, tokens) for ks in slices]
