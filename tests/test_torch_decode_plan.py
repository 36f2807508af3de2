"""The decode kernel's work split, held on the CPU.

``decode_attn.cu`` plans on the card from ``lengths``: every (sequence,
kv head) row holds ``ceil(live / block_k)`` tiles, CTA c takes the global
tiles [c T / n, (c + 1) T / n), and its part of one row is a piece whose
partial the combine kernel merges. ``decode_attn.py`` mirrors that plan
(``work_plan``). Here: every live position lands in exactly one piece; a
``len <= 0`` row covers all S; pieces are whole tiles but for a row's
last; every CTA's share is within one tile of the mean; one long row at
B 1 spreads over at least ``n_sms`` pieces; the partials' scratch bound
holds; merging the pieces' online-softmax states in order gives the plain
version's output; and the mirror's constant matches the source's.
"""

import math
import pathlib
import re
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attn import decode_attn as dk
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

SOURCE = pathlib.Path(dk.__file__).resolve().parents[1] / "csrc" \
    / "decode_attn.cu"
GRANITE_LENS = [2733, 32768, 9846, 19649, 13124, 21244, 30404, 32104]
# (lengths, kv heads, S, block_k, CTAs)
CASES = [
    (GRANITE_LENS, 8, 32768, 1024, 132),
    (GRANITE_LENS, 8, 32768, 128, 132),
    ([0, 1, 333, 1000, 1024], 2, 1024, 128, 132),
    ([0, -5, 0], 2, 512, 256, 132),
    ([127, 128, 129], 2, 2048, 128, 132),
    ([1023, 1024, 1025], 2, 2048, 1024, 132),
    ([32768], 1, 32768, 128, 132),
    ([1000, 7], 1, 1000, 125, 3),
]
CASE_IDS = ["granite-1024", "granite-128", "ragged", "all-le-0",
            "bk128-pm1", "bk1024-pm1", "b1-long-row", "few-ctas"]


def _constant(name: str) -> int:
    m = re.search(rf"constexpr (?:int|float) {name} = ([0-9]+);",
                  SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def _live(n, s):
    return min(n, s) if n > 0 else s


def test_max_block_k_matches_the_source():
    """The wrapper refuses a block_k above the one the ring leaves room
    for."""
    assert _constant("kMaxBlockK") == dk.MAX_BLOCK_K
    assert "G * kMaxBlockK" in SOURCE.read_text()


@pytest.mark.parametrize("lens,hkv,s,bk,n", CASES, ids=CASE_IDS)
def test_every_live_position_in_exactly_one_piece(lens, hkv, s, bk, n):
    seen = Counter()
    for p in dk.work_plan(lens, hkv, s, bk, n):
        assert 0 <= p.lo < p.hi <= _live(lens[p.b], s)
        seen.update((p.b, p.kvh, x) for x in range(p.lo, p.hi))
    want = {(b, h, x) for b, ln in enumerate(lens) for h in range(hkv)
            for x in range(_live(ln, s))}
    assert set(seen) == want
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("lens,hkv,s,bk,n", CASES, ids=CASE_IDS)
def test_pieces_are_whole_tiles_but_a_rows_last(lens, hkv, s, bk, n):
    for p in dk.work_plan(lens, hkv, s, bk, n):
        assert p.lo % bk == 0
        assert p.hi % bk == 0 or p.hi == _live(lens[p.b], s)


def test_a_row_of_length_le_0_covers_all_of_s():
    plan = dk.work_plan([0, 5, -3], 2, 700, 128, 4)
    for b in (0, 2):
        for h in range(2):
            got = sorted((p.lo, p.hi) for p in plan if (p.b, p.kvh) == (b, h))
            assert got[0][0] == 0 and got[-1][1] == 700
    assert [(p.lo, p.hi) for p in plan if p.b == 1] == [(0, 5), (0, 5)]


@pytest.mark.parametrize("lens,hkv,s,bk,n", CASES, ids=CASE_IDS)
def test_every_cta_within_one_tile_of_the_mean(lens, hkv, s, bk, n):
    tiles = Counter()
    for p in dk.work_plan(lens, hkv, s, bk, n):
        tiles[p.cta] += -(-(p.hi - p.lo) // bk)
    total = hkv * sum(-(-_live(ln, s) // bk) for ln in lens)
    assert sum(tiles.values()) == total
    shares = [tiles[c] for c in range(n)]
    assert max(shares) - total / n <= 1
    assert total / n - min(shares) <= 1


def test_one_long_row_spreads_over_the_sms():
    for n_sms in (16, 132):
        plan = dk.work_plan([32768], 1, 32768, 128, n_sms)
        assert len(plan) >= n_sms
        assert len({p.cta for p in plan}) >= n_sms
        assert [p.piece for p in plan] == list(range(len(plan)))


@pytest.mark.parametrize("lens,hkv,s,bk,n", CASES, ids=CASE_IDS)
def test_scratch_bound_holds(lens, hkv, s, bk, n):
    plan = dk.work_plan(lens, hkv, s, bk, n)
    bound = dk.max_pieces(s, bk, n)
    per_row = Counter((p.b, p.kvh) for p in plan)
    assert max(per_row.values()) <= bound
    for row in per_row:
        assert sorted(p.piece for p in plan if (p.b, p.kvh) == row) \
            == list(range(per_row[row]))
    # the bound reads only the shape
    assert bound == max(1, min(n, math.ceil(s / bk)))


def _merge_pieces(q, k, v, lens, bk, n):
    """The kernel's arithmetic in float64 numpy: each piece's online
    softmax, one rescale per tile, then the combine in piece order."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    parts = {}
    for p in dk.work_plan(lens, hkv, s, bk, n):
        for j in range(g):
            hh = p.kvh * g + j
            m, l, acc = -np.inf, 0.0, np.zeros(d)
            for t0 in range(p.lo, p.hi, bk):
                pos = np.arange(t0, min(t0 + bk, p.hi))
                sc = k[p.b, pos, p.kvh] @ q[p.b, hh] / math.sqrt(d)
                sc = np.where(pos < lens[p.b], sc, -1e30)
                m_new = max(m, sc.max())
                pr = np.exp(sc - m_new)
                alpha = np.exp(m - m_new)
                l = l * alpha + pr.sum()
                acc = acc * alpha + pr @ v[p.b, pos, p.kvh]
                m = m_new
            parts.setdefault((p.b, hh), []).append((p.piece, m, l, acc))
    out = np.zeros((b, h, d))
    for (bb, hh), ps in parts.items():
        ps.sort(key=lambda x: x[0])
        mx = max(x[1] for x in ps)
        ll = sum(x[2] * np.exp(x[1] - mx) for x in ps)
        out[bb, hh] = sum(x[3] * np.exp(x[1] - mx) for x in ps) / max(ll,
                                                                    1e-30)
    return out


@pytest.mark.parametrize("lens,bk,n", [
    ([0, 1, 70, 200], 64, 5), ([200, 200, 13, 0], 32, 7),
    ([-2, 150], 128, 3), ([256], 16, 9)])
def test_merged_pieces_equal_the_plain_version(lens, bk, n):
    rng = np.random.RandomState(sum(lens) + bk)
    b, s, hkv, g, d = len(lens), 256, 2, 4, 64
    q = rng.randn(b, hkv * g, d)
    k, v = rng.randn(b, s, hkv, d), rng.randn(b, s, hkv, d)
    got = _merge_pieces(q, k, v, np.array(lens), bk, n)
    want = decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor(lens, dtype=torch.int32)).numpy()
    # the plain version computes in float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
