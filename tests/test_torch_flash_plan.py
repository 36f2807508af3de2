"""The bf16 flash kernel's launch plan, held on the CPU.

The wrapper computes the launch (threads, ring stages, shared memory,
grid) in Python and hands it to the C entry point, which refuses a plan
that does not fit. Here: the plan fits one H100 block's shared memory for
every head_dim and kv tile the kernel is built for, keeps a ring of at
least two stages, and matches the source's constants; the 64-row
warpgroup tiles sit at multiples of 64 and store each query row of every
clamped ``block_q`` exactly once; ``block_k`` clamps to a tile the kernel
takes, also for a sequence it does not divide.
"""

import pathlib
import re

import pytest
import torch

from repro_torch.kernels import api, build
from repro_torch.kernels.flash_attn import flash_attn as fkern

BF16 = build.DTYPE_CODES["bfloat16"]
F32 = build.DTYPE_CODES["float32"]
SOURCE = pathlib.Path(fkern.__file__).resolve().parents[1] / "csrc" \
    / "flash_attn.cu"
SEQS = [1, 77, 100, 1000, 1024, 8192]


def _constant(name: str) -> int:
    """An integer constant of the source: a literal, or arithmetic on the
    constants defined before it."""
    text = SOURCE.read_text()
    m = re.search(rf"constexpr int {name} = ([0-9A-Za-z_ *()+]+);", text)
    assert m, name
    expr = re.sub(r"k[A-Z]\w*", lambda n: str(_constant(n.group(0))),
                  m.group(1))
    assert re.fullmatch(r"[0-9 *()+]+", expr), expr
    return int(eval(expr))


def warpgroup_tiles(s, block_q):
    """The bf16 kernel's walk (``flash_bf16_kernel``): a CTA's rows
    [q_lo, q_hi) lie in 64-row groups g_first .. g_last, taken two at a
    time, consumer c taking group g_first + 2t + c of tile t; returns
    (cta, consumer, first row of the group, rows it stores)."""
    out = []
    for cta in range(-(-s // block_q)):
        q_lo, q_hi = cta * block_q, min(cta * block_q + block_q, s)
        g_first, g_last = q_lo // 64, (q_hi - 1) // 64
        for t in range((g_last - g_first) // 2 + 1):
            for c in range(2):
                gi = g_first + 2 * t + c
                if gi <= g_last:
                    r0 = gi * 64
                    out.append((cta, c, r0, min(r0 + 64, q_hi)
                                - max(r0, q_lo)))
    return out


def _operands(s, d=64):
    q = torch.zeros(1, 4, s, d, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, s, d, dtype=torch.bfloat16)
    return q, kv, kv


@pytest.mark.parametrize("name,value", [
    ("kWgRows", fkern.WG_ROWS), ("kConsumers", fkern.CONSUMERS),
    ("kBf16Threads", fkern.BF16_THREADS), ("kThreads", fkern.F32_THREADS),
    ("kSmemAlign", fkern.SMEM_ALIGN), ("kSmemMax", fkern.SMEM_LIMIT)])
def test_constants_match_the_source(name, value):
    assert _constant(name) == value


@pytest.mark.parametrize("block_k", fkern.KERNEL_BLOCK_K)
@pytest.mark.parametrize("d", fkern.HEAD_DIMS)
def test_bf16_plan_fits_one_block(d, block_k):
    plan = fkern.launch_plan(2, 32, 8192, d, 128, block_k, BF16)
    assert plan.threads == 384
    assert 2 <= plan.stages <= fkern.MAX_STAGES
    assert plan.smem == fkern.bf16_smem_bytes(d, block_k, plan.stages)
    assert plan.smem <= 232448
    # the deepest ring that fits: one more stage would not
    if plan.stages < fkern.MAX_STAGES:
        assert fkern.bf16_smem_bytes(d, block_k, plan.stages + 1) > 232448
    assert plan.grid == (64, 64)


def test_bf16_plan_at_full_width():
    """Granite-3-8B prefill at the tuned 128-wide kv tile: 32 KB of query
    rows and three 64 KB K/V stages."""
    plan = fkern.launch_plan(1, 32, 8192, 128, 128, 128, BF16)
    assert plan.stages == 3
    assert plan.smem == 1024 + 32768 + 3 * 65536 + 8 * 8


@pytest.mark.parametrize("block_k", fkern.KERNEL_BLOCK_K)
def test_f32_plan(block_k):
    plan = fkern.launch_plan(1, 4, 1000, 128, 8, block_k, F32)
    assert plan.threads == 128 and plan.stages == 1
    assert plan.smem == 2 * block_k * 128 * 4 <= 232448
    assert plan.grid == (125, 4)


@pytest.mark.parametrize("s", SEQS)
def test_warpgroup_tiles_cover_each_row_once(s):
    op = api.get_op("flash_attn")
    for bq in api.clamped_axes(op, *_operands(s))["block_q"]:
        tiles = warpgroup_tiles(s, bq)
        stored = []
        for cta, c, r0, rows in tiles:
            assert r0 % 64 == 0 and r0 < s and c in (0, 1)
            assert rows >= 1
            lo, hi = max(r0, cta * bq), min(r0 + 64, (cta + 1) * bq, s)
            assert rows == hi - lo
            stored.extend(range(lo, hi))
        assert sorted(stored) == list(range(s)), (s, bq)
        assert len(set((cta, r0) for cta, _, r0, _ in tiles)) == len(tiles)


def test_warpgroup_tiles_pair_the_groups():
    """block_q 256: each CTA walks two 128-row tiles, consumer 0 taking
    the even group, consumer 1 the odd one."""
    tiles = warpgroup_tiles(512, 256)
    assert tiles == [(0, 0, 0, 64), (0, 1, 64, 64), (0, 0, 128, 64),
                     (0, 1, 192, 64), (1, 0, 256, 64), (1, 1, 320, 64),
                     (1, 0, 384, 64), (1, 1, 448, 64)]
    # a block of 8 rows stores 8 rows of one group, on consumer 0
    assert warpgroup_tiles(1000, 8)[9] == (9, 0, 64, 8)


@pytest.mark.parametrize("s", SEQS)
def test_block_k_clamps_to_a_kernel_tile(s):
    op = api.get_op("flash_attn")
    axes = api.clamped_axes(op, *_operands(s))
    assert set(axes["block_k"]) <= set(fkern.KERNEL_BLOCK_K)
    for bq in axes["block_q"]:
        assert s % bq == 0
    if s >= 128:
        assert axes["block_k"] == fkern.KERNEL_BLOCK_K


def test_block_k_clamp_keeps_divisors():
    """Where the tile divides S, the clamp is the JAX package's fit_block."""
    op = api.get_op("flash_attn")
    for s in (256, 1024, 8192):
        for bk in fkern.KERNEL_BLOCK_K:
            point = op.clamp({"block_q": 512, "block_k": bk},
                             *_operands(s))
            assert point["block_k"] == api.fit_block(bk, s)
