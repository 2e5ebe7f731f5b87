"""The W8A8 ``int8_linear`` kernel's schedule, modelled in numpy.

``kanvit_torch/kernels/csrc/int8_matmul.cu`` runs one block of 8 warps a
tile of ``rows_per_block(K)`` rows: the warps quantize the tile's rows into
shared memory (1, 2 or 4 rows a warp at a time, four values a lane), then walk
every output tile of ``BN`` columns, W streaming through a ring of
``STAGES`` stages of ``KC`` bytes of K, each warp's m16n8k32 fragments
written by its epilogue after a tile's last stage. The model here repeats
that walk from the kernel's own constants (read from its source, and held
equal to the wrapper's) and checks, at ``chip_smoke.py``'s shapes, at N 1,
31 and 33 and at ``MAX_K``: every (row, output) of y is written exactly
once and no row past N is; every row of a block is quantized once, every K
value of it once; every K step of every output tile multiplied once; no
ring slot refilled before its stage is consumed; the block's shared memory
within the card's.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from kanvit_torch.kernels import int8_matmul as IM

SRC = (Path(IM.__file__).resolve().parent / "csrc" / "int8_matmul.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr (?:int|float) {name} = (\d+)", SRC).group(1))


WARPS, QCHUNKS = _const("WARPS"), _const("QCHUNKS")


def _layout(bm):
    """(MT, WM, WN, NT) as the kernel derives them from its rows a block."""
    wm = bm // 32 if bm >= 64 else 1
    mt = bm // (16 * wm)
    wn = WARPS // wm
    return mt, wm, wn, IM.BN // (8 * wn)


def _tile_writes(bm):
    """How often each (row, column) of a block's BM x BN output tile is
    stored by the epilogue: warp (wm, wn), lane (g, tq), its MT x NT
    fragments' rows g, g + 8 and columns 2 tq, 2 tq + 1."""
    mt, wm, wn, nt = _layout(bm)
    local = np.zeros((bm, IM.BN), np.int64)
    for warp in range(WARPS):
        wmi, wni = warp % wm, warp // wm
        for lane in range(32):
            g, tq = lane >> 2, lane & 3
            for m in range(mt):
                for h in range(2):
                    row = wmi * mt * 16 + m * 16 + g + 8 * h
                    for j in range(nt):
                        col = wni * nt * 8 + j * 8 + 2 * tq
                        local[row, col:col + 2] += 1
    return local


def _rows_and_chunks(k):
    """(rows a warp quantizes at a time, 128-wide chunks of each in flight)
    as the kernel's ``quantize`` picks them from K."""
    for rows in (4, 2, 1):
        if k <= 128 * QCHUNKS // rows:
            return rows, QCHUNKS // rows
    return 4, QCHUNKS // 4


def _quantized(bm, k):
    """How often each (row, K index) of a block is quantized and stored:
    warp w's rows w R .. + R, then WARPS R on; lane l's chunks from 4 l in
    steps of 128, U a pass, stored where inside the row."""
    rows, chunks = _rows_and_chunks(k)
    seen = np.zeros((bm, k), np.int64)
    for warp in range(WARPS):
        for rb in range(warp * rows, bm, WARPS * rows):
            for q in range(rows):
                for lane in range(32):
                    for c0 in range(4 * lane, k, 128 * chunks):
                        for u in range(chunks):
                            c = c0 + 128 * u
                            if c < k:
                                seen[rb + q, c:c + 4] += 1
    return seen


def _walk(k, out):
    """The ring over (output tile, K chunk) stages: per tile, how often each
    32-deep K step is multiplied; the tiles whose epilogue runs, in order.
    Raises where a slot is refilled before its stage was consumed or a
    stage is consumed from a slot that does not hold it."""
    kchunks, tiles = k // IM.KC, out // IM.BN
    total = kchunks * tiles
    slots = [None] * IM.STAGES
    for i in range(IM.STAGES - 1):  # the prologue, before the quantization
        if i < total:
            slots[i % IM.STAGES] = i
    steps = np.zeros((tiles, k // 32), np.int64)
    epilogues = []
    for i in range(total):
        j = i + IM.STAGES - 1
        if j < total:
            held = slots[j % IM.STAGES]
            assert held is None or held < i, (i, j, held)  # consumed at i - 1 or before
            slots[j % IM.STAGES] = j
        assert slots[i % IM.STAGES] == i
        t, kc = divmod(i, kchunks)
        for ks in range(IM.KC // 32):
            steps[t, (kc * IM.KC + ks * 32) // 32] += 1
        if kc == kchunks - 1:
            epilogues.append(t)
    return steps, epilogues


# (N, K, out): chip_smoke.py's int8 shapes (vit-s FF1, FF2, the embedder,
# vit-b's FF2, the TPU probe's, the deepest K, ragged, the strided case),
# N 1, 31 and 33 across the rows-a-block tiers, and MAX_K
SHAPES = [(12608, 384, 1536), (12608, 1536, 384), (12544, 768, 384), (12608, 3072, 768),
          (12608, 768, 3072), (33, IM.MAX_K, 256), (1851, 256, 128), (333, 768, 384),
          (1, 128, 128), (31, 768, 384), (33, 3968, 384), (1, 4096, 256), (31, 6016, 128),
          (33, 6144, 256), (1, IM.MAX_K, 128), (31, IM.MAX_K, 128)]


@pytest.mark.parametrize("n,k,out", SHAPES)
def test_every_output_written_once(n, k, out):
    bm = IM.rows_per_block(k)
    assert IM.shared_bytes(bm, k) <= IM.MAX_SHARED
    local = _tile_writes(bm)
    assert (local == 1).all()
    steps, epilogues = _walk(k, out)
    assert (steps == 1).all() and epilogues == list(range(out // IM.BN))
    blocks = -(-n // bm)
    y = np.zeros((blocks * bm, out), np.int64)
    for b in range(blocks):
        for t in epilogues:
            rows = b * bm + np.arange(bm)
            live = rows < n  # the epilogue's row mask
            y[rows[live], t * IM.BN:(t + 1) * IM.BN] += local[live]
    assert (y[:n] == 1).all() and (y[n:] == 0).all()


@pytest.mark.parametrize("k", [128, 384, 512, 640, 768, 1024, 1152, 1536, 2048, 2176, 3968,
                               4096, 6144, IM.MAX_K])
def test_every_row_and_value_quantized_once(k):
    """Every tier of rows a block and every way ``quantize`` walks a row: 4
    rows of up to 4 chunks, 2 of up to 8, 1 of up to 16 in one pass, 4 rows
    of 4 chunks a pass past that."""
    assert (_quantized(IM.rows_per_block(k), k) == 1).all()
    assert _rows_and_chunks(k)[0] * _rows_and_chunks(k)[1] == QCHUNKS


def test_rows_a_block_rule_and_max_k():
    """The rule on K alone: 48 rows up to K 3,968, 32 up to 6,016, 16 past
    it; the tiers grow no shared memory past a block's; ``MAX_K`` the
    deepest multiple of 128 that 16 rows fit, deeper than the 32-row kernel
    it replaced (7,244)."""
    assert [IM.rows_per_block(k) for k in (128, 384, 768, 1536, 3968, 4096, 6016, 6144)] == [
        48, 48, 48, 48, 48, 32, 32, 16]
    for deepest, rows in IM.ROW_TIERS:
        assert IM.shared_bytes(rows, deepest) <= IM.MAX_SHARED
    assert IM.MAX_K % IM.LANE == 0 and IM.MAX_K >= 7244
    assert IM.shared_bytes(IM.DEEP_ROWS, IM.MAX_K) <= IM.MAX_SHARED
    assert IM.shared_bytes(IM.DEEP_ROWS, IM.MAX_K + IM.LANE) > IM.MAX_SHARED


def test_wrapper_constants_are_the_kernels():
    """The wrapper's tile constants and shared-memory sum are the kernel's:
    ``BN``, ``KC``, ``STAGES``, ``XPAD``, the row scales, the W ring's rows
    of KC + 16 bytes; each entry (f32 and bf16 x) takes the rows a block
    the rule gives and the wrapper passes ``rows_per_block(K)``."""
    for name in ("BN", "KC", "STAGES", "XPAD"):
        assert _const(name) == getattr(IM, name), name
    assert ("(size_t)BM * sizeof(float) + (size_t)BM * (k + XPAD) +\n"
            "         (size_t)NST * BN * (KCH + 16)") in SRC
    for name in ("kanvit_int8_linear_fwd(", "kanvit_int8_linear_fwd_bf16("):
        entry = SRC.split(f'extern "C" int {name}')[1].split('extern "C"')[0]
        assert sorted(int(v) for v in re.findall(r"case (\d+):", entry)) == sorted(
            {rows for _, rows in IM.ROW_TIERS} | {IM.DEEP_ROWS}), name
    wrapper = Path(IM.__file__).read_text()
    assert "rows_per_block(k), torch.cuda.current_stream" in wrapper
