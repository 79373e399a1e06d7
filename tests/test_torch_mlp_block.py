"""The work split and the integer arithmetic of the streamed dots
(``wrinklefree_tpu_torch/csrc/ternary.cu::stream_dot``: the gateup and down
dots of the MLP block megakernel K2, the qkv and o dots of the attention
block megakernel K5, all four also run by K8), written in PyTorch.

The kernel cuts a [K/4, N] packed matrix into items of one 128-column tile
and one slice of its k-steps (8 packed rows each): every tile gets grid //
tiles slices and the first grid % tiles tiles one more, so that each block
of the grid has one item. Within an item, warp w takes the slice's k-steps
w, w + 8, ...; it multiplies the unsigned weight codes (w + 1) by the rows'
int8 codes and subtracts the codes' sum over the k it covered; a block adds
its eight warps' int32 partials and then adds them to the int32 accumulator,
in whatever order the blocks arrive. Here that order is shuffled, and the
sum must be bit for bit the port's plain int32 dot
(``ternary_matmul_plain``, the dot of ``ternary_matmul_stacked_plain``) at
BitNet-2B widths. The kernels are held against the composition of K1 calls
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from wrinklefree_tpu_torch.ops import ternary_cuda
from wrinklefree_tpu_torch.ops.ternary import pack_ternary_np

TILE_N, STEP, WARPS = 128, 8, 8
# BitNet-2B's two MLP dots and its two attention dots: (K/4, N)
DOTS_2B = {"gateup": (640, 13824), "down": (1728, 2560), "qkv": (640, 3840), "o": (640, 2560)}
# K2's and K5's grid on an H100 (two blocks per SM), K8's (one per SM), a
# grid of 216, one smaller than the gateup's 108 tiles but larger than the
# other dots' 20-30, and one block
GRIDS = [264, 132, 216, 37, 1]


def k2_items(grid: int, k4: int, n: int):
    """The kernel's items in order: (tile, first k-step, end k-step)."""
    tiles, steps = -(-n // TILE_N), -(-k4 // STEP)
    base, extra = grid // tiles, grid % tiles
    if base == 0 or base >= steps:
        base, extra = (1 if base == 0 else steps), 0
    items = []
    for tile in range(tiles):
        split = base + 1 if tile < extra else base
        items += [(tile, sl * steps // split, (sl + 1) * steps // split) for sl in range(split)]
    return items


@pytest.mark.parametrize("name", DOTS_2B)
@pytest.mark.parametrize("grid", GRIDS)
def test_items_cover_each_tile_once(name, grid):
    """Each tile's slices cover its k-steps once, none empty; a grid with a
    block per tile gets exactly one item per block (so every resident block
    streams in both phases), a smaller one deals whole tiles out."""
    k4, n = DOTS_2B[name]
    tiles, steps = -(-n // TILE_N), -(-k4 // STEP)
    items = k2_items(grid, k4, n)
    assert len(items) == (grid if grid >= tiles else tiles)
    for tile in range(tiles):
        own = sorted((s0, s1) for t, s0, s1 in items if t == tile)
        assert own[0][0] == 0 and own[-1][1] == steps
        assert all(s1 > s0 for s0, s1 in own)
        assert all(a[1] == b[0] for a, b in zip(own, own[1:]))


def stream_dot_model(xq: torch.Tensor, qw: torch.Tensor, grid: int, seed: int) -> torch.Tensor:
    """The kernel's integer arithmetic and merge: per item and warp, unsigned
    codes times the interleaved int8 codes minus the codes' sum, in int32; the
    block's warps summed; the blocks' sums added to an int32 accumulator in a
    shuffled order."""
    m, k = xq.shape
    k4, n = qw.shape
    steps = -(-k4 // STEP)
    x4 = ternary_cuda.interleave_codes(xq).to(torch.float64)  # k = 4r + p
    u = (ternary_cuda.unpack_signed_interleaved(qw).to(torch.float64) + 1)  # [N, K], w + 1
    pad = steps * 4 * STEP - k
    x4 = torch.nn.functional.pad(x4, (0, pad)).reshape(m, steps, 4 * STEP)
    u = torch.nn.functional.pad(u, (0, pad)).reshape(n, steps, 4 * STEP)
    # every k-step's partial (exact in float64: |sum| < 2^53) and code sums
    part = torch.einsum("msk,nsk->smn", x4, u).to(torch.int64)
    rsum = x4.sum(-1).to(torch.int64).t()  # [steps, m]
    acc = torch.zeros((m, n), dtype=torch.int32)
    items = k2_items(grid, k4, n)
    for i in np.random.default_rng(seed).permutation(len(items)):
        tile, s0, s1 = items[i]
        cols = slice(tile * TILE_N, min(n, (tile + 1) * TILE_N))
        block = torch.zeros((m, cols.stop - cols.start), dtype=torch.int32)
        for w in range(WARPS):
            mine = list(range(s0 + w, s1, WARPS))
            if not mine:
                continue
            p = (part[mine, :, cols] - rsum[mine, :, None]).sum(0)
            assert p.abs().max() < 2**31
            block += p.to(torch.int32)
        acc[:, cols] += block
    return acc


@pytest.mark.parametrize("grid", [264, 132, 37])
@pytest.mark.parametrize("name", DOTS_2B)
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_stream_dot_gives_the_exact_dot_at_2b(rows, name, grid):
    k4, n = DOTS_2B[name]
    rng = np.random.default_rng(rows * 7 + k4)
    xq = torch.from_numpy(rng.integers(-128, 128, (rows, 4 * k4)).astype(np.int8))
    qw = torch.from_numpy(pack_ternary_np(rng.integers(-1, 2, (4 * k4, n)).astype(np.int8)))
    want = ternary_cuda.ternary_matmul_plain(xq, qw)
    assert want.dtype == torch.int32
    assert torch.equal(stream_dot_model(xq, qw, grid, seed=rows), want)


@pytest.mark.parametrize("grid", [5, 64])
def test_stream_dot_partial_steps_and_tiles(grid):
    """K/4 = 84 (not a multiple of the 8-row k-step) and N = 272 (not of the
    128-column tile), with random bytes (code 3 included)."""
    rng = np.random.default_rng(grid)
    xq = torch.from_numpy(rng.integers(-128, 128, (8, 336)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(0, 256, (84, 272)).astype(np.uint8))
    want = ternary_cuda.ternary_matmul_plain(xq, qw)
    assert torch.equal(stream_dot_model(xq, qw, grid, seed=grid), want)
