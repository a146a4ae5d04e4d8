"""The host-side choices the port's CUDA wrappers make, checked on the CPU.

``ops/block.py::block_split`` picks how many CTAs of one cluster share each
64-row tile of K2, splitting the MLP's hidden chunks among them; the C entry
point takes the split and refuses one it cannot run. ``cross_split`` does
the same for K4's query tiles (heads and hidden chunks split over the
cluster), from how many clusters the card holds at once, and
``cross_kv_groups`` splits K4's kv projection by columns where its context
tiles cannot fill the card. ``ops/attn.py::
kernel_operand`` decides which attention operands reach the kernels as they
are and which are copied first (expanded ones, whose stride-0 dimensions
the kernels' tensor maps cannot step over).
"""

import pytest
import torch

from comet_tpu_torch.ops.attn import kernel_operand
from comet_tpu_torch.ops.block import (
    K2_CHUNK, K2_MAX_SPLIT, K2_ROWS, K4_ROWS, block_split, cross_kv_groups, cross_split,
)

H100_SMS = 132

# (B, L, C, hidden, split on an H100): the main path's K2 calls, then the
# edge shapes the card checks (rows not a multiple of 64, L 16 and 64 at both
# widths, splits of 2 to 8)
K2_CASES = [
    (576, 16, 384, 1536, 1),  # coarse time blocks: 144 tiles
    (16, 64, 384, 1536, 6),  # coarse virtual blocks: 16 tiles, 96 CTAs
    (512, 16, 256, 1024, 1),  # fine time blocks: 128 tiles
    (7, 16, 256, 1024, 8),
    (20, 64, 384, 1536, 6),
    (3, 64, 256, 1024, 8),
    (5, 16, 384, 1536, 6),
    (1, 1, 384, 1536, 6),
    (9, 32, 256, 1024, 8),
    (30, 64, 384, 1536, 4),
    (40, 64, 384, 1536, 3),
    (50, 64, 256, 1024, 2),
]


def _ranks_of_chunks(split, chunks):
    """The rank of the cluster that runs each hidden chunk (the kernel runs
    chunk c on rank c % split)."""
    return [c % split for c in range(chunks)]


@pytest.mark.parametrize("b,l,c,hidden,want", K2_CASES)
def test_k2_split_on_an_h100(b, l, c, hidden, want):
    rows = b * l
    split = block_split(rows, hidden, H100_SMS)
    assert split == want
    tiles = -(-rows // K2_ROWS)
    # every CTA of the launch is resident at once
    assert split == 1 or tiles * split <= H100_SMS
    # each rank runs the same number of chunks, and each chunk runs once
    ranks = _ranks_of_chunks(split, hidden // K2_CHUNK)
    assert sorted(set(ranks)) == list(range(split))
    assert len({ranks.count(r) for r in range(split)}) == 1
    # a tile holds whole sequences
    assert K2_ROWS % l == 0


@pytest.mark.parametrize("sms", [1, 16, 78, 114, 132, 144])
def test_k2_split_keeps_its_limits_on_any_card(sms):
    for b, l, c, hidden, _ in K2_CASES:
        rows, chunks = b * l, hidden // K2_CHUNK
        split = block_split(rows, hidden, sms)
        tiles = -(-rows // K2_ROWS)
        assert 1 <= split <= K2_MAX_SPLIT and chunks % split == 0
        assert split == 1 or tiles * split <= sms
        # no larger split would also fit
        assert not any(chunks % n == 0 and tiles * n <= sms
                       for n in range(split + 1, K2_MAX_SPLIT + 1))


@pytest.mark.parametrize("hidden", [1536, 1024])
def test_k2_split_is_one_where_the_tiles_fill_half_the_card(hidden):
    assert block_split(67 * K2_ROWS, hidden, H100_SMS) == 1
    assert block_split(66 * K2_ROWS, hidden, H100_SMS) == 2


def _ideal(sms):
    """A card that holds sms // n clusters of n CTAs."""
    return lambda n: sms // n


# the clusters of K4's query-side kernel (214 KB of shared memory per CTA) an
# H100 80GB HBM3 held at once in cudaOccupancyMaxActiveClusters (chip_smoke.py
# run on the card): 66 of 2, 30 of 4, 15 of 8
H100_K4_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}

# (query rows, heads, split on an ideal 132-SM card, split on the H100)
K4_CASES = [
    (16 * 64, 8, 8, 4),  # virtual<-point: 16 tiles; 16 clusters of 8 do not fit the H100
    (16 * 512, 8, 1, 1),  # point<-virtual: 128 tiles fill the card
    (17 * 16, 8, 8, 8),  # 5 tiles
    (9 * 32, 8, 8, 8),  # 5 tiles
    (33 * 64, 8, 4, 2),  # 33 tiles
    (70 * 64, 8, 1, 1),  # 70 tiles: more than half the card
    (16 * 64, 6, 2, 2),  # the split divides the heads
]


@pytest.mark.parametrize("rows,heads,ideal,h100", K4_CASES)
def test_k4_split(rows, heads, ideal, h100):
    assert cross_split(rows, heads, _ideal(H100_SMS)) == ideal
    assert cross_split(rows, heads, H100_K4_CLUSTERS.get) == h100


@pytest.mark.parametrize("sms", [16, 20, 66, 78, 114, 132, 144])
def test_k4_split_keeps_its_limits_on_any_card(sms):
    for rows, heads, _, _ in K4_CASES:
        split = cross_split(rows, heads, _ideal(sms))
        tiles = -(-rows // K4_ROWS)
        assert split in (1, 2, 4, 8) and heads % split == 0
        # every CTA of the launch is resident at once
        assert split == 1 or tiles * split <= sms
        # no larger split would also fit
        assert not any(heads % n == 0 and tiles * n <= sms for n in (2, 4, 8) if n > split)
        # each rank runs at most one hidden chunk more than another
        ranks = [c % split for c in range(1536 // 128)]
        assert max(map(ranks.count, range(split))) - min(map(ranks.count, range(split))) <= 1


@pytest.mark.parametrize("rows,want", [(16 * 512, 1), (16 * 64, 4), (67 * 64, 1), (40 * 64, 2),
                                       (1, 4)])
def test_k4_kv_groups_on_an_h100(rows, want):
    groups = cross_kv_groups(rows, H100_SMS)
    assert groups == want
    assert groups == 1 or -(-rows // K4_ROWS) * groups <= H100_SMS


def _layouts():
    base = torch.zeros(4, 10, 96)
    packed = torch.zeros(4, 10, 3 * 96)
    return {
        "contiguous": (base, False),
        "packed column slice": (packed[..., 96:192], False),
        "size-1 dimensions of stride 0": (torch.zeros(96).expand(1, 1, 96), False),
        "one row per sequence": (torch.zeros(4, 1, 96), False),
        "expanded over the batch": (torch.zeros(1, 10, 96).expand(4, 10, 96), True),
        "expanded over the rows": (torch.zeros(4, 1, 96).expand(4, 10, 96), True),
        "expanded slice over the batch": (packed[:1, :, :96].expand(4, 10, 96), True),
        # left as it is, for the wrapper's stride check to refuse
        "strided columns": (base.transpose(1, 2).contiguous().transpose(1, 2), False),
    }


@pytest.mark.parametrize("name", list(_layouts()))
def test_kernel_operand_copies_only_expanded_tensors(name):
    t, copied = _layouts()[name]
    got = kernel_operand(t)
    assert torch.equal(got, t)
    assert (got.data_ptr() != t.data_ptr()) == copied
    # what reaches a kernel steps over every dimension longer than 1
    assert all(s != 0 for n, s in zip(got.shape, got.stride()) if n > 1)
