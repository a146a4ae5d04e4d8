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
the kernels' tensor maps cannot step over). ``ops/norm.py::norm_plan`` sizes
K5's thread group per row and its persistent grid, and ``ops/attn.py::
short_plan`` K3's units of work, ring depth and persistent grid; each is
checked here by walking the rows or (sequence, head) pairs as the kernel
does.
"""

import pytest
import torch

from comet_tpu_torch.ops.attn import (
    SHORT_MAX_STAGES, kernel_operand, short_max_warps, short_plan, short_smem,
)
from comet_tpu_torch.ops.block import (
    K2_CHUNK, K2_MAX_SPLIT, K2_ROWS, K4_ROWS, block_split, cross_kv_groups, cross_split,
)
from comet_tpu_torch.ops.norm import (
    NORM_GROUPS, NORM_MAX_VECTORS, NORM_THREADS, norm_group, norm_plan,
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


# ------------------------------------------------------------------- K5

# the main path's K5 calls (rows, C) on FUSED_ROUTE, then the edges: rows
# around a CTA's step and an H100's resident CTAs (1,056 at 8 per SM), widths
# that leave lanes idle
K5_MAIN = [(9296, 768), (9216, 768), (9232, 768), (8655, 768), (577, 768), (8192, 256),
           (8192, 768), (16, 768), (9216, 384), (1024, 384)]
K5_EDGE = [(r, c) for r in (1, 7, 9, 1055, 1057, 9296) for c in (8, 264, 392, 1000, 1024)]


def _ln_rows_covered(plan, rows):
    """The rows each group of each CTA takes, walked as csrc/norm.cu does:
    group g of CTA b the rows g * grid + b, then every (256 / group) * grid-th."""
    seen = []
    groups = NORM_THREADS // plan.group
    for b in range(plan.grid):
        step = groups * plan.grid
        mine = [r for g in range(groups) for r in range(g * plan.grid + b, rows, step)]
        assert mine, "a CTA without rows"
        seen += mine
    return seen


@pytest.mark.parametrize("c,itemsize,want", [
    (768, 2, (32, 3)), (384, 2, (16, 3)), (256, 2, (16, 2)),  # the main path, bf16
    (768, 4, (32, 6)), (256, 4, (32, 2)), (1024, 2, (32, 4)), (1024, 4, (32, 8)),
    (8, 2, (16, 1)), (264, 2, (16, 3)), (392, 2, (16, 4)), (1000, 2, (16, 8)), (1000, 4, (32, 8)),
])
def test_k5_group_fits_the_row(c, itemsize, want):
    group, vectors = norm_group(c, itemsize)
    assert (group, vectors) == want
    nvec = c * itemsize // 16
    assert group in NORM_GROUPS and 1 <= vectors <= NORM_MAX_VECTORS
    assert group * vectors >= nvec > group * (vectors - 1)  # every vector, no idle round


@pytest.mark.parametrize("itemsize", [2, 4])
def test_k5_group_takes_every_width(itemsize):
    for c in range(8, 1025, 8):
        group, vectors = norm_group(c, itemsize)
        nvec = c * itemsize // 16
        assert group in NORM_GROUPS and 1 <= vectors <= NORM_MAX_VECTORS
        assert group * vectors >= nvec > group * (vectors - 1)


@pytest.mark.parametrize("sms,one,two", [(132, 6, 4), (132, 3, 2), (132, 1, 1), (1, 8, 4),
                                         (16, 4, 4), (78, 6, 3), (114, 8, 8), (144, 5, 4)])
@pytest.mark.parametrize("rows,c", K5_MAIN + K5_EDGE)
def test_k5_plan_covers_every_row_once(rows, c, sms, one, two):
    for itemsize in (2, 4):
        plan = norm_plan(rows, c, itemsize, sms, lambda g, t: two if t else one)
        assert (plan.group, plan.vectors) == norm_group(c, itemsize)
        # persistent: never more CTAs than the card holds at once, or than rows
        assert 1 <= plan.grid <= min(sms * (two if plan.two else one), rows)
        covered = _ln_rows_covered(plan, rows)
        assert sorted(covered) == list(range(rows))
        # the kernel without a second row buffer gives each group one row
        if not plan.two:
            assert plan.grid * (NORM_THREADS // plan.group) >= rows


@pytest.mark.parametrize("rows,c,two,grid", [
    (9296, 768, True, 528),  # 1,162 steps of 8 rows: every resident CTA of the two-row kernel
    (9216, 384, False, 576),  # one step of 16 rows per CTA, all resident
    (8192, 256, False, 512),
    (1024, 384, False, 132),  # under a step per SM: a CTA for each SM
    (577, 768, False, 132),
    (16, 768, False, 16),  # a row per CTA
    (1, 8, False, 1),
])
def test_k5_plan_on_an_h100(rows, c, two, grid):
    # 6 CTAs of the one-row kernel per SM, 4 of the two-row one
    plan = norm_plan(rows, c, 2, 132, lambda g, t: 4 if t else 6)
    assert (plan.two, plan.grid) == (two, grid)


# ------------------------------------------------------------------- K3

# an H100 as cudaOccupancyMaxActiveBlocksPerMultiprocessor sees it for these
# CTAs: 2,048 threads, 32 CTAs and 228 KB of shared memory per SM (1 KB of it
# reserved per CTA), at most 227 KB per CTA
H100_SMEM_PER_SM, H100_SMEM_PER_CTA = 233472, 232448


def _h100_resident(threads, smem):
    if smem > H100_SMEM_PER_CTA:
        return 0
    return min(2048 // threads, 32, H100_SMEM_PER_SM // (smem + 1024))


def _scaled(n):
    """A card whose SMs hold n times fewer CTAs than an H100's (at least one
    of any CTA the H100 takes)."""
    return lambda threads, smem: min(_h100_resident(threads, smem), max(
        _h100_resident(threads, smem) // n, 1))


# (B, Lq, Lk, C, heads): the main path's three calls, then the edges: B * L
# just over 256, L 1, 15, 17, 33 and 64, Lq != Lk, D 32, 48, 64 and 96, 12
# heads, batches that are not a multiple of a CTA's units
K3_MAIN = [(576, 16, 16, 384, 8), (16, 64, 64, 384, 8), (512, 16, 16, 256, 8)]
K3_EDGE = [(17, 16, 16, 384, 8), (257, 1, 1, 256, 8), (300, 1, 1, 768, 8), (18, 15, 15, 384, 8),
           (16, 17, 17, 512, 8), (9, 33, 33, 768, 8), (5, 64, 64, 768, 8), (5, 63, 63, 384, 8),
           (20, 16, 64, 384, 8), (8, 64, 17, 256, 8), (20, 16, 16, 768, 12), (577, 16, 16, 384, 8),
           (1, 64, 64, 384, 8), (4097, 16, 16, 256, 8)]


def _pairs_covered(plan, b, heads):
    """The (sequence, head) pairs each CTA computes, walked as
    csrc/short_attn.cu does: unit u = (sequence u // groups, head group
    u % groups) goes to CTA u % grid, which takes its units in order."""
    groups = heads // plan.heads
    units = b * groups
    seen = []
    for cta in range(plan.grid):
        mine = range(cta, units, plan.grid)
        assert len(mine) >= 1, "a CTA without units"
        for u in mine:
            seq, g = divmod(u, groups)
            seen += [(seq, g * plan.heads + h) for h in range(plan.heads)]
    return seen


@pytest.mark.parametrize("resident", [_h100_resident, _scaled(2), _scaled(4)])
@pytest.mark.parametrize("sms", [1, 16, 78, 114, 132, 144])
@pytest.mark.parametrize("b,lq,lk,c,heads", K3_MAIN + K3_EDGE)
def test_k3_plan_covers_every_pair_once(b, lq, lk, c, heads, sms, resident):
    plan = short_plan(b, lq, lk, c, heads, sms, resident)
    d, slices = c // heads, -(-lq // 16)
    cols = plan.heads * d
    assert heads % plan.heads == 0
    # one warp per head and 16 query rows, within a CTA's limits
    assert plan.warps == plan.heads * slices <= short_max_warps(d, lk) <= 16
    assert 1 <= plan.stages <= SHORT_MAX_STAGES
    smem = short_smem(lq, lk, cols, plan.stages)
    assert smem <= H100_SMEM_PER_CTA and resident(32 * plan.warps, smem) >= 1
    # TMA boxes of 64 columns (inputs) or 16, 32 or 64 dividing the unit's
    # columns (output), by ceil(L / 16) * 16 rows: at most 256 per dimension
    assert cols % 16 == 0 and -(-max(lq, lk) // 16) * 16 <= 256
    # persistent: no more CTAs than the card holds at once, or than units
    units = b * heads // plan.heads
    assert 1 <= plan.grid <= min(units, sms * resident(32 * plan.warps, smem))
    # a ring only where a CTA has more than one unit
    assert plan.stages == 1 or units > plan.grid
    assert sorted(_pairs_covered(plan, b, heads)) == [(s, h) for s in range(b)
                                                      for h in range(heads)]


@pytest.mark.parametrize("b,lq,lk,c,heads,want", [
    # coarse time: whole sequences, 2 stages (a third would halve the CTAs)
    (576, 16, 16, 384, 8, (8, 8, 2, 264)),
    # fine time: every unit resident at once, one stage each
    (512, 16, 16, 256, 8, (8, 8, 1, 512)),
    # coarse virtual: 16 sequences; one head per unit gives the most CTAs
    (16, 64, 64, 384, 8, (1, 4, 1, 128)),
    # B * L just over 256 at L 16: one head per unit fills the card
    (17, 16, 16, 384, 8, (1, 1, 1, 136)),
])
def test_k3_plan_on_an_h100(b, lq, lk, c, heads, want):
    assert tuple(short_plan(b, lq, lk, c, heads, 132, _h100_resident)) == want


def test_k3_plan_passes_over_units_that_do_not_fit():
    # on a card whose CTAs may have 64 KB, 4 heads of D 48 at L 64 (121 KB
    # with one stage) do not fit, 2 heads do
    def small_card(threads, smem):
        return 0 if smem > 65536 else _h100_resident(threads, smem)

    assert short_smem(64, 64, 4 * 48, 1) > 65536 >= short_smem(64, 64, 2 * 48, 1)
    plan = short_plan(1, 64, 64, 384, 8, 1, small_card)
    assert plan.heads == 2 and short_smem(64, 64, 2 * 48, plan.stages) <= 65536
