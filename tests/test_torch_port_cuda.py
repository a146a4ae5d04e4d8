"""The port's CUDA kernels (K1 to K5) against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. The machine with the
card has no JAX, so run them without the JAX-side conftest:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances: the kernel in bf16 against the plain version in f32 on the same
bf16 inputs, atol 3e-2 as tests/test_pallas_attn.py::test_bf16_inputs (K1,
K3), for K2 and K4 two bf16 steps relative to the value on top (their output
and residual stream are rounded to bf16 at magnitudes up to ~8), and for K5
atol 1e-3 plus one bf16 rounding of the output (2^-7 |y|); K5 in f32 is held
to 1e-5. The GELU that K2 and K4 share is held to the exact tanh form within
one bf16 rounding (2^-8 |y|) on every bf16 value in [-8, 8]. K1's A/B
softmax forms (nomax, bf16e) are held to their own plain versions on the
same bf16 inputs, with the forms' casts, at K1's atol 3e-2 plus one bf16
step of the output (2^-7 |y|: the kernel rounds the weights at other points,
and at Lk 1 moves an output of |y| >= 4 by one step, 0.03125); the
preprocessing on the card to its CPU run at 1e-5 (f32 products, no TF32).
Each kernel wrapper's gradient (its ``comet::`` operator's registered
backward, which recomputes through the plain version) equals the plain
version's autograd on the same bf16 inputs bit for bit, and one full-width
train step per route trains the camera predictor alone. Each operator
called directly launches its kernel within the same tolerances, and the
exported full-width forward, served on each route, launches the eager
forward's kernels and equals its outputs bit for bit. Two full-width epochs
of two steps through ``fit_epoch(mesh=)`` over NCCL at world size 1 equal the
mesh-less epoch bit for bit, and a rank without a card of its own raises.
"""

import ctypes
import subprocess

import pytest
import torch

from comet_tpu_torch.ops.attn import (
    ShortPlan, attention_form_reference, attention_reference, fused_attention, short_attention,
)
from comet_tpu_torch.ops.block import (
    K4_CLOCKS, block_reference, cross_block_reference, fused_attn_block, fused_cross_block,
)
from comet_tpu_torch.ops.norm import fused_layer_norm, layer_norm_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,lq,lk,c,h",
    [(16, 581, 581, 768, 12), (1, 300, 139, 384, 8), (16, 1, 512, 768, 8), (2, 33, 70, 256, 8)],
)
def test_k1_cuda_matches_plain(cuda_device, b, lq, lk, c, h):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(b, n, c, generator=g, device=cuda_device).bfloat16()
               for n in (lq, lk, lk))
    before = fused_attention.launches
    got = fused_attention(q, k, v, h)
    assert fused_attention.launches == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), h, (c // h) ** -0.5)
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)


# Edge shapes of K1's tilings (the same as chip_smoke.py's K1_EDGE): Lq and Lk
# of 1, 63, 65, 129 and 577 around the 128-row query and 64-key tiles, and
# packed qkv slices at D 48 and 96
K1_EDGE = ([(2, n, 577, 768, 8, False) for n in (1, 63, 65, 129, 577)]
           + [(2, 577, n, 768, 8, True) for n in (1, 63, 65, 129)]
           + [(3, 129, 129, 384, 8, True), (2, 65, 65, 768, 8, True), (4, 63, 63, 384, 8, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,c,h,packed", K1_EDGE)
def test_k1_cuda_edge_shapes(cuda_device, b, lq, lk, c, h, packed):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    if packed and lq == lk:
        q, k, v = torch.randn(b, lq, 3 * c, generator=g, device=cuda_device).bfloat16().split(c, -1)
    else:
        q = torch.randn(b, lq, c, generator=g, device=cuda_device).bfloat16()
        kv = torch.randn(b, lk, 2 * c, generator=g, device=cuda_device).bfloat16()
        k, v = kv.split(c, -1) if packed else (kv[..., :c].contiguous(), kv[..., c:].contiguous())
    before = fused_attention.launches
    got = fused_attention(q, k, v, h)
    assert fused_attention.launches == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), h, (c // h) ** -0.5)
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,expanded", [(4, 100, 577, "batch"), (3, 64, 70, "rows")])
def test_k1_cuda_takes_expanded_keys_and_values(cuda_device, b, lq, lk, expanded):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    c, h = 768, 8
    q = torch.randn(b, lq, c, generator=g, device=cuda_device).bfloat16()
    if expanded == "batch":  # one set of keys for every sequence
        k, v = (torch.randn(1, lk, c, generator=g, device=cuda_device).bfloat16().expand(b, lk, c)
                for _ in range(2))
    else:  # one key repeated over the sequence
        k, v = (torch.randn(b, 1, c, generator=g, device=cuda_device).bfloat16().expand(b, lk, c)
                for _ in range(2))
    got = fused_attention(q, k, v, h)
    want = attention_reference(q.float(), k.float(), v.float(), h, (c // h) ** -0.5)
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["nomax", "bf16e"])
@pytest.mark.parametrize("b,lq,lk,c,h", [(16, 581, 581, 768, 12), (16, 578, 578, 768, 8),
                                         (2, 577, 1, 768, 12), (2, 577, 1, 768, 8),
                                         (2, 577, 63, 768, 8),
                                         (2, 65, 577, 768, 12), (4, 16, 16, 384, 4)])
def test_k1_softmax_forms_match_their_plain_versions(cuda_device, form, b, lq, lk, c, h):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(b, n, c, generator=g, device=cuda_device).bfloat16()
               for n in (lq, lk, lk))
    key = (form, b, lq, lk, c, h)
    before = fused_attention.form_launches[key], fused_attention.launches
    got = fused_attention(q, k, v, h, softmax=form)
    assert (fused_attention.form_launches[key], fused_attention.launches) == (before[0] + 1,
                                                                              before[1])
    want = attention_form_reference(q, k, v, h, (c // h) ** -0.5, form)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_k1_softmax_forms_refuse_other_head_dims(cuda_device):
    q = torch.zeros(2, 8, 384, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fused_attention(q, q, q, 8, softmax="bf16e")  # D 48


@pytest.mark.cuda
@pytest.mark.parametrize("resample", ["bilinear", "lanczos"])
def test_preprocess_frames_on_the_card_matches_the_cpu(cuda_device, resample):
    from comet_tpu_torch.data.device_pipeline import preprocess_frames, preprocess_mask

    g = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, (16, 480, 640, 3), generator=g, dtype=torch.uint8)
    square = (120.0, 40.0, 560.0, 480.0)
    want = preprocess_frames(frames, square, 512, resample)
    got = preprocess_frames(frames.to(cuda_device), square, 512, resample)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    mask = (frames[0, ..., 0] > 128).to(torch.uint8)
    assert torch.equal(preprocess_mask(mask.to(cuda_device), square, 512).cpu(),
                       preprocess_mask(mask, square, 512))


@pytest.mark.cuda
def test_device_preprocess_dataset_hands_images_over_between_streams(cuda_device, tmp_path):
    """keep_on_device: the images come from a side stream with an event;
    after wait_ready the consumer's stream reads what the CPU run gives."""
    from comet_tpu_torch.data import AMDDataset, DevicePreprocessDataset, generate_amd_fixture
    from comet_tpu_torch.data.device_pipeline import wait_ready
    from comet_tpu_torch.data.prefetch import prefetch

    root = generate_amd_fixture(str(tmp_path), n_seqs=3, n_frames=8, img_hw=(240, 320))
    base = AMDDataset(root, crop_size=256, seq_len=8)
    card = DevicePreprocessDataset(base, resample="lanczos", keep_on_device=True)
    cpu = DevicePreprocessDataset(base, resample="lanczos", device="cpu")
    for i, sample in enumerate(prefetch(card.__getitem__, len(card))):
        assert sample.ready is not None and sample.images.device.type == "cuda"
        wait_ready(sample)
        torch.testing.assert_close(sample.images.cpu(), torch.from_numpy(cpu[i].images),
                                   atol=1e-5, rtol=0)


# K2 at the main path's shapes, then rows not a multiple of 64, L 16 and 64
# at both widths, and cluster splits of 2 to 8 (ops/block.py::block_split)
K2_CUDA_CASES = [(576, 16, 384), (16, 64, 384), (512, 16, 256), (7, 16, 256), (20, 64, 384),
                 (5, 16, 384), (3, 64, 256), (1, 1, 384), (9, 32, 256), (30, 64, 384),
                 (40, 64, 384), (50, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,c", K2_CUDA_CASES)
def test_k2_cuda_matches_plain(cuda_device, b, l, c):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda_device) * s).bfloat16()

    hid = 4 * c
    w = [rnd(3 * c, c, s=c ** -0.5), rnd(3 * c, s=0.02), rnd(c, c, s=c ** -0.5), rnd(c, s=0.02),
         rnd(hid, c, s=c ** -0.5), rnd(hid, s=0.02), rnd(c, hid, s=hid ** -0.5), rnd(c, s=0.02)]
    x = rnd(b, l, c)
    before = fused_attn_block.launches
    got = fused_attn_block(x, *w, 8)
    assert fused_attn_block.launches == before + 1
    want = block_reference(x.float(), *(t.float() for t in w), 8)
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=2.0 ** -6)


@pytest.mark.cuda
def test_k2_cuda_clocks_leave_the_result_alone(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    c, hid = 384, 1536
    w = [(torch.randn(*s, generator=g, device=cuda_device) * 0.05).bfloat16()
         for s in ((3 * c, c), (3 * c,), (c, c), (c,), (hid, c), (hid,), (c, hid), (c,))]
    x = torch.randn(16, 64, c, generator=g, device=cuda_device).bfloat16()
    clocks = torch.zeros(18, dtype=torch.int64, device=cuda_device)
    got = fused_attn_block(x, *w, 8, clocks=clocks)
    assert torch.equal(got, fused_attn_block(x, *w, 8))
    t = clocks.tolist()
    for wg in range(2):  # phase ends rise; waits fit inside the run
        ends = t[8 * wg:8 * wg + 6]
        assert all(0 < a <= b for a, b in zip(ends, ends[1:]))
        assert 0 <= t[8 * wg + 6] <= ends[-1] and t[8 * wg + 7] > 0
    assert 0 <= t[16] <= t[17]


@pytest.mark.cuda
def test_kernels_refuse_f32_on_cuda(cuda_device):
    x = torch.zeros(2, 16, 64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        fused_attention(x, x, x, 2)


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 16, 80, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(x, x, x, 2)  # D 40
    y = torch.zeros(2, 16, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="column stride"):
        fused_attention(y.transpose(1, 2).contiguous().transpose(1, 2), y, y, 2)


@pytest.mark.cuda
def test_k2_refuses_an_uncompiled_width(cuda_device):
    c, hid = 128, 512
    x = torch.zeros(64, 16, c, device=cuda_device, dtype=torch.bfloat16)
    w = [torch.zeros(s, device=cuda_device, dtype=torch.bfloat16)
         for s in ((3 * c, c), (3 * c,), (c, c), (c,), (hid, c), (hid,), (c, hid), (c,))]
    with pytest.raises(ValueError, match="not compiled"):
        fused_attn_block(x, *w, 8)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,l,c,packed",
    [(576, 16, 384, True), (16, 64, 384, True), (512, 16, 256, True), (40, 12, 384, False),
     (300, 33, 256, False)],
)
def test_k3_cuda_matches_plain(cuda_device, b, l, c, packed):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    if packed:  # column slices of one qkv projection, as in the model
        q, k, v = torch.randn(b, l, 3 * c, generator=g, device=cuda_device).bfloat16().split(c, -1)
    else:
        q, k, v = (torch.randn(b, l, c, generator=g, device=cuda_device).bfloat16()
                   for _ in range(3))
    before, k1_before = short_attention.launches, fused_attention.launches
    got = fused_attention(q, k, v, 8)
    assert short_attention.launches == before + 1 and fused_attention.launches == k1_before
    want = attention_reference(q.float(), k.float(), v.float(), 8, (c // 8) ** -0.5)
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)


# K3's edge shapes (B, Lq, Lk, C, heads, layout), as chip_smoke.py's K3_EDGE:
# L 1, 15, 17, 33, 63 and 64 and Lq != Lk around its 16-row slices, D 32,
# 48, 64 and 96, 12 heads, batches that are not a multiple of a CTA's units;
# q, k, v as slices of one packed projection, as three tensors, or with k
# and v one sequence expanded over the batch
K3_EDGE = [(300, 1, 1, 256, 8, "packed"), (20, 15, 15, 384, 8, "packed"),
           (17, 17, 17, 512, 8, "separate"), (9, 33, 33, 768, 8, "packed"),
           (5, 63, 63, 384, 8, "separate"), (5, 64, 64, 256, 8, "expanded"),
           (20, 16, 64, 384, 8, "separate"), (8, 64, 17, 256, 8, "packed"),
           (19, 16, 16, 384, 8, "packed"), (20, 16, 16, 768, 12, "packed"),
           (33, 16, 1, 768, 8, "expanded"), (7, 40, 40, 512, 8, "packed")]


def _k3_inputs(dev, b, lq, lk, c, layout, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    if layout == "packed" and lq == lk:
        return rnd(b, lq, 3 * c).split(c, -1)
    if layout == "packed":
        return (rnd(b, lq, c), *rnd(b, lk, 2 * c).split(c, -1))
    if layout == "expanded":
        return rnd(b, lq, c), rnd(1, lk, c).expand(b, lk, c), rnd(1, lk, c).expand(b, lk, c)
    return rnd(b, lq, c), rnd(b, lk, c), rnd(b, lk, c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,c,h,layout", K3_EDGE)
def test_k3_cuda_edge_shapes(cuda_device, b, lq, lk, c, h, layout):
    q, k, v = _k3_inputs(cuda_device, b, lq, lk, c, layout)
    before = short_attention.launches
    got = short_attention(q, k, v, h)
    assert short_attention.launches == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), h, (c // h) ** -0.5)
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)


@pytest.mark.cuda
def test_k3_and_k5_are_not_served_a_stale_plan(cuda_device):
    # K3 and K5 at one shape, another, and the first again (other buffers):
    # each call's plan and tensor maps are its own
    for b, lq, lk, c, layout in [(576, 16, 16, 384, "packed"), (16, 64, 64, 384, "packed"),
                                 (40, 16, 33, 256, "separate"), (576, 16, 16, 384, "packed")]:
        q, k, v = _k3_inputs(cuda_device, b, lq, lk, c, layout, seed=b + lk)
        want = attention_reference(q.float(), k.float(), v.float(), 8, (c // 8) ** -0.5)
        torch.testing.assert_close(short_attention(q, k, v, 8).float(), want, atol=3e-2, rtol=0)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    for rows, c in [(9296, 768), (16, 256), (1057, 392), (9296, 768)]:
        x = torch.randn(rows, c, generator=g, device=cuda_device).bfloat16()
        want = layer_norm_reference(x.float())
        torch.testing.assert_close(fused_layer_norm(x).float(), want, atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_k3_refuses_a_plan_it_cannot_run(cuda_device):
    q, k, v = _k3_inputs(cuda_device, 32, 16, 16, 384, "packed")
    with pytest.raises(ValueError, match="does not take"):  # 3 heads do not divide 8
        short_attention(q, k, v, 8, plan=ShortPlan(3, 3, 1, 64))
    with pytest.raises(ValueError, match="does not take"):  # a ring of 4 stages
        short_attention(q, k, v, 8, plan=ShortPlan(8, 8, 4, 16))


def _cross_weights(g, dev, c, hid):
    def rnd(*shape, s=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g, device=dev) * s).bfloat16()

    return [rnd(c, mean=1.0, s=0.1), rnd(c, s=0.1), rnd(c, c, s=c ** -0.5), rnd(c, s=0.02),
            rnd(2 * c, c, s=c ** -0.5), rnd(2 * c, s=0.02), rnd(c, c, s=c ** -0.5),
            rnd(c, s=0.02), rnd(hid, c, s=c ** -0.5), rnd(hid, s=0.02),
            rnd(c, hid, s=hid ** -0.5), rnd(c, s=0.02)]


# K4 (B, Lq, Lk, C, split): the update-former's two shapes at every split of
# the query tiles (None: ops/block.py::cross_split's), and shapes with several
# sequences per 64-row tile
K4_CUDA_CASES = (
    [(16, 64, 512, 384, s) for s in (None, 1, 2, 4, 8)]
    + [(16, 512, 64, 384, s) for s in (None, 1, 2, 4, 8)]
    + [(8, 32, 70, 256, None), (37, 16, 48, 384, None), (37, 16, 48, 384, 8)]
)
# K4's edge shapes (the same as chip_smoke.py's K4_EDGE): Lq 16, 32, 64 and
# 512 (B * Lq not a multiple of 64 below Lq 64) against Lk 1, 63, 65, 512 and
# 1024 at both widths, at the plan's split and at splits 2, 4 and 8
K4_EDGE = [({16: 17, 32: 9, 64: 5, 512: 1}[lq], lq, lk, c)
           for c in (384, 256) for lq in (16, 32, 64, 512) for lk in (1, 63, 65, 512, 1024)]
# Edge shapes where, on these inputs, the plain version in bf16 (K4's rounding
# points) itself misses the tolerance against f32: with Lk 1 every row of a
# sequence shares one attention output, so one bf16 rounding of each of its
# columns reaches all Lq rows. K4 is held there to the plain bf16 version at
# the same tolerance, and the plain version's miss is asserted, so that a
# shape leaves this list when it no longer misses.
K4_EDGE_KNOWN_MISS = {(17, 16, 1, 256)}


def _k4_case(dev, b, lq, lk, c, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = _cross_weights(g, dev, c, 4 * c)
    x = torch.randn(b, lq, c, generator=g, device=dev).bfloat16()
    ctx = torch.randn(b, lk, c, generator=g, device=dev).bfloat16()
    return x, ctx, w, cross_block_reference(x.float(), ctx.float(), *(t.float() for t in w), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,c,split", K4_CUDA_CASES)
def test_k4_cuda_matches_plain(cuda_device, b, lq, lk, c, split):
    x, ctx, w, want = _k4_case(cuda_device, b, lq, lk, c)
    before = fused_cross_block.launches
    got = fused_cross_block(x, ctx, *w, 8, split=split)
    assert fused_cross_block.launches == before + 1
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=2.0 ** -6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,c", K4_EDGE)
def test_k4_cuda_edge_shapes(cuda_device, b, lq, lk, c):
    x, ctx, w, want = _k4_case(cuda_device, b, lq, lk, c)

    def excess(y, ref):
        return ((y.float() - ref).abs() - 2.0 ** -6 * ref.abs()).max().item()

    plain = cross_block_reference(x, ctx, *w, 8).float()
    ref = want
    if (b, lq, lk, c) in K4_EDGE_KNOWN_MISS:
        assert excess(plain, want) > 3e-2
        ref = plain
    for split in (None, 2, 4, 8):
        got = fused_cross_block(x, ctx, *w, 8, split=split)
        assert torch.isfinite(got).all()
        assert excess(got, ref) <= 3e-2, (
            f"split {split}: exceeds 3e-2 + 2^-6 |y| by {excess(got, ref)} "
            f"(plain bf16 against f32: {excess(plain, want)})")


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,split", [(16, 64, 512, 4), (16, 64, 512, 8), (16, 512, 64, 1),
                                           (17, 16, 65, 2)])
def test_k4_cuda_timed_instance_gives_the_same_output(cuda_device, b, lq, lk, split):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    w = _cross_weights(g, cuda_device, 384, 1536)
    x = torch.randn(b, lq, 384, generator=g, device=cuda_device).bfloat16()
    ctx = torch.randn(b, lk, 384, generator=g, device=cuda_device).bfloat16()
    clocks = torch.zeros(K4_CLOCKS, dtype=torch.int64, device=cuda_device)
    got = fused_cross_block(x, ctx, *w, 8, split=split)
    timed = fused_cross_block(x, ctx, *w, 8, split=split, clocks=clocks)
    assert torch.equal(timed, got)
    # the phases of the query side's first CTA end in order, and the kv
    # projection's LN ends before its CTA does
    ends = clocks[:7].tolist()
    assert all(0 < a <= b for a, b in zip(ends, ends[1:]))
    assert 0 < clocks[26] <= clocks[27]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,c,dtype,affine",
    [(9296, 768, torch.bfloat16, True), (9216, 384, torch.bfloat16, False),
     (8192, 256, torch.float32, True), (7, 48, torch.float32, False), (300, 1024, torch.bfloat16, True)],
)
def test_k5_cuda_matches_plain(cuda_device, rows, c, dtype, affine):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(rows, c, generator=g, device=cuda_device) * 3 + 1).to(dtype)
    scale = torch.randn(c, generator=g, device=cuda_device) if affine else None
    bias = torch.randn(c, generator=g, device=cuda_device) if affine else None
    before = fused_layer_norm.launches
    got = fused_layer_norm(x, scale, bias)
    assert fused_layer_norm.launches == before + 1 and got.dtype == dtype
    want = layer_norm_reference(x.float(), scale, bias)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want, atol=1e-3, rtol=2.0 ** -7)


# K5's edge shapes, as chip_smoke.py's K5_EDGE: rows around a CTA's step and
# an H100's resident CTAs, widths that leave lanes idle
K5_EDGE = [(r, c) for r in (1, 7, 9, 1055, 1057, 9296) for c in (8, 264, 392, 1000, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", K5_EDGE)
def test_k5_cuda_edge_shapes(cuda_device, rows, c, dtype, affine):
    g = torch.Generator(device=cuda_device).manual_seed(rows + c)
    x = (torch.randn(rows, c, generator=g, device=cuda_device) * 3 + 1).to(dtype)
    scale = torch.randn(c, generator=g, device=cuda_device) if affine else None
    bias = torch.randn(c, generator=g, device=cuda_device) if affine else None
    got = fused_layer_norm(x, scale, bias)
    want = layer_norm_reference(x.float(), scale, bias)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want, atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_k4_and_k5_refuse_what_they_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = _cross_weights(g, cuda_device, 384, 1536)
    x = torch.zeros(16, 24, 384, device=cuda_device, dtype=torch.bfloat16)  # Lq % 16
    with pytest.raises(ValueError, match="Lq"):
        fused_cross_block(x, x, *w, 8)
    x = torch.zeros(16, 32, 384, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="split"):
        fused_cross_block(x, x, *w, 8, split=3)
    with pytest.raises(ValueError, match="width"):
        fused_layer_norm(torch.zeros(4, 1032, device=cuda_device))


# gelu_tanh of block_common.cuh, on f32 inputs
_GELU_PROBE = r"""
#include "block_common.cuh"

__global__ void gelu_probe(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = comet::gelu_tanh(x[i]);
}

extern "C" int gelu_probe_launch(const void* x, void* y, int n) {
  gelu_probe<<<(n + 255) / 256, 256>>>(static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


@pytest.mark.cuda
def test_gelu_tanh_matches_the_exact_tanh_form(cuda_device, tmp_path):
    from comet_tpu_torch.ops import kernels

    src, lib = tmp_path / "gelu_probe.cu", tmp_path / "gelu_probe.so"
    src.write_text(_GELU_PROBE)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC),
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    probe = ctypes.CDLL(str(lib))
    # every bf16 value in [-8, 8]
    x = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int16).view(torch.bfloat16).float()
    x = x[torch.isfinite(x) & (x.abs() <= 8)].contiguous()
    xd = x.to(cuda_device)
    y = torch.empty_like(xd)
    assert probe.gelu_probe_launch(ctypes.c_void_p(xd.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                                   ctypes.c_int(xd.numel())) == 0
    xe = x.double()
    u = 0.7978845608028654 * (xe + 0.044715 * xe ** 3)
    # 0.5 x (1 + tanh(u)) in f64, with 1 + tanh(u) = 2 sigmoid(2u): the tanh
    # form itself cancels to 0 in f64 below x ~ -6, and agrees above -4
    exact = xe * torch.sigmoid(2 * u)
    above = xe > -4
    torch.testing.assert_close(exact[above], 0.5 * xe[above] * (1 + torch.tanh(u[above])),
                               rtol=1e-9, atol=0)
    err = (y.cpu().double() - exact).abs()
    worst = int((err / exact.abs().clamp_min(1e-300)).argmax())
    assert (err <= 2.0 ** -8 * exact.abs()).all(), (
        f"x {x[worst].item()}: {y[worst].item()} against {exact[worst].item()}")


def _function_cases(g, dev):
    """(kernel, wrapper call, plain call, leaves, cotangent) in bf16 on the card."""
    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).bfloat16().requires_grad_()

    cases = []
    for b, lq, lk, c, h in [(16, 577, 577, 768, 8), (1, 300, 577, 768, 8), (16, 1, 512, 768, 8),
                            (1, 16, 16, 768, 8), (64, 16, 16, 384, 8)]:
        q, k, v = rnd(b, lq, c), rnd(b, lk, c), rnd(b, lk, c)
        cases.append(("K3" if lq <= 64 and lk <= 64 and b * lq >= 256 else "K1",
                      lambda q=q, k=k, v=v, h=h: fused_attention(q, k, v, h),
                      lambda q=q, k=k, v=v, h=h, c=c: attention_reference(q, k, v, h,
                                                                          (c // h) ** -0.5),
                      [q, k, v], torch.randn(b, lq, c, generator=g, device=dev).bfloat16()))
    c, hid = 384, 1536
    w = [rnd(3 * c, c, std=c ** -0.5), rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5),
         rnd(c, std=0.02), rnd(hid, c, std=c ** -0.5), rnd(hid, std=0.02),
         rnd(c, hid, std=hid ** -0.5), rnd(c, std=0.02)]
    x = rnd(64, 16, c)
    cases.append(("K2", lambda: fused_attn_block(x, *w, 8), lambda: block_reference(x, *w, 8),
                  [x, *w], torch.randn(64, 16, c, generator=g, device=dev).bfloat16()))
    xq, ctx = rnd(16, 64, c), rnd(16, 512, c)
    cw = [rnd(c, std=0.1), rnd(c, std=0.1), rnd(c, c, std=c ** -0.5), rnd(c, std=0.02),
          rnd(2 * c, c, std=c ** -0.5), rnd(2 * c, std=0.02), *w[2:]]
    cases.append(("K4", lambda: fused_cross_block(xq, ctx, *cw, 8),
                  lambda: cross_block_reference(xq, ctx, *cw, 8), [xq, ctx, *cw],
                  torch.randn(16, 64, c, generator=g, device=dev).bfloat16()))
    xn = rnd(9232, 768)
    scale = torch.randn(768, generator=g, device=dev).requires_grad_()
    bias = torch.randn(768, generator=g, device=dev).requires_grad_()
    gn = torch.randn(9232, 768, generator=g, device=dev).bfloat16()
    cases.append(("K5", lambda: fused_layer_norm(xn, scale, bias),
                  lambda: layer_norm_reference(xn, scale, bias), [xn, scale, bias], gn))
    cases.append(("K5", lambda: fused_layer_norm(xn), lambda: layer_norm_reference(xn), [xn], gn))
    return cases


@pytest.mark.cuda
def test_kernel_functions_backward_is_the_plain_versions_autograd(cuda_device):
    """Each wrapper's output has a grad_fn, its launch is counted, and its
    gradients equal the plain version's autograd bit for bit."""
    counters = dict(K1=fused_attention, K2=fused_attn_block, K3=short_attention,
                    K4=fused_cross_block, K5=fused_layer_norm)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    for kernel, call, plain, leaves, cot in _function_cases(g, cuda_device):
        before = counters[kernel].launches
        out = call()
        assert out.grad_fn is not None and counters[kernel].launches == before + 1, kernel
        got = torch.autograd.grad(out, leaves, cot)
        want = torch.autograd.grad(plain(), leaves, cot)
        for a, b in zip(got, want):
            assert torch.equal(a, b), kernel


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "fused"])
def test_full_width_train_step(cuda_device, route):
    """One train step of the full-width ours model: a finite loss, the
    kernels of the route launched, only the camera predictor's trainable
    tensors with a gradient, all of them moved, every other bitwise kept."""
    from comet_tpu_torch.config import FUSED_ROUTE, KernelRoute, get_config
    from comet_tpu_torch.geometry.cameras import CameraSet, make_camera_set
    from comet_tpu_torch.models import build_comet
    from comet_tpu_torch.training import build_optimizer, build_train_step, camera_only_mask

    cfg = get_config("ours")
    model = build_comet(cfg, device=cuda_device, seed=0,
                        route=KernelRoute() if route == "default" else FUSED_ROUTE)
    optimizer, scheduler = build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    step = build_train_step(model, cfg, optimizer, scheduler)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    s, hw = cfg.seqlen, cfg.img_size
    images = torch.randn(1, s, hw, hw, 3, generator=g, device=cuda_device)
    queries = torch.rand(1, cfg.track_num, 2, generator=g, device=cuda_device) * (hw - 64) + 32
    q = torch.randn(s, 4, generator=g, device=cuda_device)
    uvz = torch.rand(s, 3, generator=g, device=cuda_device) * 100 + 3
    gt = CameraSet(*(f[None] for f in make_camera_set(q / q.norm(dim=-1, keepdim=True),
                                                       torch.zeros(s, 3, device=cuda_device),
                                                       t_uvz=uvz, ratio=0.9)))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    k1 = fused_attention.launches
    aux = step(images, queries, gt)
    assert torch.isfinite(aux["loss"]) and fused_attention.launches > k1
    mask = camera_only_mask(model)
    for name, p in model.named_parameters():
        if mask[name]:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert not torch.equal(p, before[name]), name
        else:
            assert p.grad is None and torch.equal(p, before[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(577, 768), (8192, 256), (16, 768)])
def test_k5_runs_a_layer_norm_cast_to_bf16(cuda_device, rows, c):
    """After the one-time inference cast a LayerNorm's scale and bias are
    bf16; on FUSED_ROUTE it hands them to K5 in f32 (JAX reads its cast
    parameters in f32), so K5 launches and matches the plain version on the
    same bf16 values."""
    from comet_tpu_torch.config import FUSED_ROUTE
    from comet_tpu_torch.models.blocks import LayerNorm
    from comet_tpu_torch.utils.serialization import cast_params_for_inference

    g = torch.Generator(device=cuda_device).manual_seed(rows)
    ln = LayerNorm(c, affine=True, dtype=torch.bfloat16).to(cuda_device)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(c, generator=g, device=cuda_device))
        ln.bias.copy_(0.1 * torch.randn(c, generator=g, device=cuda_device))
    ln.route = FUSED_ROUTE
    cast_params_for_inference(ln, torch.bfloat16)
    assert ln.weight.dtype == torch.bfloat16
    x = torch.randn(rows, c, generator=g, device=cuda_device).bfloat16()
    before = fused_layer_norm.launches
    got = ln(x)
    assert fused_layer_norm.launches == before + 1 and got.dtype == torch.bfloat16
    want = layer_norm_reference(x.float(), ln.weight.float(), ln.bias.float(), 1e-6)
    torch.testing.assert_close(got.float(), want, atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_windowed_scan_form_waits_for_nothing_on_the_card(cuda_device):
    """The scan form's own code issues no host synchronization: with a
    model stand-in that runs on the card and never synchronizes, torch's
    sync debug mode records none over 5 windows."""
    import warnings

    from comet_tpu_torch.models.windowed import windowed_forward_scan

    identity = torch.tensor([0.0, 0, 0, 1, 0, 0, 0], device=cuda_device)

    def apply(win_images, win_queries):  # frame 0 pinned to the identity, as the model's
        enc = win_images.mean(dim=(2, 3))[..., :1].expand(1, win_images.shape[1], 7) * 0.01
        enc = torch.cat([identity.expand(1, 1, 7), enc[:, 1:]], dim=1)
        tracks = win_queries[:, None].expand(1, win_images.shape[1], *win_queries.shape[1:])
        return {"pred_pose_enc": enc, "pred_track": tracks + 0.5}

    images = torch.randn(1, 48, 4, 4, 3, device=cuda_device)
    queries = torch.rand(1, 8, 2, device=cuda_device)
    gt_enc = torch.zeros(48, 8, device=cuda_device)
    gt_enc[:, 3] = 1.0
    ratio = torch.tensor(0.9, device=cuda_device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for tf in (False, True):
                enc, trk = windowed_forward_scan(apply, images, queries, 16, ratio,
                                                 gt_enc=gt_enc, teacher_force=tf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # one warning per synchronizing call (not the mode's prototype notice)
    synced = [f"{w.filename}:{w.lineno}" for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    assert not synced, synced
    with warnings.catch_warnings(record=True) as caught:  # the count sees a known sync
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            enc.sum().item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert any("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    assert enc.shape == (1, 48, 7) and trk.shape == (1, 48, 8, 2)
    assert torch.equal(enc[0, 0].cpu(), torch.tensor([0.0, 0, 0, 1, 0, 0, 0]))


def _operator_case(g, dev, kernel):
    """(operator, arguments, the plain version's f32 result, atol, rtol,
    wrapper whose count the launch raises) at one main-path shape of
    ``kernel``, in bf16 on the card."""
    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).bfloat16()

    def f32(args):
        return [a.float() if isinstance(a, torch.Tensor) else a for a in args]

    if kernel in ("K1", "K3"):
        b, l, c = (16, 577, 768) if kernel == "K1" else (576, 16, 384)
        args = [rnd(b, l, c), rnd(b, l, c), rnd(b, l, c), 8, (c // 8) ** -0.5]
        if kernel == "K1":
            return (torch.ops.comet.attention.default, args + ["base"],
                    attention_reference(*f32(args)), 3e-2, 0, fused_attention)
        return (torch.ops.comet.short_attention.default, args, attention_reference(*f32(args)),
                3e-2, 0, short_attention)
    c, hid = 384, 1536
    if kernel == "K2":
        w = [rnd(3 * c, c, std=c ** -0.5), rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5),
             rnd(c, std=0.02), rnd(hid, c, std=c ** -0.5), rnd(hid, std=0.02),
             rnd(c, hid, std=hid ** -0.5), rnd(c, std=0.02)]
        args = [rnd(576, 16, c), *w, 8]
        return (torch.ops.comet.attn_block.default, args, block_reference(*f32(args)), 3e-2,
                2.0 ** -6, fused_attn_block)
    if kernel == "K4":
        args = [rnd(16, 512, c), rnd(16, 64, c), *_cross_weights(g, dev, c, hid), 8]
        return (torch.ops.comet.cross_block.default, args, cross_block_reference(*f32(args)),
                3e-2, 2.0 ** -6, fused_cross_block)
    x = rnd(16 * 581, 768) * 3 + 1
    scale, bias = (torch.randn(768, generator=g, device=dev) for _ in range(2))
    args = [x, scale, bias, 1e-6]
    return (torch.ops.comet.layer_norm.default, args, layer_norm_reference(x.float(), scale, bias),
            1e-3, 2.0 ** -7, fused_layer_norm)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
def test_operator_cuda_implementation_matches_plain(cuda_device, kernel):
    """Each ``comet::`` operator called directly on CUDA tensors launches its
    kernel (the launch counted) and matches the plain version in f32 within
    the kernel's tolerance above."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    op, args, want, atol, rtol, wrapper = _operator_case(g, cuda_device, kernel)
    before = wrapper.launches
    got = op(*args)
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "fused"])
def test_served_forward_on_the_card(cuda_device, route, tmp_path):
    """The full-width forward, cast to bf16 once, exported, saved, loaded and
    served: its graph holds the route's kernels as operator nodes, it
    launches them as often as the eager forward, and its outputs equal the
    eager forward's bit for bit."""
    from comet_tpu_torch.config import FUSED_ROUTE, KernelRoute, get_config
    from comet_tpu_torch.models import build_comet
    from comet_tpu_torch.utils import serving
    from comet_tpu_torch.utils.serialization import cast_params_for_inference

    cfg = get_config("ours")
    model = build_comet(cfg, device=cuda_device, seed=0,
                        route=KernelRoute() if route == "default" else FUSED_ROUTE)
    cast_params_for_inference(model, cfg.dtype).requires_grad_(False)
    path = str(tmp_path / "forward.pt2")
    serving.save_exported(serving.export_forward(model, cfg), path, cfg=cfg)
    served = serving.serving_call(serving.load_exported(path))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    s, hw = cfg.seqlen, cfg.img_size
    images = torch.randn(1, s, hw, hw, 3, generator=g, device=cuda_device)
    queries = torch.rand(1, cfg.track_num, 2, generator=g, device=cuda_device) * (hw - 20) + 10
    counters = (fused_attention, fused_attn_block, short_attention, fused_cross_block,
                fused_layer_norm)

    def run(call):
        before = [c.launches for c in counters]
        with torch.inference_mode():
            out = call()
        return out, [c.launches - n for c, n in zip(counters, before)]

    want, eager_launches = run(lambda: model(images, queries))
    got, served_launches = run(lambda: served(model.state_dict(), images, queries))
    assert served_launches == eager_launches and sum(eager_launches) > 0
    for key in want:
        assert torch.equal(got[key], want[key]), key


class _Sequences:
    """Two full-width sequences of random frames, made from a seed, as a
    dataset of ``fit_epoch``."""

    def __init__(self, cfg):
        import numpy as np

        from comet_tpu_torch.data import SequenceSample

        rng = np.random.default_rng(3)
        s, hw = cfg.seqlen, cfg.img_size
        self.samples = []
        for i in range(2):
            q = rng.normal(size=(s, 4)).astype(np.float32)
            uvz = (rng.random((s, 3)) * 100 + 3).astype(np.float32)
            self.samples.append(SequenceSample(
                images=rng.normal(size=(s, hw, hw, 3)).astype(np.float32),
                t_xyz=rng.normal(size=(s, 3)).astype(np.float32),
                q_wxyz=q / np.linalg.norm(q, axis=-1, keepdims=True), t_uvz=uvz,
                r_matrix=np.zeros((s, 3, 3), np.float32), ratio=0.9, seq_name=f"seq{i}",
                image_names=[], first_mask=np.ones((hw, hw), bool)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.mark.cuda
def test_nccl_world_one_fit_epoch_equals_the_meshless_epoch(cuda_device):
    """NCCL at world size 1 through the production path (init_distributed,
    make_mesh, replicate_train_state, fit_epoch(mesh=)): the camera
    parameters and losses of two steps bit for bit those of
    fit_epoch(mesh=None) from the same weights on the same data."""
    import numpy as np
    import torch.distributed as dist

    from comet_tpu_torch import parallel
    from comet_tpu_torch.config import get_config
    from comet_tpu_torch.data import seed_query_points
    from comet_tpu_torch.models import build_comet
    from comet_tpu_torch.parallel.launch import free_port
    from comet_tpu_torch.training import (
        build_optimizer, build_train_step, camera_only_mask, fit_epoch,
    )
    from comet_tpu_torch.training.data_parallel import replicate_train_state

    cfg = get_config("ours")
    ds = _Sequences(cfg)

    def seed(sample):
        return seed_query_points(sample.images[0], sample.first_mask, cfg.track_num,
                                 cfg.min_track_num, backend="grid",
                                 rng=np.random.default_rng(0))

    runs = []
    for meshed in (False, True):
        model = build_comet(cfg, device=cuda_device, seed=0)
        optimizer, scheduler = build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
        mesh, trained = None, model
        if meshed:
            parallel.init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda:0")
            assert dist.get_backend() == "nccl"
            mesh = parallel.make_mesh(n_data=1)
            trained = replicate_train_state(mesh, model, optimizer)
        losses = []
        step = build_train_step(trained, cfg, optimizer, scheduler)
        try:
            n = fit_epoch(lambda *a: losses.append(step(*a)["loss"].item()) or {}, ds, seed, 1,
                          np.arange(2), device=None if meshed else "cuda:0", mesh=mesh)
        finally:
            if meshed:
                dist.destroy_process_group()
        mask = camera_only_mask(model)
        runs.append((n, losses, {k: p.detach().clone() for k, p in model.named_parameters()
                                 if mask[k]}))
        del model, trained, optimizer
    (n0, l0, p0), (n1, l1, p1) = runs
    assert n0 == n1 == 2 and l0 == l1 and all(np.isfinite(l0))
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


@pytest.mark.cuda
def test_no_fallback_of_device_or_backend(cuda_device):
    """A rank without a card of its own raises with both counts; a mesh
    without a process group raises."""
    from comet_tpu_torch import parallel

    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"rank {n} needs CUDA card {n}, and this machine has "
                                           f"{n} card"):
        parallel.init_distributed("localhost:1", n + 1, n, device="cuda")
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.make_mesh(n_data=1)
