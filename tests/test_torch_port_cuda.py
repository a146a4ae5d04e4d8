"""The port's CUDA kernels (K1, K2) against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. The machine with the
card has no JAX, so run them without the JAX-side conftest:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances: the kernel in bf16 against the plain version in f32 on the same
bf16 inputs, atol 3e-2 as tests/test_pallas_attn.py::test_bf16_inputs, and
for K2 two bf16 steps relative to the value on top (its output and residual
stream are rounded to bf16 at magnitudes up to ~8).
"""

import pytest
import torch

from comet_tpu_torch.ops.attn import attention_reference, fused_attention
from comet_tpu_torch.ops.block import block_reference, fused_attn_block


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,c", [(576, 16, 384), (16, 64, 384), (512, 16, 256), (7, 16, 256)])
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
