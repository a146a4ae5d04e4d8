"""The port's K1 (fused attention) and K2 (fused attention block) against
the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (or its reference where its
dispatch takes it). Both run in f32 on the same numpy inputs. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.models.blocks import AttnBlock as JaxAttnBlock
from comet_tpu.ops.pallas_attn import _reference_attention
from comet_tpu.ops.pallas_attn import fused_attention as jax_fused_attention
from comet_tpu.ops.pallas_block import fused_attn_block as jax_fused_attn_block
from comet_tpu_torch.models.blocks import AttnBlock
from comet_tpu_torch.ops.attn import attention_reference, fused_attention
from comet_tpu_torch.ops.block import fused_attn_block
from comet_tpu_torch.weights import state_dict_from_flax


def _qkv(b, lq, lk, c, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, c)).astype(np.float32) for n in (lq, lk, lk)]


@pytest.mark.parametrize(
    "b,lq,lk,c,h",
    [
        (2, 200, 200, 96, 4),  # JAX blocked Pallas kernel, D 24
        (1, 300, 139, 64, 2),  # blocked, Lk masked in the kernel
        (16, 64, 512, 96, 2),  # blocked, the update-former virtual<-point form
    ],
)
def test_k1_matches_jax_pallas_kernel(b, lq, lk, c, h):
    q, k, v = _qkv(b, lq, lk, c)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h))
    got = fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("b,lq,lk,c,h", [(4, 1, 100, 64, 4), (1, 16, 16, 96, 2)])
def test_k1_matches_jax_reference_where_jax_skips_its_kernel(b, lq, lk, c, h):
    # Lq = 1 (trajectory cross-attention) and the trunk's single 16-row
    # sequence take JAX's reference; the port sends them to K1 as well
    q, k, v = _qkv(b, lq, lk, c, seed=1)
    want = np.asarray(
        _reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, (c // h) ** -0.5)
    )
    got = fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_k1_takes_column_slices_of_a_packed_projection():
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(3, 40, 3 * 64)).astype(np.float32))
    q, k, v = qkv.split(64, dim=-1)
    got = fused_attention(q, k, v, 4)
    want = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), 4, 0.25)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("b,lq,lk,c,h", [(4, 70, 100, 64, 4), (3, 1, 577, 96, 2)])
def test_k1_takes_keys_and_values_expanded_over_the_batch(b, lq, lk, c, h):
    # one set of keys and values for every sequence, as an expand (stride 0)
    q, k, v = _qkv(b, lq, lk, c, seed=3)
    k, v = k[:1], v[:1]
    want = np.asarray(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(np.broadcast_to(k, (b, lk, c))),
        jnp.asarray(np.broadcast_to(v, (b, lk, c))), h))
    got = fused_attention(torch.from_numpy(q), torch.from_numpy(k).expand(b, lk, c),
                          torch.from_numpy(v).expand(b, lk, c), h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _block_params(c, hidden, seed):
    rng = np.random.default_rng(seed)
    s = 0.1
    return dict(
        wqkv=rng.normal(size=(c, 3 * c)) * s, bqkv=rng.normal(size=(3 * c,)) * s,
        wout=rng.normal(size=(c, c)) * s, bout=rng.normal(size=(c,)) * s,
        w1=rng.normal(size=(c, hidden)) * s, b1=rng.normal(size=(hidden,)) * s,
        w2=rng.normal(size=(hidden, c)) * s, b2=rng.normal(size=(c,)) * s,
    )


def _torch_layout(p):
    # JAX kernels are [in, out]; the port's weights are [out, in]
    return [torch.from_numpy(np.ascontiguousarray(a.T).astype(np.float32)) for a in p.values()]


@pytest.mark.parametrize(
    "b,l,c,h",
    [
        (64, 16, 128, 8),  # JAX lane-packed attention inside the kernel
        (37, 16, 64, 4),  # JAX _heads_attend path, batch padded and cropped
    ],
)
def test_k2_matches_jax_pallas_kernel(b, l, c, h):
    p = _block_params(c, 4 * c, seed=3)
    x = np.random.default_rng(4).normal(size=(b, l, c)).astype(np.float32)
    want = np.asarray(
        jax_fused_attn_block(jnp.asarray(x), *(jnp.asarray(a, jnp.float32) for a in p.values()),
                             num_heads=h)
    )
    got = fused_attn_block(torch.from_numpy(x), *_torch_layout(p), h)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


@pytest.mark.parametrize("b,l,c,h", [(64, 16, 128, 8), (37, 16, 64, 4)])
def test_attn_block_module_matches_jax(b, l, c, h):
    x = np.random.default_rng(5).normal(size=(b, l, c)).astype(np.float32)
    blk = JaxAttnBlock(num_heads=h)
    params = jax.tree_util.tree_map(np.asarray, blk.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(blk.apply(params, jnp.asarray(x)))
    port = AttnBlock(c, h)
    port.load_state_dict(state_dict_from_flax(params, port.state_dict()))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_k2_plain_version_keeps_sequences_apart():
    c, h = 64, 4
    w = _torch_layout(_block_params(c, 2 * c, seed=6))
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 16, c)).astype(np.float32))
    x[1] = x[0]
    out = fused_attn_block(x, *w, h)
    torch.testing.assert_close(out[0], out[1], atol=1e-6, rtol=0)
    x2 = x.clone()
    x2[1] += 3.0
    out2 = fused_attn_block(x2, *w, h)
    torch.testing.assert_close(out2[0], out[0], atol=1e-6, rtol=0)
