"""K1's A/B softmax forms (``nomax``, ``bf16e``) against the TPU tool.

The plain PyTorch versions (``ops/attn.py::attention_form_reference``) are
held to the tool's own Pallas kernel, ``blocked_attention(..., variant)`` of
``tools/micro_softmax_variants.py``, run in interpret mode on the CPU, on
the same bf16 inputs made from a numpy seed. The tool times its full-size
shapes when it is imported, so only its imports and function definitions
are executed here, from its syntax tree; the tool itself is not changed.

Tolerance: both sides round the weights and the output to bf16 at the same
points, but sum in another order, so a value near a rounding boundary may
land one bf16 step apart: a weight by 2^-8 of itself (which moves the output
by at most 2^-8 x max|v|), the output by one step at its largest magnitude
(2^-7 x max|y|, the outputs here staying below 2). The bound is the sum.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu_torch import bench_lib
from comet_tpu_torch.ops import attn

TOOL = Path(__file__).resolve().parent.parent / "tools" / "micro_softmax_variants.py"


@pytest.fixture(scope="module")
def tool():
    """The tool's imports and functions, without its module-level benchmark."""
    tree = ast.parse(TOOL.read_text())
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    namespace = {"__name__": "micro_softmax_variants"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(TOOL), "exec"), namespace)
    return namespace


# (B, Lq, Lk, C, heads): D 64 and 96 (the tool's head dimensions), Lk not a
# multiple of 8 (the tool pads and masks the keys), Lq != Lk
SHAPES = [(2, 16, 16, 256, 4), (2, 9, 13, 128, 2), (1, 20, 11, 192, 2), (3, 8, 24, 384, 4)]


def _inputs(b, lq, lk, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, c)).astype(np.float32) for n in (lq, lk, lk)]


def _bf16(arrays):
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


@pytest.mark.parametrize("form", ["nomax", "bf16e", "base"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_form_reference_matches_the_tool(tool, form, shape):
    b, lq, lk, c, h = shape
    (jq, jk, jv), (tq, tk, tv) = _bf16(_inputs(b, lq, lk, c, seed=sum(shape)))
    want = np.asarray(tool["blocked_attention"](jq, jk, jv, h, form).astype(jnp.float32))
    got = attn.attention_form_reference(tq, tk, tv, h, (c // h) ** -0.5, form)
    assert got.dtype == torch.bfloat16 and got.shape == (b, lq, c)
    tol = 2.0 ** -7 * np.abs(want).max() + 2.0 ** -8 * tv.float().abs().max().item()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_exp2_form_is_k1s_function(tool):
    """The tool's exp2 form folds log2 e into the scale: K1's function."""
    b, lq, lk, c, h = SHAPES[1]
    (jq, jk, jv), (tq, tk, tv) = _bf16(_inputs(b, lq, lk, c, seed=7))
    want = np.asarray(tool["blocked_attention"](jq, jk, jv, h, "exp2").astype(jnp.float32))
    got = attn.attention_reference(tq, tk, tv, h, (c // h) ** -0.5).float().numpy()
    tol = 2.0 ** -7 * np.abs(want).max() + 2.0 ** -8 * tv.float().abs().max().item()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("form", ["nomax", "bf16e"])
def test_forms_differ_from_base_and_are_close_to_it(form):
    """Each form is an inexact A/B variant of K1's softmax: not K1's result,
    but within a few bf16 steps of it on unit-scale inputs."""
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in _inputs(2, 16, 40, 256, seed=3))
    base = attn.attention_reference(tq, tk, tv, 4, 64 ** -0.5).float()
    got = attn.attention_form_reference(tq, tk, tv, 4, 64 ** -0.5, form).float()
    assert (got - base).abs().max() <= 4 * 2.0 ** -7
    if form == "bf16e":
        assert not torch.equal(got, base)


def test_fused_attention_takes_the_forms_on_the_cpu():
    tq, tk, tv = (torch.from_numpy(a) for a in _inputs(4, 16, 16, 256, seed=5))
    for form in ("nomax", "bf16e"):
        # short sequences too: the forms never go to K3's plain version
        got = attn.fused_attention(tq, tk, tv, 4, softmax=form)
        want = attn.attention_form_reference(tq, tk, tv, 4, 0.125, form)
        assert torch.equal(got, want)
    assert torch.equal(attn.fused_attention(tq, tk, tv, 4, softmax="base"),
                       attn.attention_reference(tq, tk, tv, 4, 0.125))
    with pytest.raises(ValueError, match="softmax form"):
        attn.fused_attention(tq, tk, tv, 4, softmax="exp3")


def test_run_softmax_variants_on_the_cpu():
    lines = []
    shapes = [("vit-like", 2, 9, 9, 256, 4), ("agg-like", 2, 10, 10, 192, 2)]
    out = bench_lib.run_softmax_variants(reps=2, device="cpu", shapes=shapes,
                                         print_fn=lines.append)
    assert [r["name"] for r in out] == ["vit-like", "agg-like"]
    for r in out:
        assert list(r["forms"]) == ["base", "nomax", "exp2", "bf16e"]
        assert r["forms"]["base"]["max_abs_err"] == 0.0  # the reference itself on the CPU
        for form in r["forms"].values():
            assert form["ms"] > 0 and form["max_abs_err"] <= 4 * 2.0 ** -7
    assert lines[0] == "== vit-like [2x9x256, 4 heads]" and len(lines) == 10


def test_run_softmax_variants_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_lib.run_softmax_variants()
