"""The benchmark's copy of the kernels' arithmetic reproduces the bound
column of the port's kernel table (PERF.md, measured on an H100 SXM):
max(operations / peak, bytes / 3.35 TB/s), inputs read once, outputs
written once."""

from __future__ import annotations

import pytest

from portbench.reference import flops

# (operator, argument shapes as the profiler records them, bound ms, bounded by)
_H, _C3, _C7 = 8, 384, 768
ROWS = [
    ("K1 ViT self", "attention", [[16, 581, 768], [16, 581, 768], [16, 581, 768], [], [], []],
     0.0170, "bytes"),
    ("K1 aggregator self", "attention", [[16, 577, 768], [16, 577, 768], [16, 577, 768]],
     0.0169, "bytes"),
    ("K1 aggregator cross", "attention", [[1, 8655, 768], [1, 577, 768], [1, 577, 768]],
     0.0155, "operations"),
    ("K1 virtual<-point", "attention", [[16, 64, 384], [16, 512, 384], [16, 512, 384]],
     0.0042, "bytes"),
    ("K2 coarse time", "attn_block",
     [[576, 16, 384], [1152, 384], [1152], [384, 384], [384], [1536, 384], [1536], [384, 1536],
      [384], []], 0.0332, "operations"),
    ("K2 coarse virtual", "attn_block",
     [[16, 64, 384], [1152, 384], [1152], [384, 384], [384], [1536, 384], [1536], [384, 1536],
      [384], []], 0.0038, "operations"),
    ("K2 fine time", "attn_block",
     [[512, 16, 256], [768, 256], [768], [256, 256], [256], [1024, 256], [1024], [256, 1024],
      [256], []], 0.0132, "operations"),
    ("K3 coarse time", "short_attention", [[576, 16, 384], [576, 16, 384], [576, 16, 384]],
     0.0085, "bytes"),
    ("K4 virtual<-point", "cross_block",
     [[16, 64, 384], [16, 512, 384], [384], [384], [384, 384], [384], [768, 384], [768],
      [384, 384], [384], [1536, 384], [1536], [384, 1536], [384], []], 0.0088, "operations"),
    ("K4 point<-virtual", "cross_block",
     [[16, 512, 384], [16, 64, 384], [384], [384], [384, 384], [384], [768, 384], [768],
      [384, 384], [384], [1536, 384], [1536], [384, 1536], [384], []], 0.0259, "operations"),
]


@pytest.mark.parametrize("where,op,shapes,bound_ms,by", ROWS, ids=[r[0] for r in ROWS])
def test_bound_reproduces_the_kernel_table(where, op, shapes, bound_ms, by):
    f, b, peak = flops.operator_work("comet::" + op, shapes)
    got, got_by = flops.bound_s(f, b, peak)
    assert round(got * 1e3, 4) == pytest.approx(bound_ms, abs=1e-4)
    assert got_by == by


@pytest.mark.parametrize("rows,affine,lo,hi", [(8192, True, 0.0075, 0.0076),
                                               (16 * 581, True, 0.0085, 0.0086)])
def test_layer_norm_bound_is_bytes_bound_in_the_table_range(rows, affine, lo, hi):
    f, b, peak = flops.operator_work("layer_norm", [[rows, 768], [768] if affine else [], [], []])
    got, by = flops.bound_s(f, b, peak)
    assert peak == flops.PEAK_F32_FLOPS and by == "bytes"
    assert lo <= round(got * 1e3, 4) <= hi


def test_no_kernel_operator_is_counted_as_none():
    assert flops.operator_work("aten::mm", [[2, 2], [2, 2]]) is None
