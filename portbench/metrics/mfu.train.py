"""The whole train step's share of the card's bf16 peak: the plain
reference's operations per sequence (the forward, and the backward of the
trained camera predictor, counted at the cell's shapes) times the sequences
that the untraced rest of a traced window trained, over that rest's
host-clock seconds times 989 TFLOP/s, in percent."""

from portbench.reference.flops import PEAK_BF16_FLOPS


def read(r):
    if r.tail_s <= 0 or not r.tail_sequences:
        return None
    return 100.0 * r.model_flops_per_sequence() * r.tail_sequences / (r.tail_s * PEAK_BF16_FLOPS)
