"""The FLOP count against ``torch.utils.flop_counter`` over the port's plain
forward, and the DC5 / R50 ratio against the paper's.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from benchmark import flops
from benchmark.reference import weights

torch.set_num_threads(2)
R50 = dict(tiny.MODEL, hidden_size=256, num_attention_heads=8, ffn_scale_factor=8,
           num_encoder_layers=6, num_decoder_layers=6, num_object_queries=100)


@pytest.mark.parametrize("dilation", [False, True])
@pytest.mark.parametrize("canvas", [(64, 96), (96, 64)])
def test_forward_flops_are_the_counters(dilation, canvas):
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.models.detr import DETR

    cfg = dict(R50, dilation=dilation)
    model = DETR(DETRConfig(**cfg))
    model.load_state_dict(weights.make(cfg, 0, "cpu"))
    model.eval()
    x = torch.zeros(1, *canvas, 3)
    ext = torch.tensor([canvas[0]]), torch.tensor([canvas[1]])
    with FlopCounterMode(display=False) as counter:
        model(x, *ext)
    assert flops.forward_flops(cfg, *canvas) == counter.get_total_flops()


def test_dc5_over_r50_is_the_papers():
    """arXiv:2005.12872 Table 1: 187 and 86 GFLOPs (averaged over COCO val
    images); at an 800 x 1199 canvas the count's ratio is within 2 %."""
    ratio = (flops.forward_flops(dict(R50, dilation=True), 800, 1199)
             / flops.forward_flops(R50, 800, 1199))
    assert abs(ratio / (187 / 86) - 1) < 0.02


def test_attention_bounds():
    fwd, bwd = flops.attention_bounds(8, 1092, 1092, True, 8, 32)
    assert 0 < fwd < bwd
    # 4 B H L S D operations at the bf16 peak bound the forward at this size
    assert fwd == pytest.approx(4 * 8 * 8 * 1092 * 1092 * 32 / 989e12)
