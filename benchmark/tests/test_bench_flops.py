"""The analytic FLOP count's convolutions against ``torch.utils.flop_counter``
on the reference, and the hand kernels' calls a forward and a step."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness, kernels
from benchmark.reference import model as reference


@pytest.mark.parametrize("name", ["pwcdcnet", "pwcnet"])
@pytest.mark.parametrize("hw", [(64, 128), (128, 192)])
def test_conv_flops_match_the_flop_counter(name, hw):
    cfg = harness._json(harness.BENCH / "configs" / f"{name}.json")
    ref = reference.build(cfg)
    x = torch.rand(1, *hw, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(x, x)
    assert flops.conv_flops(cfg, *hw) == counter.get_total_flops()
    assert flops.conv_flops(cfg, *hw) < flops.pair_flops(cfg, *hw) < 1.1 * flops.conv_flops(cfg, *hw)
    assert flops.pair_flops(cfg, *hw, train=True) == 3 * flops.pair_flops(cfg, *hw)


def test_kernel_calls_a_forward_and_a_step():
    dc = harness._json(harness.BENCH / "configs" / "pwcdcnet.json")
    legacy = harness._json(harness.BENCH / "configs" / "pwcnet.json")
    count = lambda c: {k: len(v) for k, v in c.items()}  # noqa: E731
    assert count(kernels.calls(dc, False, 8, 448, 1024, "bfloat16", 2)) == {"K1": 4, "K2": 1, "K3": 4}
    assert count(kernels.calls(dc, True, 8, 384, 448, "float32", 2)) == {
        "K1": 4, "K2": 1, "K3": 4, "K4": 5, "K5": 4, "K6": 4}
    assert count(kernels.calls(legacy, False, 8, 448, 1024, "bfloat16")) == {"K2": 5}
    # the bounds PERF.md's kernel table gives: K2 at level 0 and K1 at the finest level, 448x1024 B=8 bf16
    calls = kernels.calls(dc, False, 8, 448, 1024, "bfloat16", 2)
    assert calls["K2"][0] * 1e3 == pytest.approx(0.00025, rel=0.05)
    assert calls["K1"][-1] * 1e3 == pytest.approx(0.0201, rel=0.05)
