"""The plain reference against the port's plain path on the CPU, on the
same weights and frames: the flows of both configurations, the train
step's loss and one step's parameters."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import model as reference
from benchmark.reference import train as ref_train


def _weights(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return harness.draw_weights(reference.build(cfg, "meta"), g, "cpu"), g


@pytest.mark.parametrize("name", ["pwcdcnet", "pwcnet"])
def test_flows_match_the_port(name):
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, PWCNet

    cfg = harness._json(harness.BENCH / "configs" / f"{name}.json")
    weights, g = _weights(cfg)
    port = (PWCDCNet if name == "pwcdcnet" else PWCNet)(init=False)
    port.load_state_dict(weights)
    ref = reference.build(cfg)
    ref.load_state_dict(weights)
    frames = harness.stream_frames(g, 3, 64, 128, (3, 1), "cpu").float() / 255.0
    with torch.no_grad():
        got, want = port(frames[:2], frames[1:])[0], ref(frames[:2], frames[1:])
    want = want[0] if name == "pwcdcnet" else want
    assert want.abs().mean() > 0.1
    assert float(harness._pair_gaps(got, want).max()) < 1e-5


def test_parameter_count_is_the_published_models():
    for name, count in (("pwcdcnet", 5_029_868), ("pwcnet", 4_273_628)):
        cfg = harness._json(harness.BENCH / "configs" / f"{name}.json")
        assert sum(p.numel() for p in reference.build(cfg, "meta").parameters()) == count == cfg["parameters"]


def test_train_step_matches_the_port():
    from benchmark.loops import train as loop
    from pwcnet_tpu_torch.train_lib.step import ADAM_B1, create_train_state, make_train_step

    cfg = harness._json(harness.BENCH / "configs" / "pwcdcnet.json")
    weights, g = _weights(cfg, 5)
    pool = harness.train_pool(g, 1, 2, 64, 128, 8.0, "cpu")
    model = loop.build(cfg, torch.float32, torch.device("cpu"))
    model.load_state_dict(weights)
    state = create_train_state(model, learning_rate=ref_train.LR, device="cpu")
    state, metrics = make_train_step(model)(state, *pool[0])
    ref = reference.build(cfg)
    ref.load_state_dict(weights)
    out = ref_train.follow_steps(ref, pool, chunk=1)
    grad1 = {k: v / (1 - ADAM_B1) for k, v in state.mu.items()}
    change = {k: p.detach() - weights[k] for k, p in model.named_parameters()}
    ref_change = {k: p.detach() - weights[k] for k, p in ref.named_parameters()}
    out["change"] = ref_change
    gaps = harness.train_gaps({"losses": [float(metrics["data_loss"])], "grad1": grad1, "change": change}, out)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
    for k, p in ref.named_parameters():
        assert (p - weights[k]).abs().max() > 0, k
        assert torch.allclose(grad1[k], out["grad1"][k], rtol=1e-3, atol=1e-4 * out["grad1"][k].abs().max()), k
