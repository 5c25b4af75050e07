"""The check that decides ``correct``, driven on the CPU at a small size:
a sound run passes; the control (the reference one precision below the
cell's, in the program's place) fails the cell's limits (the bf16 step's
on the card, at its own size); and a run with the timed path broken
underneath comes out not correct, once for each fault the cell can have."""

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from benchmark.tests.small import CELLS, small_ctx


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result, checks, _ = run_cell(small_ctx(name))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", [c for c in CELLS if c != "pwcdcnet.train.bf16.b64"])
def test_the_control_is_not_correct(name):
    _, _, readings = run_cell(small_ctx(name, readings=("control",)))
    assert not harness.judge(readings["control"], small_ctx(name).cell["limits"])[0], readings


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3_300_000_000, 3_300_000_001, 3_300_000_002])
def test_the_bf16_step_control_is_not_correct_at_its_own_size(seed):
    """The bf16 step's fp8 control is read at the cell's own frames and batch,
    which only the card holds: at 128x192 on the CPU its numbers sit too
    near the program's for the cell's limits to tell them apart."""
    if not torch.cuda.is_available():
        pytest.skip("the bf16 step's control is read at the cell's own size, on the card")
    ctx = small_ctx("pwcdcnet.train.bf16.b64", seed=seed, readings=("control",))
    ctx.cell["traffic"] = harness.load_cell(ctx.name)["traffic"]
    ctx.device, ctx.seconds = torch.device("cuda"), 1.0
    result, _, readings = run_cell(ctx)
    assert result["correct"]
    assert not harness.judge(readings["control"], ctx.cell["limits"])[0], readings


def _half_forward(cls, monkeypatch):
    """The model runs on the first half of each batch; the rest repeats it."""
    forward = cls.forward

    def half(self, a, b, *args, **kw):
        n = max(1, a.shape[0] // 2)
        out = forward(self, a[:n], b[:n], *args, **kw)
        rep = lambda t: torch.cat([t, t[: a.shape[0] - n]])  # noqa: E731
        return tuple(rep(o) if torch.is_tensor(o) else [rep(x) for x in o] for o in out)

    monkeypatch.setattr(cls, "forward", half)


def _altered_forward(cls, monkeypatch):
    """Every final flow comes out 10% too long."""
    forward = cls.forward

    def altered(self, *args, **kw):
        out = forward(self, *args, **kw)
        return (out[0] * 1.1, *out[1:])

    monkeypatch.setattr(cls, "forward", altered)


def _step(monkeypatch, fault, sound_calls=0):
    """The train step returns its state unchanged, or steps on half of each
    batch, from its call ``sound_calls`` on (``late``: unchanged once the
    checked first steps and the warm-up are past, a fault of the steady
    state alone)."""
    from pwcnet_tpu_torch.train_lib import step as step_lib

    make = step_lib.make_train_step

    def broken(model, **kw):
        real = make(model, **kw)
        loss_fn = step_lib.make_loss_fn(model)
        calls = [0]

        def step(state, images, flows):
            calls[0] += 1
            if calls[0] <= sound_calls:
                return real(state, images, flows)
            if fault in ("unchanged", "late"):
                with torch.no_grad():
                    return state, loss_fn(images, flows)[1]
            n = max(1, images.shape[0] // 2)
            return real(state, images[:n], flows[:n])

        return step

    monkeypatch.setattr(step_lib, "make_train_step", broken)


FAULTS = [
    ("pwcdcnet.stream.bf16", "half"), ("pwcdcnet.stream.bf16", "altered"),
    ("pwcnet.forward.bf16", "half"), ("pwcnet.forward.bf16", "altered"),
    ("pwcdcnet.train.f32", "unchanged"), ("pwcdcnet.train.f32", "half"), ("pwcdcnet.train.f32", "late"),
    ("pwcdcnet.train.bf16.b64", "unchanged"), ("pwcdcnet.train.bf16.b64", "half"),
    ("pwcdcnet.train.bf16.b64", "late"),
]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, PWCNet

    cls = PWCNet if name.startswith("pwcnet.") else PWCDCNet
    if ".train." in name:
        from benchmark.loops.train import CHECKED_STEPS

        warm = small_ctx(name).traffic["warm_steps"]
        _step(monkeypatch, fault, CHECKED_STEPS + warm if fault == "late" else 0)
    elif fault == "half":
        _half_forward(cls, monkeypatch)
    else:
        _altered_forward(cls, monkeypatch)
    result, checks, _ = run_cell(small_ctx(name))
    assert not result["correct"], checks
