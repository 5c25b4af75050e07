"""The SyntheticFlow convergence proof of the port (counterpart of the JAX
package's ``tests/test_convergence.py``).

PWCDCNet (3 levels, output level 1, search range 2) must drive the mean
end-point error over all 16 samples of a 32x32 SyntheticFlow set (constant
integer flows up to ±2 px) below 0.5 px in a fixed number of Adam steps,
batch 8, no schedule:

- ``multiscale``: 400 float32 steps at lr 1e-3;
- ``remat``: the same with ``PWCDCNet(remat=True)``;
- ``robust``: 150 robust-loss steps that continue a 300-step multiscale
  warm start (its Adam moments and its batch stream);
- ``bf16``: 120 steps in bf16 compute at lr 1e-4 from the warm start's
  parameters with fresh Adam moments, on the batches that follow it.

Whether the proof holds depends on the init: from some inits every case
settles on one constant flow (1.862 px, within 1e-3 of the least EPE a
constant flow reaches, ``constant_flow_epe``) in both packages. The JAX proof
starts from ``PRNGKey(0)``, and so does the port's (``jax_init``, the
same parameters bit for bit); ``scripts/torch_record_convergence.py
--sweep`` records which JAX keys converge.

With ``use_kernels`` the model is wired as the trainer wires it on the
card (K2 at level 0, K1 at level 1, K3 on the two pyramid levels of each
frame that it fuses; K4, K5 and K6 in the backward).
"""

from __future__ import annotations

import hashlib
import itertools
import time
from typing import Callable, Optional

import numpy as np
import torch

from pwcnet_tpu_torch.data import DataLoader, get_dataset
from pwcnet_tpu_torch.inference import FUSED_PYRAMID_LEVELS
from pwcnet_tpu_torch.models.pwcnet import PWCDCNet
from pwcnet_tpu_torch.prng import PRNGKey
from pwcnet_tpu_torch.train_lib.step import TrainState, create_train_state, make_eval_step, make_train_step

__all__ = [
    "CFG", "CASES", "EPE_TARGET", "batches", "build_model", "constant_flow_epe", "dataset", "full_set_epe",
    "jax_init", "on_constant_flow", "params_sha1", "run_cases", "start_state", "train",
]

CFG = dict(num_levels=3, output_level=1, search_range=2)
IMAGE_HW = (32, 32)
NUM_SAMPLES, MAX_DISP, BATCH, LOADER_SEED = 16, 2, 8, 1
EPE_TARGET = 0.5
LR, BF16_LR = 1e-3, 1e-4
STEPS = {"multiscale": 400, "remat": 400, "warm": 300, "robust": 150, "bf16": 120}
CASES = ("multiscale", "remat", "robust", "bf16")


def dataset():
    """The 16 training samples."""
    return get_dataset("Synthetic")(
        train_or_val="train", dataset_dir=".", num_samples=NUM_SAMPLES, image_shape=IMAGE_HW, max_disp=MAX_DISP)


def batches(dset, skip: int = 0):
    """The proof's endless batch stream (shuffled, loader seed 1), from its
    ``skip``-th batch."""

    def stream():
        loader = DataLoader(dset, batch_size=BATCH, shuffle=True, drop_last=True, seed=LOADER_SEED)
        while True:
            yield from loader

    return itertools.islice(stream(), skip, None)


def build_model(use_kernels: bool = False, remat: bool = False, compute_dtype=None) -> PWCDCNet:
    """The proof's PWCDCNet, its parameters not drawn (``start_state`` loads
    them); ``use_kernels`` wires it as the trainer does on the card (the
    wrappers take CPU tensors to their plain versions)."""
    hooks = {}
    if use_kernels:
        from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
        from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

        hooks = dict(cost_volume_fn=cost_volume_cuda, warp_cv_fn=warped_cost_volume,
                     fused_pyramid_levels=FUSED_PYRAMID_LEVELS)
    return PWCDCNet(**CFG, remat=remat, compute_dtype=compute_dtype, init=False, **hooks)


def jax_init(seed: int = 0) -> dict:
    """The proof's initial parameters from ``PRNGKey(seed)``: those of the
    JAX ``create_train_state(PWCDCNet(**CFG), PRNGKey(seed), ...)``."""
    model = build_model()
    create_train_state(model, PRNGKey(seed), device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}


def params_sha1(params: dict) -> str:
    """The SHA-1 of a state dict: each name (UTF-8) and then its tensor's
    float32 bytes in C order, by sorted name."""
    m = hashlib.sha1()
    for name in sorted(params):
        m.update(name.encode("utf-8"))
        m.update(params[name].detach().to("cpu", torch.float32).contiguous().numpy().tobytes())
    return m.hexdigest()


def start_state(params: dict, device, lr: float = LR, **model_kwargs) -> TrainState:
    """A fresh state (zero moments, step 0) on ``params``."""
    model = build_model(**model_kwargs)
    model.load_state_dict(params)
    return create_train_state(model, learning_rate=lr, lr_scheduling=False, device=device)


def train(state: TrainState, gen, steps: int, loss_name: str = "multiscale",
          on_step: Optional[Callable[[int, dict], None]] = None) -> TrainState:
    """``steps`` train steps on the next batches of ``gen``; ``on_step(i,
    metrics)`` after each (metrics on the device)."""
    device = next(state.model.parameters()).device
    step = make_train_step(state.model, loss_name=loss_name)
    for i in range(steps):
        images, flows = next(gen)
        state, metrics = step(state, torch.from_numpy(images).to(device), torch.from_numpy(flows).to(device))
        if on_step is not None:
            on_step(i, metrics)
    return state


def full_set_epe(model, dset) -> float:
    """Mean EPE over every sample: the mean of the eval step's batch EPEs
    over the unshuffled loader (batch 8, the last batch kept)."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model)
    loader = DataLoader(dset, batch_size=BATCH, shuffle=False, drop_last=False)
    # the eval step reads the model's parameters, not a state
    epes = [float(eval_step(None, torch.from_numpy(i).to(device), torch.from_numpy(f).to(device))["epe"])
            for i, f in loader]
    return float(np.mean(epes))


def constant_flow_epe(dset) -> float:
    """The least full-set EPE one constant flow reaches: the mean distance
    of the samples' flows (each constant) from their geometric median, by
    Weiszfeld's iteration. 1.8618 px on the proof's set."""
    v = np.stack([dset[i][1][0, 0] for i in range(len(dset))]).astype(np.float64)
    c = v.mean(0)
    for _ in range(200):
        r = np.maximum(np.linalg.norm(v - c, axis=1), 1e-12)
        c = (v / r[:, None]).sum(0) / (1 / r).sum()
    return float(np.linalg.norm(v - c, axis=1).mean())


def on_constant_flow(epe: float, dset) -> bool:
    """Whether a full-set EPE is the constant-flow state's (within 5e-3 px of
    ``constant_flow_epe``): the init did not escape it, where a fault of the
    path would leave the EPE elsewhere."""
    return abs(epe - constant_flow_epe(dset)) < 5e-3


def run_cases(params: dict, device, use_kernels: bool = False, cases=CASES,
              on_step: Optional[Callable[[str, int, dict], None]] = None,
              on_start: Optional[Callable[[str], None]] = None) -> dict:
    """Run the proof's ``cases`` from ``params``; returns per case (and
    for the warm start, ``"warm"``) ``{"steps", "epe", "seconds",
    "params"}``: the seconds of its steps, its full-set EPE and its final
    parameters (a state dict on ``device``, to hold two runs bit for bit). The
    warm start of ``robust`` and ``bf16`` runs once; ``robust`` continues it
    and ``bf16`` restarts from its parameters on the batches that follow
    it. ``on_start(name)`` runs just before a case's first step,
    ``on_step(name, i, metrics)`` after each step."""
    dset = dataset()
    out = {}

    def case(name, state, gen, loss_name="multiscale"):
        if on_start is not None:
            on_start(name)
        if next(state.model.parameters()).is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        hook = None if on_step is None else (lambda i, m: on_step(name, i, m))
        state = train(state, gen, STEPS[name], loss_name, on_step=hook)
        out[name] = {"steps": STEPS[name], "epe": full_set_epe(state.model, dset),
                     "seconds": time.perf_counter() - t0,
                     "params": {k: v.detach().clone() for k, v in state.model.state_dict().items()}}
        return state

    for name, remat in (("multiscale", False), ("remat", True)):
        if name in cases:
            case(name, start_state(params, device, use_kernels=use_kernels, remat=remat), batches(dset))
    if "robust" in cases or "bf16" in cases:
        warm = case("warm", start_state(params, device, use_kernels=use_kernels), batches(dset))
        warm_params = {k: v.detach().clone() for k, v in warm.model.state_dict().items()}
        if "bf16" in cases:
            case("bf16", start_state(warm_params, device, lr=BF16_LR, use_kernels=use_kernels,
                                     compute_dtype=torch.bfloat16), batches(dset, skip=STEPS["warm"]))
        if "robust" in cases:
            case("robust", warm, batches(dset, skip=STEPS["warm"]), "robust")
    return out
