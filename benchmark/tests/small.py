"""Cells of the benchmark cut to a size a CPU test run holds: the same
configurations at full depth and width on small frames and batches."""

from __future__ import annotations

import time

import torch

from benchmark import harness

SMALL = {
    "stream": dict(height=64, width=128, batch=2, frames=8, warm_pairs=4, sample=4),
    "forward": dict(height=64, width=128, batch=2, pool=2, warm_batches=1, sample=2),
    "train": dict(height=128, width=192, batch=4, pool=3, warm_steps=1, check_chunk=4),
}
CELLS = ("pwcdcnet.stream.bf16", "pwcdcnet.train.f32", "pwcnet.forward.bf16", "pwcdcnet.train.bf16.b64")


def small_ctx(name: str, seed: int = 2**31 + 11, readings=()) -> harness.Ctx:
    """The cell ``name`` on the CPU at a small size, with a half-second window."""
    cell = harness.load_cell(name)
    cell["traffic"].update(SMALL[cell["traffic"]["loop"]])
    return harness.Ctx(name=name, cell=cell, seed=seed, seconds=0.5, trace=False, device=torch.device("cpu"),
                       t_start=time.perf_counter(), readings=readings)
