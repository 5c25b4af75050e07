"""A train step of the port gives the same bits on every run on the card.

The JAX step does (XLA is deterministic on its chip). On the card three
things decide it, and this file holds each on the CPU; ``chip_smoke.py``
``[determinism]`` holds the bits on the H100 and ``tests/test_torch_kernels.py``
the plain warp's backward there:

- the plain warp's gather (``ops/warp.py`` ``_GatherRows``) transposes to a
  sum whose order is fixed: ``scatter_add_`` on a CPU tensor, a sorted
  ``index_put_(accumulate=True)`` on a CUDA one. (a) its gradient through
  the three warps against ``jax.vjp`` of the JAX package's; (b) the CUDA
  formulation, run on CPU tensors, against the CPU one;
- no backward node of a training graph is one that PyTorch documents as
  nondeterministic on a CUDA tensor (c): the list is taken from
  ``torch.use_deterministic_algorithms``' docstring, whose entries are
  checked against the installed PyTorch's;
- cuDNN's convolutions are the one op left, and ``make_train_step`` runs
  the forward and the backward with ``torch.backends.cudnn.deterministic``
  and gives the caller's value back (d).

Tolerances: float32 gradients differ from the JAX ones only in summation
order, rtol=1e-5 with ``test_torch_ops.py``'s atol=1e-6 on the frame's
gradient and ``test_torch_backward.py``'s atol=1e-4 on the flow's (a sum
of g times corner differences over the channels). bfloat16: the port sums
in float32 and rounds once (the port's rule for its bf16 plain ops), so it
is held within one bf16 ulp of the result's scale (2**-7) of the JAX
gradient taken in float32 on the same bf16 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.warp import bilinear_warp as jax_bilinear_warp
from pwcnet_tpu.ops.warp import bilinear_warp_rows as jax_bilinear_warp_rows
from pwcnet_tpu.ops.warp import nearest_warp as jax_nearest_warp
from pwcnet_tpu_torch.losses import scored_rows
from pwcnet_tpu_torch.models import PWCDCNet, PWCNet
from pwcnet_tpu_torch.models.pwcnet import kernel_hooks
from pwcnet_tpu_torch.ops.resize import nearest_indices, resize_bilinear
from pwcnet_tpu_torch.ops.warp import (
    _GatherRows,
    _rows_bwd_scatter,
    _rows_bwd_sorted,
    bilinear_warp,
    bilinear_warp_rows,
    nearest_warp,
)
from pwcnet_tpu_torch.prng import PRNGKey
from pwcnet_tpu_torch.train_lib import create_train_state, make_loss_fn, make_train_step

torch.set_num_threads(1)

RTOL, ATOL, ATOL_FLOW = 1e-5, 1e-6, 1e-4
TINY = dict(num_levels=3, output_level=1, search_range=2)
HW = 32

# Backward nodes whose op PyTorch documents as nondeterministic on a CUDA
# tensor, each beside the entry of ``torch.use_deterministic_algorithms``'
# docstring it comes from. Ops whose forward is the nondeterministic part
# (scatter_add_, index_add, ...) are listed by their own node: a graph
# that holds one ran the op. ``torch.repeat_interleave``'s entry is
# ``IndexSelectBackward0``'s: it differentiates through ``index_select``. ``ConvolutionBackward0`` is not here: cuDNN's
# deterministic algorithms cover it, and ``make_train_step`` asks for them
# (TestStepFlag).
NONDETERMINISTIC = {
    "GatherBackward0": "torch.gather` when called on a CUDA tensor that requires grad",
    "IndexSelectBackward0": "torch.index_select` when attempting to differentiate a CUDA tensor",
    "ScatterAddBackward0": "torch.Tensor.scatter_add_` when called on a CUDA tensor",
    "IndexAddBackward0": "torch.index_add` when called on CUDA tensor",
    "IndexCopyBackward0": "torch.Tensor.index_copy` when called on a CPU or CUDA tensor",
    "IndexPutBackward0": "torch.Tensor.index_put` with ``accumulate=False``",
    "ScatterBackward0": "torch.Tensor.scatter` when `src` type is Tensor and called on CUDA tensor",
    "ScatterReduceBackward0": "torch.Tensor.scatter_reduce` when ``reduce='sum'`` or ``reduce='mean'``",
    "ReplicationPad2DBackward0": "torch.nn.ReplicationPad2d` when attempting to differentiate a CUDA tensor",
    "MaxPool3DWithIndicesBackward0": "torch.nn.MaxPool3d` when attempting to differentiate a CUDA tensor",
    "AvgPool3DBackward0": "torch.nn.AvgPool3d` when attempting to differentiate a CUDA tensor",
    "AdaptiveAvgPool2DBackward0": "torch.nn.AdaptiveAvgPool2d` when attempting to differentiate a CUDA tensor",
    "AdaptiveMaxPool2DBackward0": "torch.nn.AdaptiveMaxPool2d` when attempting to differentiate a CUDA tensor",
    "UpsampleBilinear2DBackward0": "torch.nn.functional.interpolate` when attempting to differentiate a CUDA",
    "ReflectionPad2DBackward0": "torch.nn.ReflectionPad2d` when attempting to differentiate a CUDA tensor",
    "NllLossBackward0": "torch.nn.NLLLoss` when called on a CUDA tensor",
    "PutBackward0": "torch.Tensor.put_` when ``accumulate=True`` and called on a CUDA tensor",
    "GridSampler2DBackward0": "torch.nn.functional.grid_sample` when attempting to differentiate a CUDA",
    "CumsumBackward0": "torch.cumsum` when called on a CUDA tensor when dtype is floating point",
}

# a CPU graph that holds each listed node: the names are the installed
# PyTorch's own
_MAKERS = {
    "GatherBackward0": lambda x: torch.gather(x, 1, torch.zeros(4, 1, dtype=torch.long)),
    "IndexSelectBackward0": lambda x: x.index_select(0, torch.tensor([0, 0])),
    "ScatterAddBackward0": lambda x: x.scatter_add(0, torch.zeros(4, 4, dtype=torch.long), x),
    "IndexAddBackward0": lambda x: x.index_add(0, torch.tensor([0, 0, 1, 1]), x),
    "IndexCopyBackward0": lambda x: x.index_copy(0, torch.tensor([3, 2, 1, 0]), x),
    "IndexPutBackward0": lambda x: x.index_put((torch.tensor([0]),), x[:1]),
    "ScatterBackward0": lambda x: x.scatter(0, torch.zeros(1, 4, dtype=torch.long), x[:1]),
    "ScatterReduceBackward0": lambda x: x.scatter_reduce(0, torch.zeros(4, 4, dtype=torch.long), x, "sum"),
    "ReplicationPad2DBackward0": lambda x: torch.nn.functional.pad(x[None, None], (1, 1, 1, 1), mode="replicate"),
    "MaxPool3DWithIndicesBackward0": lambda x: torch.nn.functional.max_pool3d(x[None, None, None], (1, 2, 2)),
    "AvgPool3DBackward0": lambda x: torch.nn.functional.avg_pool3d(x[None, None, None], (1, 2, 2)),
    "AdaptiveAvgPool2DBackward0": lambda x: torch.nn.functional.adaptive_avg_pool2d(x[None, None], 3),
    "AdaptiveMaxPool2DBackward0": lambda x: torch.nn.functional.adaptive_max_pool2d(x[None, None], 3)[0],
    "UpsampleBilinear2DBackward0": lambda x: torch.nn.functional.interpolate(x[None, None], scale_factor=2,
                                                                             mode="bilinear"),
    "ReflectionPad2DBackward0": lambda x: torch.nn.functional.pad(x[None, None], (1, 1, 1, 1), mode="reflect"),
    "NllLossBackward0": lambda x: torch.nn.functional.nll_loss(x, torch.tensor([0, 1, 2, 3])),
    "PutBackward0": lambda x: x.put(torch.tensor([0, 0]), x[0, :2], accumulate=True),
    "GridSampler2DBackward0": lambda x: torch.nn.functional.grid_sample(
        x[None, None], torch.zeros(1, 2, 2, 2), align_corners=False),
    "CumsumBackward0": lambda x: x.cumsum(0),
}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _edge_flow(rng, shape, scale):
    """Random flow plus pixels pushed far out of the frame on every side:
    their corners clamp onto the border, so many pixels sum onto one."""
    flow = _normal(rng, shape[:3] + (2,), scale)
    flow[:, 0, :, 1] = -40.0
    flow[:, -1, :, 1] = 40.0
    flow[:, :, 0, 0] = -40.0
    flow[:, :, -1, 0] = 40.0
    flow[:, 1, 1] = (0.5, -1.5)
    return flow


def _grad_fn_names(t: torch.Tensor) -> set:
    """The names of every node of ``t``'s backward graph."""
    seen, names, stack = set(), set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


# ---------------------------------------------------------------- (a), (b)
def _warp_case(name, rng, dtype):
    """(port function of (x, flow), JAX function of (x, flow), x, flow):
    the three warps, the rows warp at a row offset against the JAX rows
    warp with the offset folded into flow y (exact for whole rows)."""
    if name == "bilinear_warp":
        x = _normal(rng, (2, 7, 9, 5))
        return bilinear_warp, jax_bilinear_warp, x, _edge_flow(rng, x.shape, 3.0)
    if name == "nearest_warp":
        x = _normal(rng, (2, 7, 9, 5))
        flow = _edge_flow(rng, x.shape, 2.5)
        flow[:, 2, 2] = (-0.7, 0.7)  # truncation toward zero
        return nearest_warp, jax_nearest_warp, x, flow
    row0 = int(name.rsplit("_", 1)[1])
    x = _normal(rng, (2, 11, 9, 5))  # the frame: taller than the 6 flow rows
    flow = _edge_flow(rng, (2, 6, 9, 5), 2.0)
    offset = np.array([0.0, row0], np.float32)
    return (lambda a, f: bilinear_warp_rows(a, f, row0),
            lambda a, f: jax_bilinear_warp_rows(a, f + offset), x, flow)


class TestGatherGradient:
    """(a) The plain warps' gradients, through ``_GatherRows``, against
    ``jax.vjp`` of the JAX package's warps."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("name", ["bilinear_warp", "nearest_warp", "bilinear_warp_rows_3",
                                      "bilinear_warp_rows_-2"])
    def test_matches_jax_vjp(self, rng, name, dtype):
        port_fn, jax_fn, x, flow = _warp_case(name, rng, dtype)
        out_shape = flow.shape[:3] + x.shape[3:]
        g = _normal(rng, out_shape)
        a = torch.from_numpy(x).to(dtype).requires_grad_()
        f = torch.from_numpy(flow).requires_grad_()
        gt = torch.from_numpy(g).to(dtype)
        out = port_fn(a, f)
        assert out.dtype == dtype and "_GatherRowsBackward" in _grad_fn_names(out)
        got_x, got_f = torch.autograd.grad(out, (a, f), gt, allow_unused=True)
        # JAX in float32 on the same (rounded) inputs
        _, vjp = jax.vjp(jax_fn, jnp.asarray(a.detach().float().numpy()), jnp.asarray(flow))
        want_x, want_f = (np.asarray(v, np.float32) for v in vjp(jnp.asarray(gt.float().numpy())))
        assert got_x.dtype == dtype
        if dtype == torch.float32:
            np.testing.assert_allclose(got_x.numpy(), want_x, rtol=RTOL, atol=ATOL)
        else:
            err = np.abs(got_x.float().numpy() - want_x).max()
            assert err <= np.abs(want_x).max() / 128.0, err
        if name == "nearest_warp":  # the flow reaches the frame through integer casts only
            assert got_f is None and not want_f.any()
        elif dtype == torch.float32:
            np.testing.assert_allclose(got_f.numpy(), want_f, rtol=RTOL, atol=ATOL_FLOW)

    def test_float32_backward_is_torch_gather_bitwise(self, rng):
        """On a CPU tensor the float32 backward is the arithmetic of
        ``torch.gather``'s own (``scatter_add_`` in order)."""
        x = torch.from_numpy(_normal(rng, (2, 30, 4))).requires_grad_()
        idx = torch.from_numpy(rng.integers(0, 30, (2, 50)))
        g = torch.from_numpy(_normal(rng, (2, 50, 4)))
        ours = torch.autograd.grad(_GatherRows.apply(x, idx), x, g)[0]
        theirs = torch.autograd.grad(torch.gather(x, 1, idx[..., None].expand(2, 50, 4)), x, g)[0]
        assert torch.equal(ours, theirs)


class TestSortedRowsBackward:
    """(b) The CUDA formulation (``index_put_`` with ``accumulate=True`` on
    the flattened batch), run on CPU tensors, against ``scatter_add_``:
    within 1e-6 of the result's scale in float32."""

    @pytest.mark.parametrize("b,rows,m,c,case", [
        (2, 30, 50, 4, "random"), (3, 7, 200, 16, "random"), (1, 64, 64, 1, "permutation"),
        (2, 5, 40, 8, "one row"), (4, 12, 0, 3, "empty"),
    ])
    def test_matches_scatter_add(self, rng, b, rows, m, c, case):
        if case == "permutation":
            idx = np.stack([rng.permutation(rows)[:m] for _ in range(b)])
        elif case == "one row":  # every term onto one source: the clamped border
            idx = np.full((b, m), rows - 1)
        else:
            idx = rng.integers(0, rows, (b, m))
        idx = torch.from_numpy(idx.astype(np.int64))
        g = torch.from_numpy(_normal(rng, (b, m, c), 3.0))
        want = _rows_bwd_scatter(g, idx, rows)
        got = _rows_bwd_sorted(g, idx, rows)
        assert got.shape == want.shape == (b, rows, c) and got.dtype == torch.float32
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= 1e-6 * scale

    def test_bfloat16_cotangent_sums_in_float32(self, rng):
        """A bf16 cotangent is summed in float32: 300 terms of 1 + 2**-8
        onto one row keep their 2**-8s, which a bf16 sum would drop."""
        g = torch.full((1, 300, 2), 1 + 2**-7, dtype=torch.bfloat16)
        idx = torch.zeros((1, 300), dtype=torch.int64)
        for fn in (_rows_bwd_scatter, _rows_bwd_sorted):
            out = fn(g, idx, 3)
            assert out.dtype == torch.float32 and out[0, 0, 0].item() == pytest.approx(300 * (1 + 2**-7))


# ---------------------------------------------------------------- (c)
def _legacy_trained(model):
    """The legacy PWCNet as ``make_loss_fn`` calls a model: ``train=True``
    (BatchNorm on the batch's statistics), (final flow, per-level flows)."""

    class Trained(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = model

        def forward(self, images_0, images_1):
            final, flows, _ = self.net(images_0, images_1, train=True)
            return final, flows

    return Trained()


def _models():
    key = PRNGKey(0)
    return {
        "plain": lambda: PWCDCNet(**TINY, key=key),
        "kernels": lambda: PWCDCNet(**TINY, key=key, **kernel_hooks(True)),
        "unfused": lambda: PWCDCNet(**TINY, key=key, **kernel_hooks(True, fused=False)),
        "nearest": lambda: PWCDCNet(**TINY, key=key, warp_type="nearest"),
        "remat": lambda: PWCDCNet(**TINY, key=key, remat=True),
        "legacy": lambda: _legacy_trained(PWCNet(**TINY, batch_norm=True, key=key)),
    }


def _batch(seed, b=2, hw=HW):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 2, hw, hw, 3)).astype(np.float32)
    flows = (rng.standard_normal((b, hw, hw, 2)) * 2).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(flows)


class TestTrainingGraphs:
    """(c) No backward node of a training loss's graph is one that PyTorch
    documents as nondeterministic on a CUDA tensor. The plain warp's
    gather is ``_GatherRowsBackward``; the resizes of the flows are
    integer factors (``narrow`` / ``cat`` / ``stack``), so no
    ``IndexSelectBackward0`` comes from ``resize_bilinear``."""

    @pytest.mark.parametrize("name", NONDETERMINISTIC)
    def test_the_list_is_the_docstring_s(self, name):
        """Each entry stands in the installed PyTorch's docstring, and its
        node name is the one PyTorch gives that op."""
        assert NONDETERMINISTIC[name] in " ".join(torch.use_deterministic_algorithms.__doc__.split())
        x = torch.rand(4, 4, requires_grad=True)
        assert name in _grad_fn_names(_MAKERS[name](x))

    def test_repeat_interleave_is_an_index_select(self):
        x = torch.rand(4, 4, requires_grad=True)
        assert "repeat_interleave` when attempting to differentiate a CUDA" in " ".join(
            torch.use_deterministic_algorithms.__doc__.split())
        assert "IndexSelectBackward0" in _grad_fn_names(x.repeat_interleave(torch.tensor([1, 2, 1, 0]), 0))

    @pytest.mark.parametrize("name", ["plain", "kernels", "unfused", "nearest", "remat", "legacy"])
    def test_loss_graph_holds_no_nondeterministic_node(self, name):
        model = _models()[name]()
        images, flows = _batch(1)
        total, _ = make_loss_fn(model, decoupled_wd=True)(images, flows)
        names = _grad_fn_names(total)
        assert not names & set(NONDETERMINISTIC), sorted(names & set(NONDETERMINISTIC))
        assert "_GatherRowsBackward" in names  # on the CPU K1's wrapper runs the plain warp too
        assert "ConvolutionBackward0" in names

    def test_the_walk_sees_what_it_forbids(self, rng):
        """The walk finds ``torch.gather``'s node and a non-integer
        ``resize_bilinear``'s ``IndexSelectBackward0`` (its only
        ``index_select`` under autograd); an integer factor has none."""
        x = torch.from_numpy(_normal(rng, (1, 5, 7, 2))).requires_grad_()
        assert "IndexSelectBackward0" in _grad_fn_names(resize_bilinear(x, (9, 11)))
        for size in ((10, 14), (20, 28)):
            names = _grad_fn_names(resize_bilinear(x, size))
            assert not names & set(NONDETERMINISTIC), names
        assert "GatherBackward0" in _grad_fn_names(torch.gather(x, 1, torch.zeros((1, 1, 7, 2), dtype=torch.long)))

    @pytest.mark.parametrize("frame_rows,n,level_rows,sharded", [
        (32, 2, 16, True), (32, 2, 8, True), (48, 4, 12, True), (36, 3, 9, True),
        (32, 2, 16, False), (48, 4, 12, False), (40, 2, 5, False), (36, 3, 7, False),
    ])
    def test_sharded_loss_rows_are_a_slice(self, rng, frame_rows, n, level_rows, sharded):
        """``scored_rows`` takes the rows each shard scores by ``narrow``:
        the rows ``index_select`` took, under a ``SliceBackward0``, and
        every level row scored by exactly one shard."""
        hp = level_rows // n if sharded else level_rows
        pred = torch.from_numpy(_normal(rng, (2, hp, 3, 2)))
        counted = np.zeros(level_rows, int)
        for index in range(n):
            stripe = (index * (frame_rows // n), (index + 1) * (frame_rows // n))
            gt = torch.from_numpy(_normal(rng, (2, frame_rows // n, 6, 2)))
            p = pred.clone().requires_grad_()
            g_down, p_rows = scored_rows(gt, p, frame_rows, index, n, sharded)
            p0 = index * hp if sharded else 0
            src = nearest_indices(frame_rows, level_rows)[p0:p0 + hp]
            keep = np.flatnonzero((src >= stripe[0]) & (src < stripe[1]))
            assert torch.equal(p_rows, pred[:, torch.from_numpy(keep)])
            assert g_down.shape == (2, keep.size, 3, 2)
            names = _grad_fn_names(p_rows)
            assert "SliceBackward0" in names and not names & set(NONDETERMINISTIC)
            counted[p0 + keep] += 1
        assert (counted == 1).all()


# ---------------------------------------------------------------- (d)
@pytest.fixture
def cudnn_flags():
    """The four cuDNN flags, given back as they were."""
    b = torch.backends.cudnn
    saved = (b.deterministic, b.enabled, b.benchmark, b.allow_tf32)
    yield b
    b.deterministic, b.enabled, b.benchmark, b.allow_tf32 = saved


class TestStepFlag:
    """(d) ``make_train_step`` runs the forward and the backward with
    ``cudnn.deterministic`` and gives the caller's value back, also when
    the loss raises; ``enabled``, ``benchmark`` and ``allow_tf32`` stay as
    the caller set them."""

    @pytest.mark.parametrize("caller", [False, True])
    @pytest.mark.parametrize("others", [(True, False, True), (False, True, False)])
    def test_deterministic_inside_the_step_only(self, cudnn_flags, caller, others):
        model = _models()["plain"]()
        state = create_train_state(model, device="cpu")
        seen = {"forward": [], "backward": []}

        def forward_hook(module, inputs, output):
            seen["forward"].append(torch.backends.cudnn.deterministic)
            output.register_hook(lambda g: seen["backward"].append(torch.backends.cudnn.deterministic))

        model.optflow_0.register_forward_hook(lambda m, i, o: forward_hook(m, i, o[0]))
        cudnn_flags.deterministic = caller
        cudnn_flags.enabled, cudnn_flags.benchmark, cudnn_flags.allow_tf32 = others
        images, flows = _batch(2)
        make_train_step(model)(state, images, flows)
        assert seen == {"forward": [True], "backward": [True]}
        assert state.step == 1
        flags = (cudnn_flags.deterministic, cudnn_flags.enabled, cudnn_flags.benchmark, cudnn_flags.allow_tf32)
        assert flags == (caller, *others)

    @pytest.mark.parametrize("caller", [False, True])
    def test_restored_when_the_loss_raises(self, cudnn_flags, caller):
        model = _models()["plain"]()
        state = create_train_state(model, device="cpu")

        def fail(module, inputs, output):
            assert torch.backends.cudnn.deterministic
            raise RuntimeError("the loss fails")

        model.optflow_0.register_forward_hook(fail)
        cudnn_flags.deterministic = caller
        images, flows = _batch(3)
        with pytest.raises(RuntimeError, match="the loss fails"):
            make_train_step(model)(state, images, flows)
        assert cudnn_flags.deterministic is caller and state.step == 0

    @pytest.mark.parametrize("name", ["plain", "nearest", "legacy"])
    def test_two_steps_from_one_state_are_bitwise(self, name):
        """On the CPU every op runs in order: two steps from one state and
        batch give the same parameters and first moments, through the
        plain gather's backward."""
        images, flows = _batch(4)
        outs = []
        for _ in range(2):
            model = _models()[name]()
            state = create_train_state(model, device="cpu")
            state, _ = make_train_step(model)(state, images, flows)
            outs.append({**dict(model.named_parameters()), **{f"mu {k}": v for k, v in state.mu.items()},
                         **{f"buffer {k}": v for k, v in model.named_buffers()}})
        assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
