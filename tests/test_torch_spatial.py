"""H-sharding and data parallelism in pwcnet_tpu_torch against the JAX package.

The port's sharded paths run in gloo process groups on the CPU: 2 or 4
ranks, each a ``tests/_torch_spatial_worker.py`` process, started per test
with its own timeout (a hang fails one test). The JAX side runs the JAX
package's ``shard_map`` functions on the 8-device virtual CPU mesh that
``tests/conftest.py`` sets up. Inputs and parameters come from numpy seeds
and reach both sides as the same arrays.

Tolerances (float32 throughout).

- K8's and K9's plain per-shard functions against the JAX interpret-mode
  kernels: summation order only, rtol 1e-5 / atol 1e-5 (O(1) values).
- The spatial functions and the model: the ranks sum convolutions and
  correlations over stripes and halos, the gradients over the ranks;
  values within rtol 1e-5 / atol 1e-5 of the flow (O(0.1)) and feature
  scale, each parameter gradient within 2e-4 of its largest entry through
  the 3-level model, as ``tests/test_torch_train.py`` holds the unsharded
  port to JAX.
- Train steps: the first step's gradient as above, the metrics of each
  step within rtol 1e-4 and the parameters after N steps on average within
  1e-3 * N * lr, as ``tests/test_torch_train.py``; see
  ``TestShardedTrainSteps`` for the bound per entry.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.ops.pallas.cost_volume import cost_volume_pallas_hpad
from pwcnet_tpu.ops.pallas.pyramid_conv import _xla_level
from pwcnet_tpu.ops.pallas.warped_cv import warped_cost_volume_global as jax_wcv_global
from pwcnet_tpu.parallel import batch_sharding
from pwcnet_tpu.parallel import make_mesh as jax_make_mesh
from pwcnet_tpu.parallel import make_spatial_cost_volume as jax_spatial_cv
from pwcnet_tpu.parallel import make_spatial_guard as jax_spatial_guard
from pwcnet_tpu.parallel import make_spatial_pyramid_level as jax_spatial_level
from pwcnet_tpu.parallel import make_spatial_warped_cv as jax_spatial_wcv
from pwcnet_tpu.train_lib import step as jax_step
from pwcnet_tpu.train_lib.schedule import make_lr as jax_make_lr
from pwcnet_tpu_torch.models import PWCDCNet
from pwcnet_tpu_torch.ops.cost_volume import cost_volume_hpad, cost_volume_hpad_bwd_plain
from pwcnet_tpu_torch.ops.cuda.warped_cv import (
    warped_cost_volume_global_bwd_plain,
    warped_cost_volume_global_plain,
    warped_cost_volume_global_residual,
)
from pwcnet_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_spatial_worker.py")
TINY = dict(num_levels=3, output_level=1, search_range=2)
RANK_TIMEOUT = 120  # seconds for one multi-process launch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task, world, tmp_path, inputs, cfg):
    """Run ``task`` in ``world`` gloo ranks; return each rank's outputs."""
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    port = _free_port()
    env = dict(os.environ, PWC_RANK_TIMEOUT=str(RANK_TIMEOUT - 10))
    procs = [
        subprocess.Popen([sys.executable, WORKER, task, str(r), str(world), str(port), str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [i for i, p in enumerate(procs) if p.returncode]
    assert not failed, "\n".join(f"--- rank {i}\n{logs[i][-4000:]}" for i in failed)
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(world)]


def _rows(outs, key):
    return np.concatenate([o[key] for o in outs], axis=1)


def _jax_tree(cfg, hw, seed):
    """A parameter tree shaped by the JAX model's init, filled from numpy
    (fan-in scaled kernels, small biases)."""
    model = JaxPWCDCNet(**cfg)
    x = jnp.zeros((1, hw[0], hw[1], 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:
            return (rng.standard_normal(s.shape) / np.sqrt(9.0 * s.shape[2])).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _state_inputs(tree):
    return {f"sd/{k}": v.numpy() for k, v in from_jax_params(tree).items()}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(outs, prefix):
    grads = {k[len(prefix):]: torch.from_numpy(v) for k, v in outs[0].items() if k.startswith(prefix)}
    return _flat(to_jax_params(grads))


def _assert_tree_close(got, want, rel):
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert np.abs(got[key] - w).max() <= rel * np.abs(w).max() + 1e-7, key


def _jax_mesh(data, spatial):
    return jax_make_mesh(jax.devices()[: data * spatial], data=data, spatial=spatial)


def _shard_rows(x, mesh, axis):
    spec = [None] * x.ndim
    spec[axis] = "spatial"
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))


def _jax_spatial_model(mesh, cfg):
    return JaxPWCDCNet(
        **cfg,
        cost_volume_fn=jax_spatial_cv(mesh, use_pallas=False),
        warp_cv_fn=jax_spatial_wcv(mesh, use_pallas=False),
        spatial_guard_fn=jax_spatial_guard(mesh),
    )


class TestShardKernelsPlain:
    """The plain per-shard K8 and K9 against the JAX kernels (interpret
    mode), forward and VJP: df1_ext's halo rows, dflow_ext, the top, middle
    and bottom shard's valid rows, flows across shards and out of the frame."""

    @pytest.mark.parametrize("d,h", [(2, 6), (4, 3)])
    def test_cost_volume_hpad(self, d, h):
        rng = np.random.default_rng(d)
        f0 = rng.standard_normal((2, h, 9, 5)).astype(np.float32)
        f1e = rng.standard_normal((2, h + 2 * d, 9, 5)).astype(np.float32)
        g = rng.standard_normal((2, h, 9, (2 * d + 1) ** 2)).astype(np.float32)
        want, vjp = jax.vjp(lambda a, b: cost_volume_pallas_hpad(a, b, d, None, True), jnp.asarray(f0), jnp.asarray(f1e))
        want_df0, want_df1 = vjp(jnp.asarray(g))
        out = cost_volume_hpad(torch.from_numpy(f0), torch.from_numpy(f1e), d)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        df0, df1 = cost_volume_hpad_bwd_plain(torch.from_numpy(f0), torch.from_numpy(f1e), out, torch.from_numpy(g), d)
        assert df1.shape == f1e.shape
        np.testing.assert_allclose(df0.numpy(), np.asarray(want_df0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(df1.numpy(), np.asarray(want_df1), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shard,d,fscale", [(0, 2, 3.0), (1, 3, 12.0), (2, 2, 12.0)])
    def test_warped_cost_volume_global(self, shard, d, fscale):
        rng = np.random.default_rng(10 * shard + d)
        b, h, w, c = 2, 6, 9, 5
        off = shard * h
        f0 = rng.standard_normal((b, h, w, c)).astype(np.float32)
        full = rng.standard_normal((b, 3 * h, w, c)).astype(np.float32)
        flow = (rng.standard_normal((b, h + 2 * d, w, 2)) * fscale).astype(np.float32)
        flow[:, ::3, ::2] *= 4.0  # reaches the other shards and out of the frame
        flow[..., 1] += off
        vb = (-off, 3 * h - 1 - off)
        g = rng.standard_normal((b, h, w, (2 * d + 1) ** 2)).astype(np.float32)
        want, vjp = jax.vjp(
            lambda a, f1, fl: jax_wcv_global(a, f1, fl, jnp.asarray(vb, jnp.float32), d, True),
            jnp.asarray(f0), jnp.asarray(full), jnp.asarray(flow))
        t = [torch.from_numpy(a) for a in (f0, full, flow)]
        out, we = warped_cost_volume_global_residual(*t, vb, d)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        got = warped_cost_volume_global_bwd_plain(*t, vb, out, we, torch.from_numpy(g), d)
        leaves = [a.clone().requires_grad_() for a in t]
        auto = torch.autograd.grad(warped_cost_volume_global_plain(*leaves, vb, d), leaves, torch.from_numpy(g))
        for name, a, e, w_ in zip(("df0", "df1", "dflow_ext"), got, auto, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(a.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(e.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5, err_msg=name)


class TestSpatialOps:
    """The port's spatial cost volume (K8), warped cost volume (K9) and
    pyramid level (K3 on halo stripes with the edge fix-up; the halo conv
    chain below 12 rows a shard) over gloo ranks, against the JAX package's
    ``make_spatial_*`` on the CPU mesh: values and gradients. The JAX cost
    volumes run their XLA formulation inside the same ``shard_map`` (the
    kernels themselves are held above); the pyramid level runs its kernel
    in interpret mode. 8 rows over 4 shards at d=4 takes the gathered-halo
    path (2 rows a shard). The JAX side checks one pyramid level per case:
    24 rows a shard (K3 on stripes), then 8 (the halo conv chain)."""

    @pytest.mark.parametrize("world,h,d,level", [(2, 16, 2, "level"), (4, 8, 4, "level_small")])
    def test_matches_jax(self, tmp_path, world, h, d, level):
        rng = np.random.default_rng(world + h + d)
        b, w, c = 2, 9, 5
        inp = dict(
            f0=rng.standard_normal((b, h, w, c)).astype(np.float32),
            f1=rng.standard_normal((b, h, w, c)).astype(np.float32),
            flow=(rng.standard_normal((b, h, w, 2)) * 4).astype(np.float32),
            g_cv=rng.standard_normal((b, h, w, (2 * d + 1) ** 2)).astype(np.float32),
        )
        params = []
        for ci, co in ((3, 8), (8, 8), (8, 8)):
            params += [(rng.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32),
                       (rng.standard_normal(co) * 0.1).astype(np.float32)]
        for i, p in enumerate(params):
            inp[f"p{i}"] = p.transpose(3, 2, 0, 1).copy() if p.ndim == 4 else p
        for name, rows in (("level", 24), ("level_small", 8)):
            inp[f"x_{name}"] = rng.standard_normal((b, rows * world, 10, 3)).astype(np.float32)
            inp[f"g_{name}"] = rng.standard_normal((b, rows * world // 2, 5, 8)).astype(np.float32)
        outs = run_ranks("ops", world, tmp_path, inp, {"d": d})

        mesh = _jax_mesh(1, world)
        cv_fn = jax_spatial_cv(mesh, use_pallas=False)
        wcv_fn = jax_spatial_wcv(mesh, use_pallas=False)
        f0, f1, flow = (_shard_rows(inp[k], mesh, 1) for k in ("f0", "f1", "flow"))
        g = jnp.asarray(inp["g_cv"])
        for key, fn, args in (("cv", lambda *a: cv_fn(*a, d), (f0, f1)),
                              ("wcv", lambda *a: wcv_fn(*a, d), (f0, f1, flow))):
            want, vjp = jax.vjp(jax.jit(fn), *args)
            np.testing.assert_allclose(_rows(outs, key), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=key)
            names = ("df0", "df1", "dflow")[: len(args)]
            for name, wg in zip(names, vjp(g)):
                np.testing.assert_allclose(_rows(outs, f"{key}_{name}"), np.asarray(wg), rtol=1e-5, atol=1e-5,
                                           err_msg=f"{key} {name}")

        plevel = jax_spatial_level(mesh, interpret=True)
        jparams = [jnp.asarray(p) for p in params]
        for name in (level,):
            x = _shard_rows(inp[f"x_{name}"], mesh, 1)
            want, vjp = jax.vjp(jax.jit(plevel), x, *jparams)
            np.testing.assert_allclose(_rows(outs, name), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(np.asarray(want), np.asarray(_xla_level(jnp.asarray(inp[f"x_{name}"]), *jparams)),
                                       rtol=1e-5, atol=1e-5)
            grads = vjp(jnp.asarray(inp[f"g_{name}"]))
            np.testing.assert_allclose(_rows(outs, f"{name}_dx"), np.asarray(grads[0]), rtol=1e-5, atol=1e-5)
            for i, wg in enumerate(grads[1:]):
                wg = np.asarray(wg)
                got = outs[0][f"{name}_dp{i}"]
                got = got.transpose(2, 3, 1, 0) if got.ndim == 4 else got
                assert np.abs(got - wg).max() <= 2e-4 * np.abs(wg).max(), f"{name} dp{i}"


class TestSpatialModel:
    """The H-sharded PWCDCNet (K3, K8 and K9 paths with the CPU plain
    versions, halo convs, split and gathered levels) over gloo ranks
    against the JAX sharded model on the CPU mesh and the port's unsharded
    model: the final flow and every pyramid level, the last rows of the
    last shard on their own (the TF1 resize clamps there, where the halo
    exchange brings zeros), and the parameter gradient of sum(flow * g)
    (3-level configs; the 6-level 64x64 gate holds the forward)."""

    @pytest.mark.parametrize("world,cfg,hw,rel", [
        (2, TINY, (64, 32), 2e-4),
        (4, TINY, (128, 32), 2e-4),
        (2, {}, (64, 64), None),  # the 6-level gate: the forward
    ])
    def test_matches_jax_sharded_and_unsharded(self, tmp_path, world, cfg, hw, rel):
        rng = np.random.default_rng(world)
        tree = _jax_tree(cfg, hw, seed=world + hw[0])
        images = rng.random((2, 2) + hw + (3,)).astype(np.float32)
        g = rng.standard_normal((2,) + hw + (2,)).astype(np.float32)
        inp = dict(images=images, g_final=g, **_state_inputs(tree))
        outs = run_ranks("model", world, tmp_path, inp, {"model": cfg, "fused_pyramid_levels": 2})
        assert outs[0]["sharded"][-1]  # the output level is sharded: the final resize runs on stripes

        mesh = _jax_mesh(1, world)
        model = _jax_spatial_model(mesh, cfg)
        i0, i1 = (_shard_rows(images[:, k], mesh, 1) for k in (0, 1))
        fwd = jax.jit(lambda p, a, b: model.apply({"params": p}, a, b))
        want, want_pyr = fwd(tree, i0, i1)
        port = PWCDCNet(**cfg)
        port.load_state_dict(from_jax_params(tree))
        with torch.no_grad():
            plain, _ = port(torch.from_numpy(images[:, 0]), torch.from_numpy(images[:, 1]))
        for o in outs:
            np.testing.assert_allclose(o["flows_final"], np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(outs[0]["flows_final"], plain.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(outs[-1]["last_rows"], np.asarray(want)[:, -3:], rtol=1e-5, atol=1e-5)
        for l, wp in enumerate(want_pyr):
            np.testing.assert_allclose(outs[0][f"pyramid_{l}"], np.asarray(wp), rtol=1e-5, atol=1e-5)

        if rel is None:
            return
        loss = lambda p, a, b: jnp.sum(model.apply({"params": p}, a, b)[0] * jnp.asarray(g))
        want_grads = _flat(jax.jit(jax.grad(loss))(tree, i0, i1))
        _assert_tree_close(_port_flat(outs, "grad/"), want_grads, rel)


class TestSpatialServing:
    @pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
    def test_predictor_matches_unsharded(self, tmp_path, data, spatial):
        """``FlowPredictor`` on a (data, spatial) mesh: every rank gets the
        whole flow of the whole batch, equal to the unsharded predictor's."""
        from pwcnet_tpu_torch.inference import FlowPredictor

        rng = np.random.default_rng(5)
        tree = _jax_tree(TINY, (64, 32), seed=3)
        frames = rng.integers(0, 255, (4, 2, 64, 32, 3), dtype=np.uint8)
        pair = rng.integers(0, 255, (2, 70, 40, 3), dtype=np.uint8)
        inp = dict(frames=frames, pair=pair, **_state_inputs(tree))
        outs = run_ranks("predictor", data * spatial, tmp_path, inp,
                         {"model": TINY, "data": data, "spatial": spatial})
        ref = FlowPredictor(**TINY, device="cpu")
        ref.model.load_state_dict(from_jax_params(tree))
        want, want_pyr = ref.raw_forward(frames)
        want_call = ref(pair[0], pair[1])[0]
        for o in outs:
            np.testing.assert_allclose(o["flow"], want.numpy(), rtol=1e-5, atol=1e-5)
            for l, wp in enumerate(want_pyr):
                np.testing.assert_allclose(o[f"pyramid_{l}"], wp.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(o["call_flow"], want_call, rtol=1e-5, atol=1e-4)


TRAIN_N, TRAIN_LR, TRAIN_HW = 3, 1e-3, (64, 32)
TRAIN_LOSSES = ("multiscale", "robust")


@pytest.fixture(scope="module")
def train_reference():
    """The inputs of the train-step tests and the JAX package's unsharded
    steps on them: the gradient of the first step, the metrics of every
    step and the parameters after the last, per loss."""
    rng = np.random.default_rng(21)
    tree = _jax_tree(TINY, TRAIN_HW, seed=11)
    images = rng.random((4, 2) + TRAIN_HW + (3,)).astype(np.float32)
    flows = (rng.standard_normal((4,) + TRAIN_HW + (2,)) * 2).astype(np.float32)
    mesh = _jax_mesh(1, 1)
    model = JaxPWCDCNet(**TINY)
    img, flo = jnp.asarray(images), jnp.asarray(flows)
    ref = {}
    for loss in TRAIN_LOSSES:
        loss_fn = jax_step.make_loss_fn(model, loss_name=loss)
        grads = _flat(jax.jit(jax.grad(lambda p: loss_fn(p, img, flo)[0]))(tree))
        tx = optax.adam(jax_make_lr(TRAIN_LR, False), b1=0.9, b2=0.999, eps=1e-8)
        state = jax_step.TrainState.create(apply_fn=model.apply, params=tree, tx=tx)
        step = jax_step.make_train_step(model, donate=False, mesh=mesh, loss_name=loss)
        metrics = []
        for _ in range(TRAIN_N):
            state, m = step(state, img, flo)
            metrics.append({k: float(v) for k, v in m.items()})
        ref[loss] = (grads, metrics, _flat(state.params))
    return dict(images=images, flows=flows, tree=tree, ref=ref)


class TestShardedTrainSteps:
    """Three train steps of ``make_train_step(model, mesh=...)`` on a
    (data, spatial) mesh of gloo ranks, from shared parameters, with the
    multiscale and the robust loss (whose per-level L1 is reduced in the
    forward before the power is taken), against the JAX package's
    ``make_train_step(model, mesh=...)`` over the same global batch.

    The first step's gradient, summed over the ranks, is held as the whole
    model's gradient is held unsharded (2e-4 of each tensor's largest
    entry), and the metrics of each step within rtol 1e-4. After the three
    steps the parameters agree on average within 1e-3 * N * lr and, at all
    but one entry in 10^4, within N * lr / 10: Adam divides by sqrt(nu), so
    an entry whose gradient is within the gradient tolerance of zero (a few
    of the 5e5) steps by up to lr either way; its sign is not determined at
    float32.

    The reference is the JAX step without H-sharding: at 64x32 over two
    shards the JAX package's own H-sharded step gives the context net's
    first conv a bias gradient 0.16% off its unsharded one, while the
    port's sharded and unsharded gradients and a float64 run agree with
    the unsharded one. At this size one preactivation within float32
    rounding of zero, whose LeakyReLU slope the rounding decides, moves that
    conv's gradient by that much (``ROADMAP.md`` Queue 3). The sharded
    forward and gradient are held against the JAX sharded model in
    ``TestSpatialModel``."""

    @pytest.mark.parametrize("data,spatial,remat", [(2, 1, False), (1, 2, False), (2, 2, False), (1, 2, True)],
                             ids=["2-1", "1-2", "2-2", "1-2-remat"])
    def test_matches_jax(self, tmp_path, train_reference, data, spatial, remat):
        """``remat``: the pyramid, estimators and context net recomputed in
        the backward, their halo exchanges, gathers and K8 / K9's plain
        versions with them; held to the same reference and bounds."""
        r = train_reference
        inputs = dict(images=r["images"], flows=r["flows"], **_state_inputs(r["tree"]))
        outs = run_ranks("train", data * spatial, tmp_path, inputs,
                         {"model": dict(TINY, remat=remat), "data": data, "spatial": spatial, "lr": TRAIN_LR,
                          "steps": TRAIN_N, "losses": TRAIN_LOSSES, "fused_pyramid_levels": 2})
        for loss in TRAIN_LOSSES:
            want_grads, want_metrics, want = r["ref"][loss]
            _assert_tree_close(_port_flat(outs, f"{loss}/grad/"), want_grads, 2e-4)
            for i, m in enumerate(want_metrics):
                for k, v in m.items():
                    np.testing.assert_allclose(outs[0][f"{loss}/step{i}/{k}"], v, rtol=1e-4,
                                               err_msg=f"{loss} step {i} {k}")
            for o in outs:
                assert o[f"{loss}/checksum_spread"] == 0.0  # every rank took the same update
            got = _port_flat(outs, f"{loss}/param/")
            diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
            assert diffs.mean() <= 1e-3 * TRAIN_N * TRAIN_LR, loss
            assert (diffs > TRAIN_N * TRAIN_LR / 10).mean() <= 1e-4, loss


class TestShardedTrainer:
    """``pwcnet_tpu_torch.train.main --spatial 2 --device cpu`` in two ranks
    joined by ``--coordinator``: one epoch, then one more resumed from the
    first epoch's checkpoint, each against the same run in one process (the
    loss of every step within rtol 1e-4, as the unsharded trainer is held
    to the JAX loop), with only rank 0 writing."""

    ARGS = ["-d", "Synthetic", "-dd", ".", "-b", "4", "--crop_type", "center", "--crop_shape", "32", "32",
            "--no-visualize", "--log_interval", "1", "--lr", "1e-3", "--weights", "0.32", "0.08", "--seed", "4",
            "--device", "cpu", "-nw", "1", "--num_levels", "3", "--search_range", "2", "--output_level", "1"]

    @staticmethod
    def _losses(logdir):
        rows = [json.loads(line) for line in (logdir / "train" / "metrics.jsonl").read_text().splitlines()]
        return [r["step"] for r in rows], [r["loss/pwc"] for r in rows]

    def _sharded(self, tmp_path, name, argv):
        work = tmp_path / name
        for r in range(2):
            (work / f"rank{r}").mkdir(parents=True)
        io = tmp_path / f"{name}_io"
        io.mkdir()
        outs = run_ranks("trainer", 2, io, {"unused": np.zeros(1)},
                         {"workdir": str(work), "argv": self.ARGS + ["--spatial", "2"] + argv})
        assert [bool(o["is_main"]) for o in outs] == [True, False]
        assert outs[0]["checksum"] == outs[1]["checksum"]  # one set of parameters
        assert not any((work / "rank1").iterdir())  # rank 1 wrote nothing
        return outs, work / "rank0"

    def _single(self, tmp_path, monkeypatch, name, argv):
        from pwcnet_tpu_torch import train as train_cli

        run = tmp_path / name
        run.mkdir()
        monkeypatch.chdir(run)
        return train_cli.main(self.ARGS + argv), run

    def test_epoch_and_resume_match_one_process(self, tmp_path, monkeypatch):
        from pwcnet_tpu_torch.weights import load_tree

        monkeypatch.delenv("WORLD_SIZE", raising=False)
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the JSONL is what is read
        outs, rank0 = self._sharded(tmp_path, "sharded", ["-e", "1"])
        single, run = self._single(tmp_path, monkeypatch, "single", ["-e", "1"])
        (logdir,) = (rank0 / "logs").glob("history_*")
        steps, losses = self._losses(logdir)
        want_steps, want = self._losses(run / single.logdir)
        assert steps == want_steps == list(range(1, 9)) and int(outs[0]["steps"]) == 8
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        ckpt = logdir / "model" / "model_1.msgpack"
        got = _flat(load_tree(ckpt)["params"])
        ref = _flat(load_tree(run / single.logdir / "model" / "model_1.msgpack")["params"])
        diffs = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
        assert diffs.mean() <= 1e-3 * 8 * 1e-3

        outs, rank0 = self._sharded(tmp_path, "resumed", ["-e", "2", "-r", str(ckpt)])
        single, run = self._single(tmp_path, monkeypatch, "single_resumed", ["-e", "2", "-r", str(ckpt)])
        (logdir,) = (rank0 / "logs").glob("history_*")
        steps, losses = self._losses(logdir)
        want_steps, want = self._losses(run / single.logdir)
        assert steps == want_steps == list(range(9, 17)) and int(outs[0]["steps"]) == 16
        np.testing.assert_allclose(losses, want, rtol=1e-4)


class TestShardedCLIs:
    """``evaluate --spatial 2`` and ``test --spatial 2`` in two ranks that
    find each other through torchrun's environment (``env://``), against
    the same command in one process: the EPE within rtol 1e-5, the flow
    rank 0 writes within 1e-5 of its scale (float32, the sharded model as
    in ``TestSpatialModel``); rank 1 prints and writes nothing."""

    MODEL = ["--num_levels", "3", "--search_range", "2", "--output_level", "1", "--device", "cpu"]

    def _sharded(self, tmp_path, cli, argv):
        work = tmp_path / cli
        for r in range(2):
            (work / f"rank{r}").mkdir(parents=True)
        io = tmp_path / f"{cli}_io"
        io.mkdir()
        outs = run_ranks("cli", 2, io, {"unused": np.zeros(1)},
                         {"workdir": str(work), "cli": cli, "argv": argv + ["--spatial", "2"]})
        assert not any((work / "rank1").iterdir())
        return outs, work / "rank0"

    def test_evaluate_and_test_match_one_process(self, tmp_path, monkeypatch):
        from PIL import Image

        from pwcnet_tpu_torch import evaluate as evaluate_cli, test as test_cli
        from pwcnet_tpu_torch.utils import load_flow

        monkeypatch.delenv("WORLD_SIZE", raising=False)
        argv = ["-d", "Synthetic", "-dd", ".", "-b", "4"] + self.MODEL
        outs, _ = self._sharded(tmp_path, "evaluate", argv)
        want = evaluate_cli.main(argv)
        for o in outs:
            np.testing.assert_allclose(float(o["result"]), want, rtol=1e-5)

        rng = np.random.default_rng(8)
        frames = [tmp_path / f"frame_{i}.png" for i in range(2)]
        for f in frames:
            Image.fromarray(rng.integers(0, 255, (64, 48, 3), dtype=np.uint8)).save(f)
        argv = ["--input_images", *map(str, frames), "--save_flow", "flow.flo"] + self.MODEL
        _, rank0 = self._sharded(tmp_path, "test", argv)
        monkeypatch.chdir(tmp_path)
        test_cli.main(argv)
        want = load_flow(tmp_path / "flow.flo")
        np.testing.assert_allclose(load_flow(rank0 / "flow.flo"), want, atol=1e-5 * np.abs(want).max())
