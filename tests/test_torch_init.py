"""The port's initial parameters against the JAX package's, bit for bit, on
the CPU.

``pwcnet_tpu_torch.prng`` draws flax's init with numpy alone; here every
piece is held to the installed jax / flax: the keys, ``fold_in``, the bits,
the uniform, the glorot kernel and flax's per-parameter key; then whole
models against ``model.init(PRNGKey(s), x, x)`` (the 3-level, the 6-level,
``use_dc``, the nearest warp, the fused levels through the JAX trainer's
plain-twin init, the legacy ``PWCNet`` with its ``batch_stats``), the
predictor without a checkpoint, the Trainer's step 0, one ``train.main``
epoch in each package from one ``--seed``, and the SHA-1 that
``chip_smoke.py``'s ``[converge]`` gates its init on.

The 6-level JAX inits (three) are module-scoped; the ``use_dc`` one runs
under ``jax.jit`` (an eager init compiles every op of a new width, about
40 s), which gives the eager init's bits (``test_jit_init_is_the_eager_
init``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.train_lib import create_train_state as jax_create_train_state
from pwcnet_tpu_torch import prng
from pwcnet_tpu_torch.models import PWCDCNet, PWCNet
from pwcnet_tpu_torch.train_lib import convergence as conv
from pwcnet_tpu_torch.train_lib.step import create_train_state
from pwcnet_tpu_torch.weights import from_jax_params, from_jax_variables, init_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_levels=3, output_level=1, search_range=2)
LEGACY = dict(num_levels=4, output_level=2, search_range=2)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def _assert_same(got: dict, want: dict):
    """Two state dicts: the same names, dtypes and bits."""
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    bad = [k for k in want if got[k].dtype != torch.float32 or not torch.equal(got[k], want[k])]
    assert not bad, bad


def _frames(hw):
    return jnp.zeros((1, hw, hw, 3), jnp.float32)


# ---------------------------------------------------------------- prng
class TestPrng:
    def test_pinned_configuration(self):
        """The behaviour ``prng`` mirrors is that of these settings."""
        import flax

        assert jax.config.jax_threefry_partitionable is True
        assert jax.config.jax_enable_x64 is False
        assert flax.config.flax_fix_rng_separator is False

    @pytest.mark.parametrize("seed", [0, 1, 5, 2**31 - 1, 2**32 - 1])
    def test_prng_key(self, seed):
        got, want = prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed))
        assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)

    @pytest.mark.parametrize("data", [0, 1, 12345, 2**31, 2**32 - 1])
    def test_fold_in(self, data):
        for seed in (0, 7):
            want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data)))
            assert np.array_equal(prng.fold_in(prng.PRNGKey(seed), data), want)

    @pytest.mark.parametrize("shape", [(8,), (3, 3, 32, 64), (5, 3, 1), (70001,)])
    def test_random_bits(self, shape):
        """1-D and 4-D, an odd count, and one above 2**16."""
        got = prng.random_bits(prng.PRNGKey(3), shape)
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(3), shape))
        assert got.shape == want.shape and got.dtype == want.dtype and np.array_equal(got, want)

    def test_threefry_2x32_odd_count(self):
        """The count's halves, an odd one padded with a 0 word."""
        from jax._src.prng import threefry_2x32 as jax_threefry

        key = prng.PRNGKey(11)
        for n in (2, 7):
            count = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
            want = np.asarray(jax_threefry(jnp.asarray(key), jnp.asarray(count)))
            assert np.array_equal(prng.threefry_2x32(key, count), want)

    @pytest.mark.parametrize("minval, maxval", [(-1.0, 1.0), (0.0, 1.0), (0.3, 2.7), (-5.5, 1e-3)])
    def test_uniform(self, minval, maxval):
        """Symmetric and not: the fused multiply-add rounds as XLA's does."""
        for shape in ((3, 3, 16, 32), (70001,)):
            got = prng.uniform(prng.PRNGKey(5), shape, minval, maxval)
            want = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), shape, minval=minval, maxval=maxval))
            assert got.dtype == want.dtype == np.float32 and np.array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("shape", [(3, 3, 3, 16), (3, 3, 277, 128), (1, 1, 64, 2), (7, 5)])
    def test_glorot_uniform(self, shape):
        import flax.linen as nn

        got = prng.glorot_uniform(prng.PRNGKey(2), shape)
        want = np.asarray(nn.initializers.glorot_uniform()(jax.random.PRNGKey(2), shape))
        assert got.dtype == np.float32 and np.array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("data", [
        (), ("params",), ("fp_extractor", "conv2d", 1), ("optflow_4", "bn_2", 0), ("x", 255, 256),
        (2**40 + 7,), ("ünï",),
    ])
    def test_fold_in_static(self, data):
        """Names, the counter 0 (no bytes), one- and multi-byte ints, UTF-8."""
        from flax.core.scope import _fold_in_static

        want = np.asarray(_fold_in_static(jax.random.PRNGKey(9), data))
        assert np.array_equal(prng.fold_in_static(prng.PRNGKey(9), data), want)

    def test_imports_neither_jax_nor_flax(self):
        import ast

        tree = ast.parse((REPO / "pwcnet_tpu_torch" / "prng.py").read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert roots == {"__future__", "hashlib", "math", "typing", "numpy"}, roots


# ---------------------------------------------------------------- whole models
@pytest.fixture(scope="module")
def jax6_fused():
    """The JAX trainer's init of the 6-level model with 2 fused pyramid and
    2 fused estimator levels (its plain twin's ``model.init``), key 0."""
    model = JaxPWCDCNet(fused_pyramid_levels=2, fused_estimator_levels=2)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), (1, 64, 64, 3))
    return from_jax_params(jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def jax6_key3(jax6_fused):  # after jax6_fused: its eager ops are compiled then
    x = _frames(64)
    return from_jax_params(JaxPWCDCNet().init(jax.random.PRNGKey(3), x, x)["params"])


@pytest.fixture(scope="module")
def jax6_dc():
    x = _frames(64)
    return from_jax_params(jax.jit(JaxPWCDCNet(use_dc=True).init)(jax.random.PRNGKey(1), x, x)["params"])


class TestModels:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_three_levels(self, seed):
        x = _frames(32)
        want = from_jax_params(JaxPWCDCNet(**TINY).init(jax.random.PRNGKey(seed), x, x)["params"])
        _assert_same(PWCDCNet(**TINY, key=prng.PRNGKey(seed)).state_dict(), want)

    def test_default_key_is_zero(self):
        x = _frames(32)
        want = from_jax_params(JaxPWCDCNet(**TINY).init(jax.random.PRNGKey(0), x, x)["params"])
        _assert_same(PWCDCNet(**TINY).state_dict(), want)

    def test_nearest_warp(self):
        x = _frames(32)
        jax_model = JaxPWCDCNet(**TINY, warp_type="nearest")
        want = from_jax_params(jax_model.init(jax.random.PRNGKey(2), x, x)["params"])
        _assert_same(PWCDCNet(**TINY, warp_type="nearest", key=prng.PRNGKey(2)).state_dict(), want)

    def test_jit_init_is_the_eager_init(self):
        x = _frames(32)
        model = JaxPWCDCNet(**TINY)
        eager = model.init(jax.random.PRNGKey(4), x, x)["params"]
        jitted = jax.jit(model.init)(jax.random.PRNGKey(4), x, x)["params"]
        _assert_same(from_jax_params(jitted), from_jax_params(eager))

    def test_six_levels(self, jax6_key3):
        _assert_same(PWCDCNet(key=prng.PRNGKey(3)).state_dict(), jax6_key3)

    def test_six_levels_fused_as_the_jax_trainer_draws_them(self, jax6_fused):
        model = PWCDCNet(fused_pyramid_levels=2, fused_estimator_levels=2, init=False)
        state = create_train_state(model, prng.PRNGKey(0), device="cpu")
        _assert_same(state.model.state_dict(), jax6_fused)
        _assert_same(PWCDCNet(remat=True).state_dict(), jax6_fused)

    def test_six_levels_dense_connections(self, jax6_dc):
        _assert_same(PWCDCNet(use_dc=True, key=prng.PRNGKey(1)).state_dict(), jax6_dc)

    @pytest.mark.parametrize("context", ["final", "all"])
    @pytest.mark.parametrize("batch_norm", [False, True])
    def test_legacy(self, context, batch_norm):
        """Parameters and ``batch_stats`` (means 0, variances 1)."""
        seed = 2 if batch_norm else 0
        x = _frames(32)
        jax_model = JaxPWCNet(**LEGACY, context=context, batch_norm=batch_norm)
        variables = jax_model.init(jax.random.PRNGKey(seed), x, x)
        assert ("batch_stats" in variables) == batch_norm
        got = PWCNet(**LEGACY, context=context, batch_norm=batch_norm, key=prng.PRNGKey(seed)).state_dict()
        _assert_same(got, from_jax_variables(variables))

    def test_init_params_redraws_in_place(self):
        """``init_params`` on a model built without a draw, and on one
        drawn from another key, gives the key's parameters; the compute
        dtype stays, the parameters float32."""
        want = PWCDCNet(**TINY, key=prng.PRNGKey(6)).state_dict()
        for model in (PWCDCNet(**TINY, init=False), PWCDCNet(**TINY, key=prng.PRNGKey(1),
                                                             compute_dtype=torch.bfloat16)):
            init_params(model, prng.PRNGKey(6))
            _assert_same(model.state_dict(), want)
        assert model.context.conv2d.compute_dtype == torch.bfloat16

    def test_a_checkpoint_draws_no_init(self, tmp_path, monkeypatch):
        """A predictor with a checkpoint and a resumed Trainer load every
        parameter and draw none: the draw raises here."""
        from pwcnet_tpu_torch import train as train_cli
        from pwcnet_tpu_torch.inference import FlowPredictor
        from pwcnet_tpu_torch.train_lib import save_checkpoint, save_params
        from pwcnet_tpu_torch.train_lib.trainer import Trainer

        params = PWCDCNet(**TINY, key=prng.PRNGKey(8)).state_dict()
        ckpt = save_params(tmp_path / "params.msgpack", params)
        state = create_train_state(PWCDCNet(**TINY, key=prng.PRNGKey(8)), device="cpu")
        full = save_checkpoint(tmp_path / "model_3.msgpack", state)

        def refuse(*a, **k):
            raise AssertionError("an init was drawn")

        monkeypatch.setattr("pwcnet_tpu_torch.models.pwcnet.init_params", refuse)
        monkeypatch.setattr("pwcnet_tpu_torch.train_lib.step.init_params", refuse)
        pred = FlowPredictor(checkpoint=ckpt, device="cpu", **TINY)
        _assert_same(pred.model.state_dict(), params)
        monkeypatch.chdir(tmp_path)
        args = train_cli.build_parser().parse_args(
            ["-d", "Synthetic", "-dd", ".", "-e", "1", "-b", "4", "--crop_type", "none", "--no-visualize",
             "--device", "cpu", "-r", full, "--num_levels", "3", "--search_range", "2", "--output_level", "1"])
        _assert_same(Trainer(args).state.model.state_dict(), params)
        with pytest.raises(AssertionError, match="an init was drawn"):
            FlowPredictor(device="cpu", **TINY)


# ---------------------------------------------------------------- entry points
def test_flow_predictor_without_a_checkpoint_serves_the_jax_flow():
    """``FlowPredictor()`` with no checkpoint: the JAX predictor's weights
    bitwise and its float32 flow within ``[serve]``'s 1e-4 x max flow."""
    from pwcnet_tpu.inference import FlowPredictor as JaxFlowPredictor
    from pwcnet_tpu_torch.inference import FlowPredictor

    rng = np.random.default_rng(5)
    img0 = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
    img1 = np.roll(img0, (1, 2), (0, 1))
    jax_pred = JaxFlowPredictor(use_pallas=False, **TINY)
    want = jax_pred(img0, img1)
    pred = FlowPredictor(device="cpu", **TINY)
    _assert_same(pred.model.state_dict(), from_jax_params(jax.tree_util.tree_map(np.asarray, jax_pred._params)))
    got = pred(img0, img1)
    bound = 1e-4 * float(np.abs(want[0]).max())
    assert got[0].shape == want[0].shape and bound > 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=bound)


def _jax_train_cli():
    """The JAX package's ``train.py`` (the CLIs live at the repo root)."""
    sys.path.insert(0, str(REPO))
    import train as jax_train_cli

    return jax_train_cli


SYNTH = ["-d", "Synthetic", "-dd", ".", "-e", "1", "-b", "4", "--crop_type", "center", "--crop_shape", "32", "32",
         "--no-visualize", "--num_levels", "3", "--search_range", "2", "--output_level", "1"]


def test_trainer_step_zero_is_the_jax_trainers(tmp_path, monkeypatch):
    """``--seed 3``: the parameters bitwise the JAX Trainer's, zero Adam
    moments, step 0."""
    from pwcnet_tpu.train_lib.trainer import Trainer as JaxTrainer
    from pwcnet_tpu_torch import train as port_train_cli
    from pwcnet_tpu_torch.train_lib.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    jargs = _jax_train_cli().build_parser().parse_args(SYNTH + ["--seed", "3"])
    jargs.pallas = False
    want = JaxTrainer(jargs).state
    port = Trainer(port_train_cli.build_parser().parse_args(SYNTH + ["--seed", "3", "--device", "cpu"])).state
    _assert_same(port.model.state_dict(), from_jax_params(jax.tree_util.tree_map(np.asarray, want.params)))
    assert port.step == int(want.step) == 0
    assert not any(t.any() for t in (*port.mu.values(), *port.nu.values()))


def test_one_epoch_in_each_package_from_one_seed(tmp_path, monkeypatch):
    """``train.main`` in each package from ``--seed 4``, no checkpoint
    shared: the final parameters within ``tests/test_torch_trainer.py``'s
    bounds (N * lr / 10 at most, 1e-3 * N * lr on average)."""
    from pwcnet_tpu_torch import train as port_train_cli
    from pwcnet_tpu_torch.weights import load_tree
    from test_torch_trainer import LR, N_STEPS, TRAIN_ARGS

    jax_train_cli = _jax_train_cli()
    jax_argv = [a for a in TRAIN_ARGS if a not in ("--device", "cpu")] + ["--platform", "cpu"]
    out = {}
    for name, main, argv in (("jax", jax_train_cli.main, jax_argv), ("port", port_train_cli.main, TRAIN_ARGS)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main(argv)
        (ckpt,) = (tmp_path / name / "logs").glob("history_*/model/model_1.msgpack")
        tree = load_tree(ckpt)
        assert int(tree["step"]) == N_STEPS
        out[name] = from_jax_params(tree["params"])
    assert out["port"].keys() == out["jax"].keys()
    diffs = torch.cat([(out["port"][k] - out["jax"][k]).abs().ravel() for k in out["jax"]])
    assert diffs.max() <= N_STEPS * LR / 10 and diffs.mean() <= 1e-3 * N_STEPS * LR


def test_converge_init_sha1_is_the_jax_inits():
    """``chip_smoke.py``'s ``CONVERGE_INIT_SHA1``: the SHA-1 of the JAX
    proof's own init (``create_train_state`` under ``PRNGKey(0)``), and the
    port's ``jax_init`` draws those parameters."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    consts = {t.id: n.value.value for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and isinstance(n.value, ast.Constant)}
    model = JaxPWCDCNet(dtype=jnp.float32, **conv.CFG)
    state = jax_create_train_state(model, jax.random.PRNGKey(consts["CONVERGE_KEY"]), (1, 32, 32, 3),
                                   learning_rate=conv.LR, lr_scheduling=False)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params))
    assert conv.params_sha1(want) == consts["CONVERGE_INIT_SHA1"]
    _assert_same(conv.jax_init(consts["CONVERGE_KEY"]), want)
    # the digest reads names and bits: one flipped bit changes it
    want["context.conv2d.weight"].view(torch.int32)[0, 0, 0, 0] ^= 1
    assert conv.params_sha1(want) != consts["CONVERGE_INIT_SHA1"]

