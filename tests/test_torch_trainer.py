"""The port's Trainer and its train / evaluate CLIs against the JAX package,
on the CPU at the tiny model of tests/test_cli.py (``num_levels=3,
search_range=2, output_level=1``).

Both packages start from one checkpoint, ``model_0.msgpack``, written here
with the JAX package from a numpy-seeded parameter tree (by the filename
rule the file resumes at epoch 0, batch 0); ``tests/test_torch_init.py``
runs one epoch in each package from one ``--seed`` instead, each drawing
the same init. The JAX side is a loop of its own ``DataLoader`` and
``make_train_step``; the port side is ``pwcnet_tpu_torch.train.main``.

Tolerances, those of tests/test_torch_train.py scaled to the step count N (8
steps of one epoch): the logged loss per step within rtol 1e-4; Adam divides
each update by sqrt(nu), so an entry whose gradient is at rounding level can
step by up to lr either way: the final parameters agree within N * lr / 10
everywhere and within 1e-3 * N * lr on average. The evaluate CLIs' EPE (a
mean over every pixel of a float32 forward) within rtol 1e-4.
"""

import importlib.util
import json
import signal
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pwcnet_tpu import data as jax_data
from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.train_lib import checkpoint as jax_checkpoint
from pwcnet_tpu.train_lib import step as jax_step
from pwcnet_tpu.train_lib.schedule import make_lr as jax_make_lr
from pwcnet_tpu_torch import evaluate as port_eval_cli
from pwcnet_tpu_torch import train as port_train_cli
from pwcnet_tpu_torch.data import datasets as port_datasets
from pwcnet_tpu_torch.train_lib import latest_checkpoint, load_params, restore_checkpoint_auto, save_params
from pwcnet_tpu_torch.train_lib.trainer import Trainer
from pwcnet_tpu_torch.weights import load_tree, to_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_levels=3, output_level=1, search_range=2)
TINY_MODEL = ["--num_levels", "3", "--search_range", "2", "--output_level", "1"]
LR = 1e-3
# Synthetic: 32 samples of 64x64, centre-cropped to 32x32, batches of 4: 8 steps
TRAIN_ARGS = ["-d", "Synthetic", "-dd", ".", "-e", "1", "-b", "4", "--crop_type", "center",
              "--crop_shape", "32", "32", "--no-visualize", "--log_interval", "1", "--lr", str(LR),
              "--weights", "0.32", "0.08", "--seed", "4", "--device", "cpu"] + TINY_MODEL
N_STEPS = 8


def _jax_tree(seed):
    model = JaxPWCDCNet(**TINY)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:
            return (rng.standard_normal(s.shape) / np.sqrt(9.0 * s.shape[2])).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_epoch(model):
    """One epoch of the JAX loop from ``_jax_tree(31)``: the first state,
    the loss of every step, the final parameters and the batches."""
    tx = optax.adam(jax_make_lr(LR, True), b1=0.9, b2=0.999, eps=1e-8)
    state = first = jax_step.TrainState.create(apply_fn=model.apply, params=_jax_tree(31), tx=tx)
    dset = jax_data.SyntheticFlow(train_or_val="train", dataset_dir=".", origin_size=None, crop_type="center",
                                  crop_shape=[32, 32], resize_shape=None, resize_scale=None,
                                  random_flip=False, seed=4)
    loader = jax_data.DataLoader(dset, batch_size=4, shuffle=True, num_workers=2, drop_last=True, seed=4)
    step = jax_step.make_train_step(model, donate=False, loss_name="multiscale", weights=(0.32, 0.08),
                                    gamma=0.0004, epsilon=0.02, q=0.4)
    losses, batches = [], []
    for images, flows in loader:
        batches.append((images, flows))
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(flows))
        losses.append(float(metrics["loss"]))
    return first, losses, _flat(state.params), batches


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """model_0.msgpack and the JAX side of one epoch from it: the loss of
    every step and the final parameters. The JAX step is built once."""
    root = tmp_path_factory.mktemp("shared")
    first, losses, params, batches = _jax_epoch(JaxPWCDCNet(**TINY))
    ckpt = jax_checkpoint.save_checkpoint(root / "model_0.msgpack", first)
    return {"ckpt": ckpt, "losses": losses, "params": params, "batches": batches}


def _logdir(tmp_path):
    (found,) = (tmp_path / "logs").glob("history_*")
    return found


class TestTrainerAgainstJax:
    def test_one_epoch_from_a_shared_checkpoint(self, shared, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        trainer = port_train_cli.main(TRAIN_ARGS + ["-r", shared["ckpt"]])
        assert trainer._resume_epoch == 0 and trainer._resume_batch == 0  # the filename rule
        assert trainer.state.step == N_STEPS == len(shared["losses"])
        assert trainer.args.pallas is False and trainer.device.type == "cpu"  # auto: off on the CPU
        logdir = _logdir(tmp_path)
        rows = [json.loads(l) for l in (logdir / "train" / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in rows] == list(range(1, N_STEPS + 1))
        assert set(rows[0]) == {"step", "loss/pwc", "EPE/source"}
        np.testing.assert_allclose([r["loss/pwc"] for r in rows], shared["losses"], rtol=1e-4)
        (val,) = [json.loads(l) for l in (logdir / "val" / "metrics.jsonl").read_text().splitlines()]
        assert val["step"] == N_STEPS and np.isfinite(val["loss/pwc"])
        # artifacts, in the JAX trainer's layout
        assert (logdir / "config.json").is_file() and not (tmp_path / "model").exists()
        ckpt = logdir / "model" / "model_1.msgpack"
        assert latest_checkpoint(logdir / "model") == str(ckpt)
        tree = load_tree(ckpt)
        assert int(tree["step"]) == N_STEPS
        got = _flat(tree["params"])
        want = shared["params"]
        assert got.keys() == want.keys()
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert diffs.max() <= N_STEPS * LR / 10 and diffs.mean() <= 1e-3 * N_STEPS * LR
        # and the JAX package restores what the port wrote
        model = JaxPWCDCNet(**TINY)
        tx = optax.adam(jax_make_lr(LR, True), b1=0.9, b2=0.999, eps=1e-8)
        template = jax_step.TrainState.create(apply_fn=model.apply, params=_jax_tree(0), tx=tx)
        assert int(jax_checkpoint.restore_checkpoint(ckpt, template).step) == N_STEPS

    def test_remat_epoch_matches_the_jax_remat_loop(self, shared, tmp_path, monkeypatch):
        """--remat from the shared checkpoint: the JAX loop with
        ``PWCDCNet(remat=True)`` over the same batches, at the tolerances
        of the epoch above."""
        monkeypatch.chdir(tmp_path)
        _, want_losses, want, _ = _jax_epoch(JaxPWCDCNet(**TINY, remat=True))
        trainer = port_train_cli.main(TRAIN_ARGS + ["-r", shared["ckpt"], "--remat", "--device", "cpu"])
        assert trainer.model.remat and trainer.state.step == N_STEPS == len(want_losses)
        logdir = _logdir(tmp_path)
        rows = [json.loads(l) for l in (logdir / "train" / "metrics.jsonl").read_text().splitlines()]
        np.testing.assert_allclose([r["loss/pwc"] for r in rows], want_losses, rtol=1e-4)
        got = _flat(load_tree(logdir / "model" / "model_1.msgpack")["params"])
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert diffs.max() <= N_STEPS * LR / 10 and diffs.mean() <= 1e-3 * N_STEPS * LR

    def test_fused_estimator_and_kernel_hooks_train_alike_on_the_cpu(self, shared, tmp_path, monkeypatch):
        """--pallas --fused-estimator 2 on the CPU goes through every
        wrapper's plain version: same losses."""
        monkeypatch.chdir(tmp_path)
        trainer = port_train_cli.main(TRAIN_ARGS + ["-r", shared["ckpt"], "--pallas", "--fused-estimator", "2"])
        assert trainer.model.optflow_0.fused and trainer.model.optflow_1.fused
        assert trainer.model.warp_cv_fn is not None and trainer.model.fp_extractor.fused_levels == 2
        rows = [json.loads(l) for l in (_logdir(tmp_path) / "train" / "metrics.jsonl").read_text().splitlines()]
        np.testing.assert_allclose([r["loss/pwc"] for r in rows], shared["losses"], rtol=1e-4)


# (use_kernels, fused, fused_estimator, warp_type); fused None is each builder's default
BUILDER_FLAGS = {
    "plain": (False, None, 0, "bilinear"),
    "kernels": (True, None, 0, "bilinear"),
    "k7": (True, None, 2, "bilinear"),
    "unfused": (True, False, 0, "bilinear"),
    "nearest": (True, None, 0, "nearest"),
}
BUILDERS = [(b, f) for b in ("FlowPredictor", "Trainer", "convergence", "chip_smoke") for f in BUILDER_FLAGS
            if b != "convergence" or f in ("plain", "kernels")]  # its build_model takes use_kernels alone


def _wiring(model):
    """Which implementation of each op ``model`` runs."""
    return (model.cost_volume_fn, model.warp_cv_fn, model.spatial_guard_fn, model.fp_extractor.fused_levels,
            model.fp_extractor.level_fn, [getattr(model, f"optflow_{l}").fused for l in range(model.output_level + 1)])


def _built(builder, use_kernels, fused, fused_estimator, warp_type):
    """The model ``builder`` makes for these flags, and its configuration."""
    if builder == "FlowPredictor":
        from pwcnet_tpu_torch.inference import FlowPredictor

        pred = FlowPredictor(device="cpu", use_kernels=use_kernels, use_fused="auto" if fused is None else fused,
                             fused_estimator=fused_estimator, warp_type=warp_type, **TINY)
        return pred.model, TINY
    if builder == "Trainer":
        flags = ["--pallas" if use_kernels else "--no-pallas", "--fused-estimator", str(fused_estimator),
                 "--warp_type", warp_type] + (["--no-fused"] if fused is False else [])
        return Trainer(port_train_cli.build_parser().parse_args(TRAIN_ARGS + flags)).model, TINY
    if builder == "convergence":
        from pwcnet_tpu_torch.train_lib import convergence

        return convergence.build_model(use_kernels), convergence.CFG
    spec = importlib.util.spec_from_file_location("chip_smoke_builder", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    # as its DETERMINISM_PATHS call it: unfused with the nearest warp
    model = chip_smoke.train_model(torch, None, use_kernels, fused_estimator=fused_estimator,
                                   fused=fused if fused is not None else warp_type == "bilinear", warp_type=warp_type)
    return model, {}


@pytest.mark.parametrize("builder,flags", BUILDERS, ids=[f"{b}-{f}" for b, f in BUILDERS])
def test_every_builder_wires_as_kernel_hooks(tmp_path, monkeypatch, builder, flags):
    """FlowPredictor, the Trainer, the convergence proof and chip_smoke.py's
    train model run the kernels that ``kernel_hooks`` gives for their flags."""
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, kernel_hooks

    monkeypatch.chdir(tmp_path)
    use_kernels, fused, fused_estimator, warp_type = BUILDER_FLAGS[flags]
    model, cfg = _built(builder, use_kernels, fused, fused_estimator, warp_type)
    hooks = kernel_hooks(use_kernels, fused=fused, fused_estimator=fused_estimator, warp_type=warp_type)
    want = PWCDCNet(**cfg, warp_type=warp_type, init=False, **hooks)
    assert _wiring(model) == _wiring(want)
    assert (model.warp_cv_fn is not None) == (use_kernels and fused is None and warp_type == "bilinear")


def _trainer(extra=()):
    args = port_train_cli.build_parser().parse_args(TRAIN_ARGS + list(extra))
    args.pallas = False
    return Trainer(args)


def _record_batches(trainer, preempt_at=None):
    """Wrap the train step: keep every batch it sees; flag a preemption
    (as the signal handler would) during call ``preempt_at``."""
    seen = []
    orig = trainer.train_step

    def stepper(state, images, flows):
        seen.append((images.numpy().copy(), flows.numpy().copy()))
        if preempt_at is not None and len(seen) == preempt_at:
            trainer._preempted = True
        return orig(state, images, flows)

    trainer.train_step = stepper
    return seen


class TestPreemptionAndResume:
    def test_sigterm_checkpoint_cursor_and_sample_exact_resume(self, shared, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        whole = _trainer(["-r", shared["ckpt"]])
        all_batches = _record_batches(whole)
        whole.train()
        assert len(all_batches) == N_STEPS
        # the batches are the JAX loader's, byte for byte
        for (gi, gf), (wi, wf) in zip(all_batches, shared["batches"]):
            assert np.array_equal(gi, wi) and np.array_equal(gf, wf)

        monkeypatch.chdir(tmp_path / "logs")  # a second run directory
        cut = _trainer(["-r", shared["ckpt"]])
        first = _record_batches(cut, preempt_at=3)
        cut.train()
        assert len(first) == 3 and cut.state.step == 3
        ckpt = Path("model") / "model_preempt.msgpack"
        assert ckpt.is_file()
        assert json.loads((Path("model") / "model_preempt.cursor.json").read_text()) == {"epoch": 0, "batch": 3}

        resumed = _trainer(["-r", str(ckpt)])
        assert (resumed._resume_epoch, resumed._resume_batch, resumed.state.step) == (0, 3, 3)
        rest = _record_batches(resumed)
        resumed.train()
        assert len(rest) == N_STEPS - 3 and resumed.state.step == N_STEPS
        for (gi, gf), (wi, wf) in zip(first + rest, all_batches):
            assert np.array_equal(gi, wi) and np.array_equal(gf, wf)
        # the same samples in the same order from the same state: the same parameters
        for (name, a), (_, b) in zip(resumed.model.state_dict().items(), whole.model.state_dict().items()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-8, err_msg=name)

    def test_a_stale_cursor_is_removed_before_the_state_is_written(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        trainer = _trainer()
        trainer._save_state("model_preempt", cursor={"epoch": 1, "batch": 2})
        assert Path("model/model_preempt.cursor.json").is_file()
        trainer._save_state("model_preempt")
        assert not Path("model/model_preempt.cursor.json").exists()
        assert trainer._read_cursor("model/model_preempt.msgpack") is None
        assert trainer._read_cursor("somewhere/model_7.msgpack") == {"epoch": 7, "batch": 0}
        assert trainer._read_cursor("somewhere/final.msgpack") is None

    def test_the_handler_sets_the_flag(self, tmp_path, monkeypatch):
        if threading.current_thread() is not threading.main_thread():
            pytest.skip("signal handlers can only be installed from the main thread")
        monkeypatch.chdir(tmp_path)
        before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            trainer = _trainer()
            trainer._install_preemption_handler()
            for s in before:
                trainer._preempted = False
                signal.getsignal(s)(s, None)
                assert trainer._preempted
        finally:
            for s, h in before.items():
                signal.signal(s, h)


class TestCheckpointHelpers:
    def test_latest_checkpoint(self, tmp_path):
        assert latest_checkpoint(tmp_path / "missing") is None and latest_checkpoint(tmp_path) is None
        for name in ("model_2.msgpack", "model_10.msgpack", "model_preempt.msgpack", "other_99.msgpack"):
            (tmp_path / name).write_bytes(b"")
        assert latest_checkpoint(tmp_path) == str(tmp_path / "model_10.msgpack")
        assert latest_checkpoint(tmp_path, prefix="other_") == str(tmp_path / "other_99.msgpack")

    def test_params_only_files_round_trip_and_load_in_jax(self, tmp_path):
        from pwcnet_tpu_torch.models import PWCDCNet

        model = PWCDCNet(**TINY)
        path = save_params(tmp_path / "params.msgpack", model.state_dict())
        got = load_params(path)
        assert got.keys() == model.state_dict().keys()
        for k, v in model.state_dict().items():
            assert torch.equal(got[k], v)
        template = jax.tree_util.tree_map(np.zeros_like, to_jax_params(model.state_dict()))
        back = jax_checkpoint.load_params(path, template)
        for k, v in _flat(to_jax_params(model.state_dict())).items():
            assert np.array_equal(_flat(back)[k], v)

    def test_orbax_directories_are_refused_by_name(self, tmp_path, monkeypatch):
        """A directory is an orbax checkpoint, read through tensorstore:
        where that cannot be imported the refusal names it."""
        monkeypatch.setitem(sys.modules, "tensorstore", None)
        with pytest.raises(ModuleNotFoundError, match="tensorstore"):
            restore_checkpoint_auto(tmp_path, None)


class TestNamedErrors:
    @pytest.mark.parametrize("flags,error,match", [
        (["--spatial", "2"], ValueError, "--spatial"),
        (["--coordinator", "localhost:1234"], ValueError, "--coordinator"),
    ])
    def test_train_refuses_what_is_not_ported(self, tmp_path, monkeypatch, flags, error, match):
        """Refused by name before anything is written: a sharded or
        multi-process run that no launcher started (one process, no
        torchrun, a coordinator with no process count)."""
        monkeypatch.chdir(tmp_path)
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(error, match=match) as raised:
            port_train_cli.main(TRAIN_ARGS + flags)
        assert type(raised.value) is error
        assert not (tmp_path / "logs").exists()

    def test_evaluate_refuses_spatial(self, monkeypatch):
        """--spatial 2 in one process that no launcher started names the flag."""
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(ValueError, match="--spatial"):
            port_eval_cli.main(["-d", "Synthetic", "-dd", ".", "--spatial", "2", "--device", "cpu"])

    @pytest.mark.parametrize("cli", [port_train_cli, port_eval_cli], ids=["train", "evaluate"])
    def test_no_gpu_and_no_device_flag_raises(self, cli, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = [a for a in TRAIN_ARGS if a not in ("--device", "cpu")] if cli is port_train_cli else [
            "-d", "Synthetic", "-dd", "."] + TINY_MODEL
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)

    def test_the_flags_are_the_jax_clis_with_device_for_platform(self):
        sys.path.insert(0, str(REPO))
        try:
            import evaluate as jax_eval_cli
            import train as jax_train_cli
        finally:
            sys.path.remove(str(REPO))

        def flags(parser):
            return {s for a in parser._actions for s in a.option_strings}

        for port, ref in ((port_train_cli, jax_train_cli), (port_eval_cli, jax_eval_cli)):
            assert flags(port.build_parser()) == (flags(ref.build_parser()) - {"--platform"}) | {"--device"}


class _OddSynth:
    """27x35 frames: no multiple of 2**3, so pad and crop handling differ."""

    @staticmethod
    def of(base):
        class OddSynth(base):
            def __init__(self, **kw):
                kw.setdefault("image_shape", (27, 35))
                kw.setdefault("num_samples", 4)
                kw.setdefault("crop_type", "none")
                kw.setdefault("crop_shape", None)
                super().__init__(**kw)

        return OddSynth


class TestEvaluateAgainstJax:
    @pytest.mark.parametrize("mode", [
        ["--size_handling", "pad"],
        ["--size_handling", "crop", "--crop_type", "center", "--crop_shape", "16", "24"],
    ], ids=["pad", "crop"])
    def test_epe_on_one_checkpoint(self, shared, tmp_path, monkeypatch, capsys, mode):
        from pwcnet_tpu.data import datasets as jax_datasets

        sys.path.insert(0, str(REPO))
        try:
            import evaluate as jax_eval_cli
        finally:
            sys.path.remove(str(REPO))
        monkeypatch.setitem(jax_datasets._REGISTRY, "OddSynth", _OddSynth.of(jax_datasets.SyntheticFlow))
        monkeypatch.setitem(port_datasets._REGISTRY, "OddSynth", _OddSynth.of(port_datasets.SyntheticFlow))
        monkeypatch.chdir(tmp_path)
        argv = ["-d", "OddSynth", "-dd", ".", "--split", "val", "-b", "2", "-r", shared["ckpt"]] + TINY_MODEL + mode
        want = jax_eval_cli.main(argv + ["--no-pallas"])
        capsys.readouterr()
        got = port_eval_cli.main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
        assert ("full-frame" if mode[1] == "pad" else "center-crop [16, 24]") in out and "4 frames" in out
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-4)


class TestUtils:
    def test_flow_viz_equals_the_jax_packages(self):
        from pwcnet_tpu.utils import flow_viz as jax_viz
        from pwcnet_tpu_torch.utils import flow_viz as port_viz

        rng = np.random.default_rng(0)
        flow = (rng.standard_normal((12, 16, 2)) * 3).astype(np.float32)
        assert np.array_equal(port_viz.make_colorwheel(), jax_viz.make_colorwheel())
        assert np.array_equal(port_viz.vis_flow(flow), jax_viz.vis_flow(flow))

    def test_experiment_saver_and_progress(self, tmp_path, monkeypatch, capsys):
        import argparse

        from pwcnet_tpu_torch.utils import ExperimentSaver, save_config, show_progress

        monkeypatch.chdir(tmp_path)
        (tmp_path / "model").mkdir()
        (tmp_path / "model" / "model_1.msgpack").write_bytes(b"x")
        saver = ExperimentSaver(logdir="logs/run", parse_args=argparse.Namespace(lr=1e-4, dataset="Synthetic"))
        saver.append(["./model", "./figure"])  # a missing artifact is skipped
        saver.save()
        assert json.loads((tmp_path / "logs/run/config.json").read_text()) == {"lr": 1e-4, "dataset": "Synthetic"}
        assert (tmp_path / "logs/run/model/model_1.msgpack").is_file() and not (tmp_path / "model").exists()
        # a second run into the same log directory (a resume within the same
        # minute) merges its checkpoints into model/, not into model/model/
        (tmp_path / "model").mkdir()
        (tmp_path / "model" / "model_2.msgpack").write_bytes(b"y")
        (tmp_path / "model" / "model_1.msgpack").write_bytes(b"z")
        saver = ExperimentSaver(logdir="logs/run")
        saver.append("./model")
        saver.save()
        assert sorted(p.name for p in (tmp_path / "logs/run/model").iterdir()) == ["model_1.msgpack", "model_2.msgpack"]
        assert (tmp_path / "logs/run/model/model_1.msgpack").read_bytes() == b"z"
        assert not (tmp_path / "model").exists()
        with pytest.raises(TypeError):
            save_config([1, 2])
        show_progress(1, 5, 10, loss=0.5)
        assert "50.0% [5/10, loss: 0.5]" in capsys.readouterr().out

    def test_metrics_logger_layout(self, tmp_path):
        from pwcnet_tpu_torch.train_lib import MetricsLogger

        logger = MetricsLogger(str(tmp_path / "train"), enable_tensorboard=False)
        logger.log(3, {"loss/pwc": torch.tensor(1.5), "EPE/source": 2})
        logger.close()
        assert json.loads((tmp_path / "train" / "metrics.jsonl").read_text()) == {
            "step": 3, "loss/pwc": 1.5, "EPE/source": 2.0}
