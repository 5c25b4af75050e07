"""The port's SyntheticFlow convergence proof against the JAX package's
(``tests/test_convergence.py``).

Both start from the JAX proof's own init: ``PWCDCNet(**CFG)``'s
``create_train_state`` under ``PRNGKey(0)``, carried into the port with
``weights.from_jax_params``. The proof holds from some inits only (from
others every case settles on a constant flow at 1.862 px, in both
packages), so a port seed would test the seed, not the port.

- Tier 1: the first five train steps on the proof's own first five
  batches, multiscale and robust loss, each step's ``loss``, ``data_loss``
  and ``epe`` within rtol 1e-4 of the JAX ``make_train_step`` (the bound
  of ``tests/test_torch_train.py::TestTrainSteps``: two frameworks sum
  the convolutions in different orders); the port's batches byte-equal to
  the JAX proof's, at the start and after the 300-step warm start; the
  full-set EPE helper against the JAX ``_full_set_epe`` on the untrained
  init within rtol 1e-5.
- ``slow``: the four cases of the JAX proof on the port's plain path on
  the CPU, each below 0.5 px: multiscale float32 (400 steps), remat (400),
  robust (150 after the 300-step warm start) and bf16 compute (120 at lr
  1e-4 from the warm start's parameters, fresh Adam moments). Run with
  ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_convergence.py -m slow``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCDCNet as JaxPWCDCNet
from pwcnet_tpu.train_lib import create_train_state as jax_create_train_state
from pwcnet_tpu.train_lib import make_train_step as jax_make_train_step
from pwcnet_tpu_torch.train_lib import convergence as conv
from pwcnet_tpu_torch.weights import from_jax_params
from test_convergence import CFG as JAX_CFG
from test_convergence import EPE_TARGET as JAX_EPE_TARGET
from test_convergence import _batches as jax_batches
from test_convergence import _dataset as jax_dataset
from test_convergence import _full_set_epe as jax_full_set_epe

torch.set_num_threads(1)

SLOW_THREADS = 4


@pytest.fixture(scope="module")
def jax_init():
    """The JAX proof's model and fresh state, and its parameters as a port
    state dict."""
    model = JaxPWCDCNet(dtype=jnp.float32, **JAX_CFG)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), (1, 32, 32, 3), learning_rate=conv.LR,
                                   lr_scheduling=False)
    params = {k: v.clone() for k, v in from_jax_params(jax.tree_util.tree_map(np.asarray, state.params)).items()}
    return model, state, params


def test_the_proof_is_the_jax_proofs():
    """The configuration, the target and the batches: the first ones, and
    those after the warm start where the fine-tunes begin (``skip``)."""
    assert conv.CFG == JAX_CFG and conv.EPE_TARGET == JAX_EPE_TARGET
    a, b = jax_dataset(), conv.dataset()
    assert a.samples == b.samples and a.image_size == b.image_size
    jgen, port = jax_batches(a), conv.batches(b)
    for _ in range(3):
        for x, y in zip(next(port), next(jgen)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for _ in range(conv.STEPS["warm"] - 3):
        next(jgen)
    for got in itertools.islice(conv.batches(b, skip=conv.STEPS["warm"]), 3):
        for x, y in zip(got, next(jgen)):
            assert np.array_equal(x, y)


def _jax_steps(model, state, loss_name, n):
    """``n`` JAX train steps on the proof's first batches: the metrics of
    each and the state after the first."""
    jstep = jax_make_train_step(model, donate=False, loss_name=loss_name)
    gen = jax_batches(jax_dataset())
    rows, first = [], None
    for _ in range(n):
        images, flows = next(gen)
        state, m = jstep(state, jnp.asarray(images, jnp.float32), jnp.asarray(flows))
        rows.append({k: float(v) for k, v in m.items()})
        first = state if first is None else first
    return rows, first


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class TestFirstSteps:
    @pytest.mark.parametrize("loss_name", ["multiscale", "robust"])
    def test_five_steps_match_jax(self, jax_init, loss_name):
        """Each step's metrics within rtol 1e-4 of the JAX step's. One
        exception, pinned by ``test_first_update_differs_only_where_the_
        gradient_is_rounding``: under the robust loss the flow head's y bias
        has an exactly zero first gradient (the L1 signs cancel), so Adam's
        first update of it is its rounding residue over itself (JAX 1.1e-8,
        the port 2.8e-9: 0.53 lr and 0.22 lr). That moves the final flow,
        not the pyramid the loss reads: the robust ``epe`` of steps 1-4 is
        held within rtol 1e-3 (read: 5.6e-4 at most), its loss terms within
        1e-4 (read: 1e-5)."""
        model, jstate, params = jax_init
        want, _ = _jax_steps(model, jstate, loss_name, 5)
        got = []
        state = conv.start_state(params, "cpu")
        conv.train(state, conv.batches(conv.dataset()), 5, loss_name,
                   on_step=lambda i, m: got.append({k: float(v) for k, v in m.items()}))
        assert state.step == 5 and len(got) == 5
        for i, (g, w) in enumerate(zip(got, want)):
            assert set(g) == {"loss", "data_loss", "epe"}
            for key in g:
                rtol = 1e-3 if (loss_name, key) == ("robust", "epe") and i > 0 else 1e-4
                np.testing.assert_allclose(g[key], w[key], rtol=rtol, err_msg=f"step {i} {key}")

    @pytest.mark.parametrize("loss_name", ["multiscale", "robust"])
    def test_first_update_differs_only_where_the_gradient_is_rounding(self, jax_init, loss_name):
        """After the first step every parameter is within lr / 10 of the JAX
        one, except entries whose gradient is at rounding level in both
        packages (at most 1e-6 of its tensor's largest entry), which Adam's
        first update normalises to a step of up to lr either way."""
        from pwcnet_tpu.train_lib import step as jax_step
        from pwcnet_tpu_torch.train_lib import make_loss_fn
        from pwcnet_tpu_torch.weights import to_jax_params

        model, jstate, params = jax_init
        _, jfirst = _jax_steps(model, jstate, loss_name, 1)
        images, flows = next(conv.batches(conv.dataset()))
        jgrad = _flat(jax.jit(jax.grad(lambda p: jax_step.make_loss_fn(model, loss_name=loss_name)(
            p, jnp.asarray(images), jnp.asarray(flows))[0]))(jstate.params))
        state = conv.start_state(params, "cpu")
        total, _ = make_loss_fn(state.model, loss_name=loss_name)(torch.from_numpy(images), torch.from_numpy(flows))
        named = dict(state.model.named_parameters())
        pgrad = _flat(to_jax_params(dict(zip(named, torch.autograd.grad(total, list(named.values()))))))
        conv.train(state, conv.batches(conv.dataset()), 1, loss_name)
        got, want = _flat(to_jax_params(state.model.state_dict())), _flat(jfirst.params)
        apart = []
        for key, w in want.items():
            for idx in zip(*np.nonzero(np.abs(got[key] - w) > conv.LR / 10)):
                apart.append(key)
                for grad in (jgrad[key], pgrad[key]):
                    assert abs(grad[idx]) <= 1e-6 * np.abs(grad).max(), (key, idx, grad[idx])
        assert apart == ([] if loss_name == "multiscale" else ["['context']['conv2d_6']['bias']"])

    def test_full_set_epe_matches_jax(self, jax_init):
        model, jstate, params = jax_init
        want = jax_full_set_epe(model, jstate, jax_dataset(), jnp.float32)
        got = conv.full_set_epe(conv.start_state(params, "cpu").model, conv.dataset())
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_constant_flow_epe_is_the_least_a_constant_reaches(self):
        """The state the non-converging inits settle on (1.8623-1.8624 px in
        the sweeps) lies within 1e-3 of the least EPE a constant flow
        reaches; no constant on a 0.01 px grid does better."""
        dset = conv.dataset()
        best = conv.constant_flow_epe(dset)
        np.testing.assert_allclose(best, 1.8618, atol=1e-4)
        flows = np.stack([dset[i][1][0, 0] for i in range(len(dset))]).astype(np.float64)
        grid = np.stack(np.meshgrid(np.arange(-2, 2, 0.01), np.arange(-2, 2, 0.01)), -1).reshape(-1, 1, 2)
        assert np.linalg.norm(flows[None] - grid, axis=-1).mean(1).min() >= best - 1e-9
        assert conv.on_constant_flow(1.8623, dset) and conv.on_constant_flow(1.8624, dset)
        assert not conv.on_constant_flow(0.3821, dset) and not conv.on_constant_flow(2.0202, dset)

    def test_run_cases_wiring(self, jax_init, monkeypatch):
        """The four cases' plumbing at two steps each, wired as on the card
        (the kernels' wrappers take the CPU tensors to their plain
        versions): every case trains its steps and ends at a finite EPE,
        and the bf16 case starts from the warm start's parameters."""
        monkeypatch.setattr(conv, "STEPS", {k: 2 for k in conv.STEPS})
        seen = {}
        starts = {}

        def on_step(name, i, m):
            seen[name] = seen.get(name, 0) + 1

        real_start = conv.start_state

        def start(params, device, lr=conv.LR, **kw):
            starts.setdefault(kw.get("compute_dtype"), (lr, {k: v.clone() for k, v in params.items()}))
            return real_start(params, device, lr=lr, **kw)

        monkeypatch.setattr(conv, "start_state", start)
        res = conv.run_cases(jax_init[2], "cpu", use_kernels=True, on_step=on_step)
        assert set(res) == {*conv.CASES, "warm"}
        assert seen == {name: 2 for name in res}
        assert all(np.isfinite(r["epe"]) and r["steps"] == 2 for r in res.values())
        lr, bf16_start = starts[torch.bfloat16]
        assert lr == conv.BF16_LR
        assert any(not torch.equal(bf16_start[k], jax_init[2][k]) for k in bf16_start)


@pytest.fixture
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(SLOW_THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def finetuned(jax_init):
    before = torch.get_num_threads()
    torch.set_num_threads(SLOW_THREADS)
    try:
        return conv.run_cases(jax_init[2], "cpu", cases=("robust", "bf16"))
    finally:
        torch.set_num_threads(before)


def _report(name, r):
    print(f"\n{name}: {r['steps']} steps, full-set EPE {r['epe']:.4f} px, {r['seconds']:.1f} s "
          f"on {SLOW_THREADS} CPU threads")


class TestConvergence:
    @pytest.mark.slow
    @pytest.mark.parametrize("case", ["multiscale", "remat"])
    def test_converges_from_scratch(self, jax_init, threads, case):
        r = conv.run_cases(jax_init[2], "cpu", cases=(case,))[case]
        _report(case, r)
        assert r["epe"] < conv.EPE_TARGET, f"EPE {r['epe']:.3f} after {r['steps']} {case} steps"

    @pytest.mark.slow
    @pytest.mark.parametrize("case", ["robust", "bf16"])
    def test_finetune_converges(self, finetuned, case):
        _report("warm start", finetuned["warm"])
        r = finetuned[case]
        _report(case, r)
        assert r["epe"] < conv.EPE_TARGET, f"EPE {r['epe']:.3f} after the {case} fine-tune"


class TestRecordScript:
    """``scripts/torch_record_convergence.py``: no JAX, and its three
    modes at a few steps on the CPU."""

    def _script(self):
        import importlib.util
        from pathlib import Path

        path = Path(__file__).resolve().parents[1] / "scripts" / "torch_record_convergence.py"
        spec = importlib.util.spec_from_file_location("torch_record_convergence", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return path, mod

    def test_imports_no_jax(self):
        import ast

        path, _ = self._script()
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert roots.isdisjoint({"jax", "jaxlib", "flax", "optax", "pwcnet_tpu"}), roots
        assert "pwcnet_tpu_torch" in roots

    def test_curve_sweep_and_cases(self, tmp_path, monkeypatch, capsys):
        import json

        _, script = self._script()
        monkeypatch.setattr(script, "STEPS", 20)
        monkeypatch.setattr(script, "SWEEP_STEPS", 2)
        monkeypatch.setattr(conv, "STEPS", {k: 2 for k in conv.STEPS})
        monkeypatch.setattr(script, "REPO", tmp_path)  # the curve goes to REPO / "docs"
        (tmp_path / "docs").mkdir()
        script.main(["--device", "cpu"])
        rows = (tmp_path / "docs" / "torch_convergence_synthetic.csv").read_text().splitlines()
        assert rows[0] == "step,train_loss,train_epe_px" and [r.split(",")[0] for r in rows[1:]] == ["10", "20"]
        script.main(["--device", "cpu", "--sweep", "0", "5", "--json", str(tmp_path / "sweep.json")])
        sweep = json.loads((tmp_path / "sweep.json").read_text())
        assert [r["seed"] for r in sweep["sweep"]] == [0, 5] and sweep["steps"] == 2
        script.main(["--device", "cpu", "--seed", "5", "--cases", "--json", str(tmp_path / "cases.json")])
        cases = json.loads((tmp_path / "cases.json").read_text())["cases"]
        assert set(cases) == {*conv.CASES, "warm"} and all(np.isfinite(c["epe"]) for c in cases.values())
        out = capsys.readouterr().out
        assert "threads)" in out and "full-set EPE" in out
        with pytest.raises(SystemExit):
            script.main(["--device", "cpu", "--kernels"])
