"""One rank of a gloo run of pwcnet_tpu_torch's sharded paths on the CPU.

    python tests/_torch_spatial_worker.py TASK RANK WORLD PORT DIR

reads ``DIR/inputs.npz`` (and ``DIR/config.json``), joins a gloo group at
``tcp://127.0.0.1:PORT`` and writes ``DIR/out_RANK.npz``. Started by
``tests/test_torch_spatial.py`` (``run_ranks``), one process per rank. It
imports no JAX: the tests compute the JAX side themselves.

Tasks:

- ``ops``: the spatial cost volume (K8's path), warped cost volume (K9's)
  and pyramid level on this rank's rows, values and input gradients;
- ``model``: the sharded PWCDCNet forward, gathered, and the parameter
  gradient of ``sum(flows_final * g)`` summed over the ranks;
- ``predictor``: ``FlowPredictor(spatial=..., data=...)`` on a frame batch
  and on one frame pair, with the model options of ``cfg["model"]``;
- ``sequence``: ``FlowPredictor.predict_sequence`` on a mesh, every pair;
- ``warp``: ``SpatialGuard.warp`` (nearest and bilinear) on this rank's
  rows, values and the bilinear warp's input gradients;
- ``train``: train steps on a (data, spatial) mesh from shared parameters;
- ``trainer``: ``pwcnet_tpu_torch.train.main`` with ``--spatial``, joined
  by ``--coordinator``;
- ``cli``: ``pwcnet_tpu_torch.evaluate.main`` or ``.test.main`` with
  ``--spatial`` in the environment torchrun gives a rank (``env://``).
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pwcnet_tpu_torch.parallel import (  # noqa: E402
    global_sum,
    make_mesh,
    make_spatial_cost_volume,
    make_spatial_guard,
    make_spatial_pyramid_level,
    make_spatial_warped_cv,
    shard_batch,
)
from pwcnet_tpu_torch.parallel._comm import all_gather_rows  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def task_ops(mesh, inp, cfg, out):
    d = cfg["d"]

    def local(name, grad=True):
        t = shard_batch(_t(inp[name]), mesh, 1, split_batch=False).clone()
        return t.requires_grad_(grad)

    f0, f1, flow = local("f0"), local("f1"), local("flow")
    g_cv = shard_batch(_t(inp["g_cv"]), mesh, 1, split_batch=False)
    cv = make_spatial_cost_volume(mesh)(f0, f1, d)
    out["cv"] = cv.detach().numpy()
    out["cv_df0"], out["cv_df1"] = (t.numpy() for t in torch.autograd.grad(cv, [f0, f1], g_cv))
    wcv = make_spatial_warped_cv(mesh)(f0, f1, flow, d)
    out["wcv"] = wcv.detach().numpy()
    grads = torch.autograd.grad(wcv, [f0, f1, flow], g_cv)
    out["wcv_df0"], out["wcv_df1"], out["wcv_dflow"] = (t.numpy() for t in grads)
    params = [_t(inp[f"p{i}"]).requires_grad_() for i in range(6)]
    plevel = make_spatial_pyramid_level(mesh)
    for name in ("level", "level_small"):  # K3 on stripes; the halo conv chain
        x = local(f"x_{name}")
        y = plevel(x, *params)
        g_y = shard_batch(_t(inp[f"g_{name}"]), mesh, 1, split_batch=False)
        out[name] = y.detach().numpy()
        grads = torch.autograd.grad(y, [x, *params], g_y)
        out[f"{name}_dx"] = grads[0].numpy()
        for i, g in enumerate(grads[1:]):
            out[f"{name}_dp{i}"] = global_sum(g).numpy()


def _model(cfg, mesh, state_dict, use_kernels=True):
    """The model as the trainer wires it (``kernel_hooks``), fused unless
    ``cfg["use_fused"]`` is False or the warp is nearest."""
    from pwcnet_tpu_torch.models.pwcnet import PWCDCNet, kernel_hooks

    fused = cfg.get("use_fused", True) and cfg["model"].get("warp_type", "bilinear") == "bilinear"
    model = PWCDCNet(**cfg["model"], **kernel_hooks(use_kernels, fused=fused, mesh=mesh))
    model.load_state_dict(state_dict)
    return model


def _state_dict(inp):
    return {k[len("sd/"):]: _t(inp[k]) for k in inp.files if k.startswith("sd/")}


def task_model(mesh, inp, cfg, out):
    model = _model(cfg, mesh, _state_dict(inp)).to(mesh.device)
    images = shard_batch(_t(inp["images"]).to(mesh.device), mesh, 2, split_batch=False)
    flows_final, pyramid = model(images[:, 0], images[:, 1])
    sharded = model.sharded_levels(inp["images"].shape[2])
    full = all_gather_rows(flows_final, mesh.rows, 1) if sharded[-1] else flows_final
    out["flows_final"] = full.detach().cpu().numpy()
    out["last_rows"] = flows_final[:, -3:].detach().cpu().numpy()  # this shard's own last rows
    for l, (f, sh) in enumerate(zip(pyramid, sharded)):
        out[f"pyramid_{l}"] = (all_gather_rows(f, mesh.rows, 1) if sh else f).detach().cpu().numpy()
    out["sharded"] = np.array(sharded)
    g = shard_batch(_t(inp["g_final"]).to(mesh.device), mesh, 1, split_batch=False)
    if not sharded[-1]:  # a replicated output: each rank scores its stripe
        rows = torch.arange(mesh.spatial_index * g.shape[1], (mesh.spatial_index + 1) * g.shape[1], device=g.device)
        g = torch.zeros_like(flows_final).index_copy_(1, rows, g)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad((flows_final * g).sum(), list(named.values()))
    for k, gr in zip(named, grads):
        out[f"grad/{k}"] = global_sum(gr).cpu().numpy()
    from pwcnet_tpu_torch.ops.cuda import launch_counts

    out["launches"] = np.array(json.dumps(launch_counts()))


def task_predictor(mesh, inp, cfg, out):
    from pwcnet_tpu_torch.inference import FlowPredictor

    pred = FlowPredictor(**cfg["model"], mesh=mesh, device="cpu")
    pred.model.load_state_dict(_state_dict(inp))
    flow, pyramid = pred.raw_forward(inp["frames"])
    out["flow"] = flow.numpy()
    for l, f in enumerate(pyramid):
        out[f"pyramid_{l}"] = f.numpy()
    a, b = inp["pair"]
    out["call_flow"] = pred(a, b)[0]
    out["fused"] = np.bool_(pred.model.warp_cv_fn is not None)
    crop = pred.crop_factor
    out["sharded"] = np.array(pred.model.sharded_levels(inp["frames"].shape[2]))
    out["sharded_call"] = np.array(pred.model.sharded_levels(a.shape[0] // crop * crop))


def task_sequence(mesh, inp, cfg, out):
    from pwcnet_tpu_torch.inference import FlowPredictor

    pred = FlowPredictor(**cfg["model"], mesh=mesh, device="cpu")
    pred.model.load_state_dict(_state_dict(inp))
    n = 0
    for i, res in enumerate(pred.predict_sequence(list(inp["frames"]), **cfg["sequence"])):
        n += 1
        if cfg["sequence"]["fetch"] == "flow":
            out[f"flow_{i}"] = res
            continue
        out[f"flow_{i}"], pyramid, out[f"images_{i}"] = res
        for l, f in enumerate(pyramid):
            out[f"pyramid_{i}_{l}"] = f
    out["pairs"] = np.int64(n)
    out["fused"] = np.bool_(pred.model.warp_cv_fn is not None)


def task_warp(mesh, inp, cfg, out):
    guard = make_spatial_guard(mesh, use_kernels=False)
    f1 = shard_batch(_t(inp["f1"]), mesh, 1, split_batch=False).clone().requires_grad_()
    flow = shard_batch(_t(inp["flow"]), mesh, 1, split_batch=False).clone().requires_grad_()
    out["nearest"] = guard.warp(f1, flow, "nearest").detach().numpy()
    warped = guard.warp(f1, flow, "bilinear")
    out["bilinear"] = warped.detach().numpy()
    g = shard_batch(_t(inp["g"]), mesh, 1, split_batch=False)
    out["df1"], out["dflow"] = (t.numpy() for t in torch.autograd.grad(warped, [f1, flow], g))


def task_train(mesh, inp, cfg, out):
    from pwcnet_tpu_torch.train_lib import create_train_state, make_loss_fn, make_train_step

    images = shard_batch(_t(inp["images"]).to(mesh.device), mesh, 2)
    flows = shard_batch(_t(inp["flows"]).to(mesh.device), mesh, 1)
    for loss in cfg["losses"]:
        model = _model(cfg, mesh, _state_dict(inp))
        out["fused"] = np.bool_(model.warp_cv_fn is not None)
        state = create_train_state(model, learning_rate=cfg["lr"], lr_scheduling=False, device=mesh.device)
        objective, _ = make_loss_fn(model, mesh=mesh, loss_name=loss, decoupled_wd=True)(images, flows)
        named = dict(model.named_parameters())
        for k, g in zip(named, torch.autograd.grad(objective, list(named.values()))):
            out[f"{loss}/grad/{k}"] = (global_sum(g) + 4e-4 * named[k].detach()).cpu().numpy()
        step = make_train_step(model, mesh=mesh, loss_name=loss)
        for i in range(cfg["steps"]):
            state, metrics = step(state, images, flows)
            for k, v in metrics.items():
                out[f"{loss}/step{i}/{k}"] = np.float32(float(v))
        params = dict(model.named_parameters())
        # Adam ran the same update on every rank: the parameters agree
        checksum = torch.stack([p.double().sum() for p in params.values()]).sum()
        out[f"{loss}/checksum_spread"] = np.float64(
            (global_sum(checksum) / (mesh.data * mesh.spatial) - checksum).abs().item())
        for k, p in params.items():
            out[f"{loss}/param/{k}"] = p.detach().cpu().numpy()


def task_trainer(mesh_args, inp, cfg, out):
    from pwcnet_tpu_torch import train as train_cli

    # the metrics' JSONL is what the test reads; TensorBoard's import alone
    # takes seconds here
    sys.modules["torch.utils.tensorboard"] = None
    rank = mesh_args["rank"]
    os.chdir(os.path.join(cfg["workdir"], f"rank{rank}"))
    argv = cfg["argv"] + ["--coordinator", f"127.0.0.1:{mesh_args['port']}", "--num_processes",
                          str(mesh_args["world"]), "--process_id", str(rank)]
    trainer = train_cli.main(argv)
    out["steps"] = np.int64(trainer.state.step)
    out["logdir"] = np.array(os.path.abspath(trainer.logdir) if trainer.is_main else "")
    out["is_main"] = np.bool_(trainer.is_main)
    out["checksum"] = np.float64(sum(p.double().sum().item() for p in trainer.model.parameters()))


def task_cli(mesh_args, inp, cfg, out):
    import importlib

    rank = mesh_args["rank"]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(mesh_args["port"]),
                      WORLD_SIZE=str(mesh_args["world"]), RANK=str(rank), LOCAL_RANK=str(rank))
    os.chdir(os.path.join(cfg["workdir"], f"rank{rank}"))
    result = importlib.import_module(f"pwcnet_tpu_torch.{cfg['cli']}").main(cfg["argv"])
    if result is not None:
        out["result"] = np.float64(result)


def main():
    # a rank that hangs in a collective dumps its stack and exits
    faulthandler.dump_traceback_later(float(os.environ.get("PWC_RANK_TIMEOUT", "100")), exit=True)
    task, rank, world, port, io_dir = sys.argv[1:6]
    rank, world, port = int(rank), int(world), int(port)
    with open(os.path.join(io_dir, "config.json")) as f:
        cfg = json.load(f)
    inp = np.load(os.path.join(io_dir, "inputs.npz"))
    out = {}
    if task in ("trainer", "cli"):
        {"trainer": task_trainer, "cli": task_cli}[task]({"rank": rank, "world": world, "port": port}, inp, cfg, out)
    else:
        # the CPU over gloo by default; "cuda:{rank}" and nccl for one GPU per rank
        device = cfg.get("device", "cpu").format(rank=rank)
        mesh = make_mesh(data=cfg.get("data", 1), spatial=cfg.get("spatial", world), device=device,
                         init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                         backend=cfg.get("backend", "gloo"))
        {"ops": task_ops, "model": task_model, "predictor": task_predictor, "sequence": task_sequence,
         "warp": task_warp, "train": task_train}[task](
            mesh, inp, cfg, out)
    np.savez(os.path.join(io_dir, f"out_{rank}.npz"), **out)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
