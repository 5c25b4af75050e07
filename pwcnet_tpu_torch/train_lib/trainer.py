"""High-level Trainer driving the full training loop (counterpart of
``pwcnet_tpu/train_lib/trainer.py``).

- datasets and loaders from ``pwcnet_tpu_torch.data`` (threaded decode, the
  next batches copied to the GPU on a side stream while a step runs);
- the eager train step of ``train_lib/step.py`` on one device, or across a
  (data, spatial) mesh of processes, one per GPU (``--spatial``,
  ``--coordinator``, or ``torchrun``'s environment): each data index loads
  its slice of every batch (``process_index`` = data index,
  ``process_count`` = data size), the ranks of one spatial row load the
  same batch and take their rows, and every rank runs as many batches as
  the data index with the fewest; only rank 0 writes logs, checkpoints and
  the cursor sidecar and prints;
- per-epoch validation, flow-pyramid visualization and full-state
  checkpoints that either package resumes from: msgpack files, or orbax
  directories with ``--ckpt_backend orbax`` (through ``tensorstore``;
  epoch saves are written on a background thread while the next epoch
  trains, flushed at the end of ``train()`` and before a preemption save);
- metrics to ``logs/history_<ts>/{train,val}`` as JSONL (+ TensorBoard when
  available), config snapshot and artifact collection via ExperimentSaver;
- a SIGTERM/SIGINT handler that saves the state with its loader cursor, so
  ``--resume`` continues sample-exactly.

``args.pallas`` keeps its name and chooses the hand-written CUDA kernels
(K2 at level 0, K1 above, K3/K6 on the two finest pyramid levels, K7 on the
``args.fused_estimator`` finest estimator levels) against the plain path.

``args.remat`` recomputes the pyramid, every estimator and the context
net in the backward (``PWCDCNet(remat=True)``), under every mesh.

Under a mesh the flow visualization is off, as the JAX trainer's is in
more than one process (a mesh here always is).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import time

import numpy as np
import torch

from pwcnet_tpu_torch.data import DataLoader, device_prefetch, get_dataset
from pwcnet_tpu_torch.inference import FUSED_PYRAMID_LEVELS, resolve_device, spatial_hooks
from pwcnet_tpu_torch.models.pwcnet import PWCDCNet
from pwcnet_tpu_torch.parallel.mesh import mesh_from_args
from pwcnet_tpu_torch.prng import PRNGKey
from pwcnet_tpu_torch.orbax_format import require_tensorstore
from pwcnet_tpu_torch.train_lib.checkpoint import (
    restore_checkpoint_auto, save_checkpoint, save_checkpoint_orbax, wait_for_orbax_saves)
from pwcnet_tpu_torch.train_lib.metrics import MetricsLogger
from pwcnet_tpu_torch.train_lib.step import create_train_state, make_eval_step, make_train_step
from pwcnet_tpu_torch.utils.config import ExperimentSaver, timestamp
from pwcnet_tpu_torch.utils.flow_viz import vis_flow_pyramid

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, args, device=None, mesh=None):
        """``device``: a torch device, else ``args.device``; None is CUDA,
        which must exist (``'cpu'`` runs the plain path on the CPU), and
        ``cuda:LOCAL_RANK`` under a mesh. ``mesh``: a ``parallel.Mesh``,
        else the one the arguments ask for (``mesh_from_args``)."""
        self.orbax = getattr(args, "ckpt_backend", "msgpack") == "orbax"
        if self.orbax:
            require_tensorstore()  # refused by name before anything is written
        self.args = args
        if device is None:
            device = getattr(args, "device", None)
        self.mesh = mesh if mesh is not None else mesh_from_args(args, device)
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        if getattr(args, "pallas", None) is None:  # auto: the kernels on CUDA
            args.pallas = self.device.type == "cuda"
        # rank 0 writes every artifact
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.epoch_stats: list[dict] = []
        self._build_dataloader()
        self._build_model()
        self._build_logging()

    # ------------------------------------------------------------------
    def _build_dataloader(self):
        args = self.args
        dset = get_dataset(args.dataset)
        seed = int(getattr(args, "seed", 0) or 0)
        data_args = dict(
            dataset_dir=args.dataset_dir,
            origin_size=None,
            crop_type=args.crop_type,
            crop_shape=args.crop_shape,
            resize_shape=args.resize_shape,
            resize_scale=args.resize_scale,
            random_flip=getattr(args, "random_flip", False),
            seed=seed,
        )
        tset = dset(train_or_val="train", **data_args)
        vset = dset(train_or_val="val", **data_args)
        self.image_size = tset.image_size
        data = self.mesh.data if self.mesh is not None else 1
        loader_args = dict(
            batch_size=args.batch_size,
            num_workers=args.num_workers,
            drop_last=True,
            process_index=self.mesh.data_index if self.mesh is not None else 0,
            process_count=data,
            seed=seed,
        )
        self.tloader = DataLoader(tset, shuffle=True, **loader_args)
        self.vloader = DataLoader(vset, shuffle=False, **loader_args)
        # every rank runs as many batches as the data index with the fewest
        # samples: a rank that ran one more step would wait forever in its
        # collectives
        self.num_batches = (len(tset) // data) // args.batch_size
        self.num_val_batches = (len(vset) // data) // args.batch_size
        self._print(f"Found {len(tset.samples)} samples -> {self.num_batches} mini-batches/process")
        self._print(f"Loader path: train {self.tloader.path}, val {self.vloader.path}")

    def _build_model(self):
        args = self.args
        use_kernels = bool(getattr(args, "pallas", False))
        hooks = {}
        use_fused = getattr(args, "fused", True) and args.warp_type == "bilinear"
        if self.mesh is not None and self.mesh.spatial > 1:
            # K3 per shard, K8, K9 (or the guard's warp); no K7 under H-sharding, as in the JAX package
            hooks = spatial_hooks(self.mesh, use_kernels, use_fused)
        elif use_kernels:
            from pwcnet_tpu_torch.ops.cuda.cost_volume import cost_volume_cuda
            from pwcnet_tpu_torch.ops.cuda.warped_cv import warped_cost_volume

            hooks = dict(
                cost_volume_fn=cost_volume_cuda,
                # warp + correlation in one kernel forward, K4 and K5 backward
                warp_cv_fn=warped_cost_volume if use_fused else None,
                fused_pyramid_levels=FUSED_PYRAMID_LEVELS,
                # opt-in, off by default as in the JAX package
                fused_estimator_levels=int(getattr(args, "fused_estimator", 0) or 0),
            )
        bf16 = getattr(args, "dtype", "float32") == "bfloat16"
        seed = int(getattr(args, "seed", 0) or 0)
        self.model = PWCDCNet(
            num_levels=args.num_levels,
            search_range=args.search_range,
            warp_type=args.warp_type,
            use_dc=args.use_dc,
            output_level=args.output_level,
            init=False,
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            remat=bool(getattr(args, "remat", False)),
            **hooks,
        )
        # the JAX trainer's init, PRNGKey(--seed); a resume loads every
        # parameter, so it draws none
        self.state = create_train_state(
            self.model,
            PRNGKey(seed) if args.resume is None else None,
            learning_rate=args.lr,
            lr_scheduling=args.lr_scheduling,
            device=self.device,
        )
        if self.mesh is not None:
            from pwcnet_tpu_torch.parallel import replicate

            replicate(self.model, self.mesh)
        self._resume_epoch = 0
        self._resume_batch = 0
        if args.resume is not None:
            print(f"Loading learned model from checkpoint {args.resume}")
            self.state = restore_checkpoint_auto(args.resume, self.state)
            cursor = self._read_cursor(args.resume)
            if cursor is not None:
                self._resume_epoch = int(cursor.get("epoch", 0))
                self._resume_batch = int(cursor.get("batch", 0))
                print(
                    "sample-exact resume: continuing epoch "
                    f"{self._resume_epoch + 1} at batch {self._resume_batch}"
                )
        loss_kwargs = dict(
            loss_name=args.loss,
            weights=tuple(args.weights),
            gamma=args.gamma,
            epsilon=args.epsilon,
            q=args.q,
        )
        self.train_step = make_train_step(self.model, mesh=self.mesh, **loss_kwargs)
        self.eval_step = make_eval_step(self.model, mesh=self.mesh, **loss_kwargs)

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg)

    def _build_logging(self):
        logdir = "logs/history_" + timestamp()
        self.logdir = logdir
        if not self.is_main:
            self.tlogger = self.vlogger = self.exp_saver = None
            return
        self.tlogger = MetricsLogger(logdir + "/train")
        self.vlogger = MetricsLogger(logdir + "/val")
        self.exp_saver = ExperimentSaver(logdir=logdir, parse_args=self.args)
        print(f"Setup completed, histories are logged in {logdir}")

    def _batches(self, loader, count: int):
        """``count`` batches of ``loader`` on the device, each cut to this
        rank's rows under H-sharding."""
        from pwcnet_tpu_torch.parallel import shard_batch

        batches = device_prefetch(itertools.islice(iter(loader), count), device=self.device)
        for images, flows in batches:
            if self.mesh is not None:
                images = shard_batch(images, self.mesh, 2, split_batch=False)
                flows = shard_batch(flows, self.mesh, 1, split_batch=False)
            yield images, flows

    # ------------------------------------------------------------------
    def _install_preemption_handler(self):
        """Save a resumable full-state checkpoint on SIGTERM/SIGINT: the
        current state goes to ./model/model_preempt.msgpack before the loop
        exits, and --resume restores it mid-epoch (with the LR step)."""
        import signal

        self._preempted = False

        def _handler(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _handler)
            except ValueError:  # not the main thread
                break

    @staticmethod
    def _cursor_path(ckpt_path: str) -> str:
        """Sidecar path of a checkpoint's loader cursor: X.msgpack ->
        X.cursor.json; an orbax directory X -> sibling X.cursor.json."""
        p = str(ckpt_path)
        if p.endswith(".msgpack"):
            p = p[: -len(".msgpack")]
        return p + ".cursor.json"

    def _read_cursor(self, ckpt_path):
        path = self._cursor_path(ckpt_path)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        # No sidecar (epoch checkpoints carry none): the epoch is in the
        # filename. model_N holds the state AFTER epoch N, so resume
        # continues at epoch N, batch 0; otherwise a resumed run would
        # replay the (seed, epoch)-deterministic shuffle orders from epoch 0.
        m = re.fullmatch(r"model_(\d+)(?:\.msgpack)?", os.path.basename(str(ckpt_path).rstrip("/")))
        if m:
            return {"epoch": int(m.group(1)), "batch": 0}
        return None

    def _save_state(self, stem: str, wait: bool = True, cursor: dict | None = None):
        """Save the TrainState under ./model/<stem>.msgpack, or as the orbax
        directory ./model/<stem>.

        ``wait=False`` (orbax): the write overlaps the next epoch's steps;
        a save that writes a cursor is always synchronous, so a cursor never
        refers to a state that has not landed.

        ``cursor``: the loader position {"epoch", "batch"} to persist as a
        sidecar json, written AFTER the (atomic) state write. A stale
        sidecar at the same path is removed first, so every crash window
        degrades to a cursor-less state: resume then replays the epoch from
        the top (samples may be counted twice, never skipped). Writing the
        cursor first would pair a new cursor with a stale state on a crash
        between the two."""
        if not self.is_main:
            return None
        os.makedirs("./model", exist_ok=True)
        path = f"./model/{stem}" if self.orbax else f"./model/{stem}.msgpack"
        cpath = self._cursor_path(path)
        if os.path.exists(cpath):
            os.remove(cpath)
        if self.orbax:
            out = save_checkpoint_orbax(path, self.state, wait=wait or cursor is not None)
        else:
            out = save_checkpoint(path, self.state)
        if cursor is not None:
            with open(cpath, "w") as f:
                json.dump(cursor, f)
        return out

    def _handle_preemption(self, epoch: int, batch: int) -> bool:
        preempted = getattr(self, "_preempted", False)
        if self.mesh is not None:
            # the ranks stop together, at the same batch
            from pwcnet_tpu_torch.parallel import global_sum

            preempted = bool(global_sum(torch.tensor(float(preempted), device=self.device)).item() > 0)
        if not preempted:
            return False
        path = self._save_state("model_preempt", cursor={"epoch": epoch, "batch": batch})
        self._print(
            f"\npreempted: state saved to {path} (step {int(self.state.step)}, "
            f"epoch {epoch} batch {batch}); --resume continues sample-exactly"
        )
        return True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _visualize(self, val_batch, epoch: int) -> None:
        os.makedirs("./figure", exist_ok=True)
        images, flows_gt = val_batch
        with torch.no_grad():
            _, pyramid = self.model(images[:, 0], images[:, 1])
        levels = self.args.num_levels
        flow_set = [
            f[0].float().cpu().numpy() * (20.0 / 2 ** (levels - l)) for l, f in enumerate(pyramid)
        ]
        vis_flow_pyramid(
            flow_set,
            flows_gt[0].float().cpu().numpy(),
            images[0].float().cpu().numpy(),
            f"./figure/flow_{str(epoch + 1).zfill(4)}.pdf",
        )

    def train(self):
        args = self.args
        log_interval = getattr(args, "log_interval", 1000)
        self._install_preemption_handler()
        from tqdm import tqdm

        for epoch in range(self._resume_epoch, args.num_epochs):
            # -- training ------------------------------------------------
            # Metrics are only fetched at log_interval: reading them every
            # batch would synchronise with the device every step.
            # Sample-exact resume: pin the loader to this epoch's
            # deterministic order; on the resumed epoch skip the batches the
            # preempted run already trained on.
            self.tloader.epoch = epoch
            skip = self._resume_batch if epoch == self._resume_epoch else 0
            self.tloader.start_batch = skip
            batch_idx = skip
            last_metrics = None
            pbar = tqdm(
                total=self.num_batches,
                initial=skip,
                desc=f"epoch {epoch + 1}/{args.num_epochs}",
                unit="batch",
                leave=False,
                disable=None if self.is_main else True,  # off where the output is no terminal
                dynamic_ncols=True,
            )
            self._sync()
            t0 = time.perf_counter()
            for images, flows_gt in self._batches(self.tloader, self.num_batches - skip):
                self.state, metrics = self.train_step(self.state, images, flows_gt)
                last_metrics = metrics
                batch_idx += 1
                if self._handle_preemption(epoch, batch_idx):
                    pbar.close()
                    return self.state
                g_step = int(self.state.step)
                if g_step % log_interval == 0 and self.is_main:
                    self.tlogger.log(
                        g_step, {"loss/pwc": metrics["loss"], "EPE/source": metrics["epe"]}
                    )
                    pbar.set_postfix(
                        loss=f"{float(metrics['loss']):.4f}",
                        epe=f"{float(metrics['epe']):.4f}",
                        refresh=False,
                    )
                pbar.update(1)
            pbar.close()
            self._sync()
            seconds = time.perf_counter() - t0
            steps = batch_idx - skip
            self.epoch_stats.append({"epoch": epoch + 1, "steps": steps, "train_seconds": seconds})
            g_step = int(self.state.step)

            # -- validation ----------------------------------------------
            # prefetched like training; the per-batch float() fetches are
            # the synchronisation points
            val_losses, val_epes = [], []
            val_batch = None
            for images, flows_gt in self._batches(self.vloader, self.num_val_batches):
                metrics = self.eval_step(self.state, images, flows_gt)
                val_losses.append(float(metrics["loss"]))
                val_epes.append(float(metrics["epe"]))
                val_batch = (images, flows_gt)
            if val_losses and self.is_main:
                self.vlogger.log(
                    g_step,
                    {"loss/pwc": float(np.mean(val_losses)), "EPE/source": float(np.mean(val_epes))},
                )

            # -- visualization --------------------------------------------
            if args.visualize and val_batch is not None and self.mesh is None:
                self._visualize(val_batch, epoch)

            # -- checkpoint ------------------------------------------------
            # orbax: asynchronous, the write overlaps the next epoch's steps
            self._save_state(f"model_{epoch + 1}", wait=False)
            data = self.mesh.data if self.mesh is not None else 1
            pairs = steps * args.batch_size * data / seconds if seconds > 0 and steps else 0.0
            where = self.device if self.mesh is None else f"{self.mesh.data}x{self.mesh.spatial} ranks"
            self._print(
                f"epoch {epoch + 1}/{args.num_epochs} step {g_step} "
                + (
                    f"loss {float(last_metrics['loss']):.4f} epe {float(last_metrics['epe']):.4f} "
                    if last_metrics is not None
                    else ""
                )
                + f"({steps} steps in {seconds:.2f} s, {pairs:.1f} pairs/s on {where})"
            )

        wait_for_orbax_saves()  # flush the last epoch's save
        if self.is_main:
            self.tlogger.close()
            self.vlogger.close()
        if self.exp_saver is not None:
            self.exp_saver.append(["./figure", "./model"])
            self.exp_saver.save()
        return self.state
