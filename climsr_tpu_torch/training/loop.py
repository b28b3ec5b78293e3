# -*- coding: utf-8 -*-
"""The Trainer: epoch loop, validation/test with the metric suite, checkpoints.
The port of ``climsr_tpu.training.loop``.

Role parity with the reference's PL ``Trainer.fit``/``.test`` orchestration
(``climsr/cli/train.py:32-144`` + ``climsr/core/task.py``):

- num_training_steps/warmup inference from the datamodule
  (``task.py:62-92``): steps_per_epoch = len(train_loader) // accum,
- per-epoch validation computing the 16-metric suite; ``hp_metric`` =
  epoch-mean of per-step val/rmse (``task.py:388-391``),
- top-k checkpointing on hp_metric + early stopping (patience, mode=min),
- fine-tune generator-only restore, full resume,
- ``terminate_on_nan``, ``limit_*_batches``, ``fast_dev_run``, SIGTERM
  preemption (a forced checkpoint at the next step boundary),
- test after fit over per-variable test loaders (multi-loader "temp" mode).

The port runs on one device, ``device`` (``None`` means ``cuda``; without a
card that raises unless ``device="cpu"``). The loaders are the JAX Trainer's:
by default the train tiles live on the device and each step gathers,
augments and assembles its batch there (``trainer.device_augment`` with
``device_resident_data="auto"``); else raw tiles or host-augmented batches
stream through ``device_prefetch``. The models and optimizers come from the
port's builders: float32 parameters, bf16 compute under ``precision=bf16``.
On the card each ESRGAN train step runs kernels B1, B2 (3 per RRDB each) and
C (once), and each validation or test batch runs kernel A (3 per RRDB).

Not ported, and raising with their ``ROADMAP.md`` item: more than one device,
ZeRO, spatial sharding and multi-process runs (queue 1, item 8); the "jax",
"advanced" and "pytorch" profilers and ``auto_scale_batch_size`` (item 9).
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.config.instantiator import GENERATOR_KWARGS
from climsr_tpu_torch.config.schemas import (
    DiscriminatorConfig,
    GeneratorConfig,
    OptimizerConfig,
    SchedulerConfig,
    TaskConfig,
    TrainerConfig,
    TrainingConfig,
    TransformsCfg,
)
from climsr_tpu_torch.data.pipeline import (
    VALID_KEY,
    DataLoader,
    EpochIndexSampler,
    RawTileLoader,
    build_device_store,
    build_eval_device_store,
    device_prefetch,
    gather,
)
from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.models import create_discriminator, create_generator
from climsr_tpu_torch.training.checkpoint import CheckpointManager, load_checkpoint, restore_generator_params
from climsr_tpu_torch.training.optimizers import build_optimizer
from climsr_tpu_torch.training.schedules import resolve_momentum_schedule, resolve_schedule
from climsr_tpu_torch.training.tasks.gan import make_gan_step, make_gan_val_losses
from climsr_tpu_torch.training.tasks.pretrain import make_eval_step, make_pretrain_step
from climsr_tpu_torch.training.train_state import GANTrainState, TrainState
from climsr_tpu_torch.utils.logging import MetricLogger

B = consts.batch_items
T = consts.training
logger = logging.getLogger(__name__)

_MULTI_GPU = "ROADMAP.md, queue 1, item 8: multi-GPU"
_SERVICES = "ROADMAP.md, queue 1, item 9: remaining services"


def refuse_unported(trainer_cfg: TrainerConfig) -> None:
    """Raise for the JAX Trainer's options the port does not carry yet."""
    tc = trainer_cfg
    checks = [
        (tc.num_devices not in (None, 1), f"trainer.num_devices={tc.num_devices}", _MULTI_GPU),
        (bool(tc.zero_stage) or tc.shard_optimizer_state, "trainer.zero_stage / shard_optimizer_state",
         _MULTI_GPU),
        ((tc.spatial_shard_size or 0) > 1, f"trainer.spatial_shard_size={tc.spatial_shard_size}", _MULTI_GPU),
        (torch.distributed.is_available() and torch.distributed.is_initialized()
         and torch.distributed.get_world_size() > 1, "a multi-process run", _MULTI_GPU),
        (bool(tc.auto_scale_batch_size), "trainer.auto_scale_batch_size", _SERVICES),
        (tc.profiler in ("jax", "advanced", "pytorch"), f"profiler={tc.profiler}", _SERVICES),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: {item}")


class Trainer:
    def __init__(
        self,
        datamodule,
        generator_cfg: GeneratorConfig,
        task_cfg: TaskConfig,
        trainer_cfg: TrainerConfig,
        training_cfg: TrainingConfig,
        discriminator_cfg: Optional[DiscriminatorConfig] = None,
        optimizers: Optional[Dict[str, Optional[OptimizerConfig]]] = None,
        schedulers: Optional[Dict[str, Optional[SchedulerConfig]]] = None,
        workdir: Optional[str] = None,
        config_snapshot: Optional[Dict] = None,
        callbacks: Optional[List] = None,
        logger_cfg=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        refuse_unported(trainer_cfg)
        self.callbacks = callbacks or []
        self.dm = datamodule
        self.generator_cfg = generator_cfg
        self.task_cfg = task_cfg
        self.trainer_cfg = trainer_cfg
        self.training_cfg = training_cfg
        self.discriminator_cfg = discriminator_cfg
        self.optimizers_cfg = optimizers or {}
        self.schedulers_cfg = schedulers or {}
        self.config_snapshot = config_snapshot
        self.is_gan = task_cfg.name == "gan_training"
        self.generator_type = generator_cfg.name

        self.workdir = Path(workdir or trainer_cfg.default_root_dir or "outputs/run")
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.metric_logger = MetricLogger.from_config(self.workdir, logger_cfg)

        self.compute_dtype = torch.bfloat16 if trainer_cfg.precision == "bf16" else torch.float32
        # preemption safety: the handler only sets a flag; the train loop
        # saves a checkpoint at the next step boundary and exits cleanly
        self.preempted = False
        self._prev_sigterm = None
        try:
            import signal

            self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:  # not in the main thread (e.g. some test runners)
            pass
        if trainer_cfg.deterministic:
            # pl.Trainer(deterministic=True) analogue: full-precision matmuls
            # and convs, deterministic cuDNN algorithms. Process-global, as
            # in the JAX package.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False

        # ---- data loaders -------------------------------------------------
        cfg = self.dm.cfg
        self.device_augment = trainer_cfg.device_augment
        self.train_store = None
        if self.device_augment:
            t = cfg.transforms or TransformsCfg()
            self._augment_kwargs = dict(
                scale=cfg.scale_factor,
                use_elevation=cfg.use_elevation,
                use_mask=cfg.use_mask,
                v_flip=t.v_flip,
                h_flip=t.h_flip,
                random_90_rotation=t.random_90_rotation,
            )
            n_tiles = len(self.dm.train_dataset)
            hr_sz = self.dm.train_dataset.hr_size
            est_bytes = n_tiles * hr_sz * hr_sz * 4 * 3  # hr + elev + mask, f32
            use_store = trainer_cfg.device_resident_data is True or (
                trainer_cfg.device_resident_data == "auto" and est_bytes <= trainer_cfg.device_store_max_bytes
            )
            if use_store:
                logger.info("Device-resident tile store: %d tiles, ~%.2f GB", n_tiles, est_bytes / 1e9)
                self.train_store = build_device_store(self.dm.train_dataset, num_workers=cfg.num_workers,
                                                      device=self.device)
                self.train_loader = EpochIndexSampler(n_tiles, cfg.batch_size, shuffle=True, seed=cfg.seed)
            else:
                self.train_loader = RawTileLoader(
                    self.dm.train_dataset, batch_size=cfg.batch_size, shuffle=True,
                    num_workers=cfg.num_workers, seed=cfg.seed,
                )
        else:
            self._augment_kwargs = None
            self.train_loader = DataLoader(
                self.dm.train_dataset, batch_size=cfg.batch_size, shuffle=True,
                num_workers=cfg.num_workers, seed=cfg.seed,
            )
        self.val_loader = DataLoader(
            self.dm.val_dataset, batch_size=cfg.validation_batch_size, shuffle=False, drop_last=False,
            pad_last=True, num_workers=cfg.num_workers,
        )
        self.test_loaders = [
            DataLoader(ds, batch_size=cfg.validation_batch_size, shuffle=False, drop_last=False,
                       pad_last=True, num_workers=cfg.num_workers)
            for ds in self.dm.test_datasets
        ]
        # device-resident eval stores, built lazily on first use (test stores
        # must not hold device memory through a fit when test() may never run)
        self._eval_stores: Dict[int, Dict] = {}
        self._eval_store_datasets: Dict[int, Any] = {}
        self._eval_store_workers = cfg.num_workers
        if self.train_store is not None:
            self._eval_store_datasets[id(self.val_loader)] = self.dm.val_dataset
            for loader, ds in zip(self.test_loaders, self.dm.test_datasets):
                self._eval_store_datasets[id(loader)] = ds

        # num_training_steps inference (reference task.py:62-83)
        accum = max(1, trainer_cfg.accumulate_grad_batches)
        self._accum = accum
        # float limits <= 1.0 are fractions of the loader
        steps_per_epoch = self._limit_len(len(self.train_loader), trainer_cfg.limit_train_batches)
        self.steps_per_epoch = steps_per_epoch
        self.num_training_steps = (steps_per_epoch // accum) * trainer_cfg.max_epochs
        if trainer_cfg.max_steps and -1 < trainer_cfg.max_steps < self.num_training_steps:
            self.num_training_steps = trainer_cfg.max_steps
        logger.info("Inferred number of training steps: %d", self.num_training_steps)
        # loop-termination limit in MICRO-batch steps (global_step counts
        # micro-batches; max_steps counts optimizer steps like PL), with the
        # PL sentinel max_steps=-1 meaning unlimited
        self._max_micro_steps = (
            trainer_cfg.max_steps * accum
            if (trainer_cfg.max_steps and trainer_cfg.max_steps > 0)
            else None
        )

        # ---- models (seeded torch init; float32 parameters) -----------------
        gen_kwargs = {k: getattr(generator_cfg, k) for k in GENERATOR_KWARGS}
        self.g_model = create_generator(
            self.generator_type, dtype=self.compute_dtype, device=self.device, train=True,
            generator=torch.Generator().manual_seed(training_cfg.seed), **gen_kwargs,
        )
        n_params = sum(p.numel() for p in self.g_model.parameters())
        logger.info("Generator '%s': %.2fM params", self.generator_type, n_params / 1e6)

        # ---- optimizers ----------------------------------------------------
        g_opt_cfg = self.optimizers_cfg.get(T.generator_optimizer_key) or OptimizerConfig(lr=training_cfg.lr)
        g_sched_cfg = self.schedulers_cfg.get(T.generator_scheduler_key)
        self.g_schedule = resolve_schedule(g_sched_cfg, g_opt_cfg.lr, self.num_training_steps)
        self.g_tx = build_optimizer(
            g_opt_cfg, self.g_schedule, trainer_cfg.gradient_clip_val, accum,
            b1_schedule=resolve_momentum_schedule(g_sched_cfg, self.num_training_steps), device=self.device,
        )
        self.d_model = None
        if self.is_gan:
            if discriminator_cfg is None:
                raise ValueError("GAN task requires a discriminator config")
            # the GAN step feeds the discriminator the generator's output / the HR target
            d_in_ch = getattr(generator_cfg, "out_channels", 1) or 1
            if discriminator_cfg.in_channels != d_in_ch:
                raise ValueError(
                    f"discriminator.in_channels={discriminator_cfg.in_channels} does not match the generator "
                    f"output channels ({d_in_ch}) the GAN step feeds it"
                )
            self.d_model = create_discriminator(
                discriminator_cfg.name, dtype=self.compute_dtype, device=self.device, train=True,
                generator=torch.Generator().manual_seed(training_cfg.seed + 1),
                in_channels=d_in_ch, hr_size=self.dm.train_dataset.hr_size,
            )
            d_opt_cfg = self.optimizers_cfg.get(T.discriminator_optimizer_key) or OptimizerConfig(lr=training_cfg.lr)
            d_sched_cfg = self.schedulers_cfg.get(T.discriminator_scheduler_key)
            self.d_schedule = resolve_schedule(d_sched_cfg, d_opt_cfg.lr, self.num_training_steps)
            self.d_tx = build_optimizer(
                d_opt_cfg, self.d_schedule, trainer_cfg.gradient_clip_val, accum,
                b1_schedule=resolve_momentum_schedule(d_sched_cfg, self.num_training_steps), device=self.device,
            )
            self.state = GANTrainState.create(self.g_model, self.g_tx, self.d_model, self.d_tx)
        else:
            self.state = TrainState.create(self.g_model, self.g_tx)

        # fine-tune: generator-only weight graft (cli/train.py:112-121);
        # (tensors copied, tensors of the generator)
        self.graft = None
        if training_cfg.model_weights:
            self.graft = restore_generator_params(training_cfg.model_weights, self.g_model)

        # ---- steps ---------------------------------------------------------
        step_kwargs = dict(compute_dtype=self.compute_dtype, augment=self._augment_kwargs,
                           augment_seed=training_cfg.seed, store=self.train_store, device=self.device)
        if self.is_gan:
            from climsr_tpu_torch.losses.perceptual import build_perceptual_loss

            # perceptual_loss_factor == 0 skips building the VGG19 graph entirely
            self.perceptual_fn = (
                build_perceptual_loss(differentiable=task_cfg.differentiable_perceptual,
                                      compute_dtype=self.compute_dtype, cutoff=task_cfg.perceptual_cutoff,
                                      device=self.device)
                if task_cfg.perceptual_loss_factor
                else None
            )
            weights = dict(pixel_weight=task_cfg.pixel_level_loss_factor,
                           perceptual_weight=task_cfg.perceptual_loss_factor,
                           adversarial_weight=task_cfg.adversarial_loss_factor, perceptual_fn=self.perceptual_fn)
            self.train_step = make_gan_step(self.g_model, self.d_model, self.generator_type,
                                            perceptual_interval=task_cfg.perceptual_interval,
                                            **weights, **step_kwargs)
            self.gan_val_losses = make_gan_val_losses(self.g_model, self.d_model, self.generator_type,
                                                      compute_dtype=self.compute_dtype, device=self.device,
                                                      **weights)
        else:
            self.train_step = make_pretrain_step(self.g_model, self.generator_type, **step_kwargs)

        zmean, zstd = 0.0, 0.0
        if cfg.normalization_method == "zscore":
            zmean, zstd = self.dm.zscore_stats(cfg.world_clim_variable)
        self._eval_steps = {
            prefix: make_eval_step(
                self.g_model, self.generator_type,
                normalization_method=cfg.normalization_method,
                normalization_range=tuple(cfg.normalization_range),
                zscore_mean=zmean, zscore_std=zstd,
                compute_dtype=self.compute_dtype, prefix=prefix, device=self.device,
            )
            for prefix in (consts.stages.val, consts.stages.test)
        }

        # ---- checkpointing -------------------------------------------------
        self.ckpt = CheckpointManager(self.workdir / "checkpoints", save_top_k=trainer_cfg.save_top_k)
        self.global_step = 0
        self.early_stop_best = float("inf")
        self.early_stop_count = 0
        self._epoch = 0

        if trainer_cfg.resume_from_checkpoint:
            self._load_payload(load_checkpoint(trainer_cfg.resume_from_checkpoint, map_location=self.device))
            logger.info("Resumed from %s at step %d", trainer_cfg.resume_from_checkpoint, self.global_step)

        self.metric_logger.log_hyperparams(
            {"generator": self.generator_type, "task": task_cfg.name, "lr": training_cfg.lr,
             "batch_size": cfg.batch_size, "precision": trainer_cfg.precision},
            initial_hp_metric=task_cfg.initial_hp_metric_val,
        )

    # -----------------------------------------------------------------------
    def _optimizers(self):
        if self.is_gan:
            return [(self.state.g_optimizer, self.g_schedule), (self.state.d_optimizer, self.d_schedule)]
        return [(self.state.optimizer, self.g_schedule)]

    def _payload(self) -> Dict[str, Any]:
        """The checkpoint dict of the run as it stands (PL ``.ckpt`` layout)."""
        sd = {f"generator.{k}": v for k, v in self.g_model.state_dict().items()}
        if self.d_model is not None:
            sd.update({f"discriminator.{k}": v for k, v in self.d_model.state_dict().items()})
        return {
            "epoch": self._epoch,
            "global_step": self.global_step,
            "state_dict": sd,
            "optimizer_states": [opt.state_dict() for opt, _ in self._optimizers()],
            "lr_schedulers": [{"last_epoch": opt.updates, "_last_lr": [float(sched(opt.updates))]}
                              for opt, sched in self._optimizers()],
            "hyper_parameters": self.config_snapshot or {},
        }

    def _load_payload(self, ckpt: Dict[str, Any]) -> None:
        sd = ckpt["state_dict"]
        self.g_model.load_state_dict({k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")})
        if self.d_model is not None:
            self.d_model.load_state_dict(
                {k[len("discriminator."):]: v for k, v in sd.items() if k.startswith("discriminator.")})
        for (opt, _), state in zip(self._optimizers(), ckpt["optimizer_states"]):
            opt.load_state_dict(state)
        self.global_step = int(ckpt["global_step"])
        self.state.step = self.global_step

    def _limit(self, loader_len: int, limit) -> int:
        if self.trainer_cfg.fast_dev_run:
            return min(loader_len, 2)
        return self._limit_len(loader_len, limit)

    @staticmethod
    def _limit_len(loader_len: int, limit) -> int:
        if limit is None:
            return loader_len
        if isinstance(limit, float) and limit <= 1.0:
            return int(loader_len * limit)
        return min(loader_len, int(limit))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -----------------------------------------------------------------------
    def fit(self) -> Dict[str, float]:
        if self.trainer_cfg.profiler != "simple":
            return self._fit_impl()
        # per-stage wall-time table (PL SimpleProfiler), logged and written
        # to profile_stages.txt beside the metrics
        self._stage_times: Dict[str, float] = {}
        try:
            return self._fit_impl()
        finally:
            total = sum(self._stage_times.values()) or 1.0
            lines = [
                f"  {name:<16} {secs:8.2f}s  {secs / total * 100:5.1f}%"
                for name, secs in sorted(self._stage_times.items(), key=lambda kv: -kv[1])
            ]
            logger.info("Profiler report (wall time by stage):\n%s", "\n".join(lines))
            (self.workdir / "profile_stages.txt").write_text("\n".join(lines) + "\n")
            self._stage_times = None

    def _staged(self, name: str, fn, *args):
        times = getattr(self, "_stage_times", None)
        if times is None:
            return fn(*args)
        t0 = time.time()
        try:
            return fn(*args)
        finally:
            self._sync()
            times[name] = times.get(name, 0.0) + (time.time() - t0)

    def _fit_impl(self) -> Dict[str, float]:
        tc = self.trainer_cfg
        last_val: Dict[str, float] = {}
        max_epochs = 1 if tc.fast_dev_run else tc.max_epochs
        # per-step hooks are opt-in so the common path pays no per-batch call
        self._batch_end_cbs = [cb for cb in self.callbacks if hasattr(cb, "on_train_batch_end")]
        for cb in self.callbacks:
            hook = getattr(cb, "on_fit_start", None)
            if hook is not None:
                try:
                    hook(self)
                except Exception:
                    logger.exception("Callback %s on_fit_start failed", type(cb).__name__)
        for epoch in range(max_epochs):
            self._epoch = epoch
            self._staged("train_epoch", self.train_epoch, epoch)
            # a preempted epoch is not an epoch end (PL never fires epoch-end
            # hooks for an interrupted epoch)
            if not self.preempted:
                for cb in self.callbacks:
                    hook = getattr(cb, "on_train_epoch_end", None)
                    if hook is not None:
                        try:
                            hook(self, epoch)
                        except Exception:
                            logger.exception("Callback %s on_train_epoch_end failed", type(cb).__name__)
            if self.preempted:
                # force=True: the preemption save lands even when save_top_k=0
                self.ckpt.save(self.global_step, self._payload(), hp_metric=None,
                               config=self.config_snapshot, force=True)
                logger.warning(
                    "Preemption checkpoint saved at step %d under %s — resume with "
                    "trainer.resume_from_checkpoint", self.global_step, self.workdir / "checkpoints",
                )
                break
            if (epoch + 1) % tc.check_val_every_n_epoch == 0 or epoch == max_epochs - 1:
                last_val = self._staged("validate", self.validate, epoch)
                hp_metric = last_val.get("hp_metric")
                self._staged("checkpoint", lambda: self.ckpt.save(
                    self.global_step, self._payload(), hp_metric=hp_metric, config=self.config_snapshot))
                if hp_metric is not None and tc.early_stopping_patience:
                    if hp_metric < self.early_stop_best - 1e-12:
                        self.early_stop_best = hp_metric
                        self.early_stop_count = 0
                    else:
                        self.early_stop_count += 1
                        if self.early_stop_count >= tc.early_stopping_patience:
                            logger.info("Early stopping at epoch %d (patience %d)", epoch, tc.early_stopping_patience)
                            break
            if self._max_micro_steps and self.global_step >= self._max_micro_steps:
                break
        return last_val

    def train_epoch(self, epoch: int) -> None:
        tc = self.trainer_cfg
        self.train_loader.set_epoch(epoch)
        n_batches = self._limit(len(self.train_loader), tc.limit_train_batches)
        if self.train_store is not None:
            it = iter(self.train_loader)  # index batches; the data is on the device
        else:
            it = device_prefetch(iter(self.train_loader), self.device)
        t0 = time.time()
        samples = 0
        for i, batch in enumerate(it):
            if i >= n_batches:
                break
            if isinstance(batch, dict):
                batch.pop(VALID_KEY, None)
                n_in_batch = batch[B.hr].shape[0]
            else:
                n_in_batch = batch.shape[0]
            self.state, metrics = self.train_step(self.state, batch)
            self.global_step += 1
            for cb in getattr(self, "_batch_end_cbs", ()):
                cb.on_train_batch_end(self)
            if self.preempted:
                break
            samples += n_in_batch
            is_log_step = self.global_step % tc.log_every_n_steps == 0 or i == n_batches - 1
            host = None
            if tc.terminate_on_nan:
                # per-step check (PL terminate_on_nan): one device sync per step
                host = {k: float(v) for k, v in metrics.items()}
                if any(np.isnan(v) for v in host.values()):
                    raise FloatingPointError(f"NaN in training metrics at step {self.global_step}: {host}")
            if is_log_step:
                if host is None:
                    host = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                host["train/samples_per_sec"] = samples / max(dt, 1e-9)
                # the schedule advances once per optimizer step
                host["lr"] = float(self.g_schedule(self.global_step // self._accum))
                self.metric_logger.log_metrics(host, self.global_step)
            if self._max_micro_steps and self.global_step >= self._max_micro_steps:
                break
        self._sync()
        logger.info(
            "epoch %d: %d steps, %.1f samples/s", epoch, min(n_batches, len(self.train_loader)),
            samples / max(time.time() - t0, 1e-9),
        )

    def _eval_batches(self, loader):
        """Yield (batch on the device, n_valid): from the device store when there is one."""
        store = self._eval_stores.get(id(loader))
        if store is None and id(loader) in self._eval_store_datasets:
            store = build_eval_device_store(self._eval_store_datasets[id(loader)],
                                            num_workers=self._eval_store_workers, device=self.device)
            self._eval_stores[id(loader)] = store
        if store is None:
            for batch in device_prefetch(iter(loader), self.device):
                yield batch, float(batch.pop(VALID_KEY))
            return
        n = len(loader.dataset)
        bs = loader.batch_size
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n), dtype=np.int64)
            n_valid = float(len(idx))
            if len(idx) < bs:  # pad to the loader's batch shape, as the host path does
                idx = np.concatenate([idx, np.full(bs - len(idx), idx[-1], np.int64)])
            yield gather(store, torch.from_numpy(idx).to(self.device)), n_valid

    def _eval_loop(self, loader, prefix: str, extra_gan_losses: bool = False) -> Dict[str, float]:
        eval_step = self._eval_steps[prefix]
        n_batches = self._limit(len(loader), getattr(self.trainer_cfg, f"limit_{prefix}_batches", None))
        sums: Dict[str, float] = {}
        weights = 0.0
        for i, (batch, n_valid) in enumerate(self._eval_batches(loader)):
            if i >= n_batches:
                break
            # padded tail batch: evaluate only the valid prefix so duplicated
            # samples don't bias the epoch mean (the weighting below is exact)
            nv = int(n_valid)
            if nv < batch[B.hr].shape[0]:
                batch = {k: v[:nv] for k, v in batch.items()}
            metrics = eval_step(batch)
            if extra_gan_losses and self.is_gan:
                metrics.update(self.gan_val_losses(batch))
            # per-step means weighted by valid count
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n_valid
            weights += n_valid
        return {k: v / max(weights, 1e-9) for k, v in sums.items()}

    def validate(self, epoch: int) -> Dict[str, float]:
        out = self._eval_loop(self.val_loader, consts.stages.val, extra_gan_losses=True)
        # hp_metric = epoch mean of val/rmse (reference task.py:388-391)
        if "val/rmse" in out:
            out["hp_metric"] = out["val/rmse"]
        self.metric_logger.log_metrics(out, self.global_step)
        logger.info("epoch %d val: rmse=%.5f psnr=%.3f ssim=%.4f", epoch,
                    out.get("val/rmse", float("nan")), out.get("val/psnr", float("nan")),
                    out.get("val/ssim", float("nan")))
        for cb in self.callbacks:
            hook = getattr(cb, "on_validation_end", None)
            if hook is None:
                continue
            try:
                hook(self, epoch, out)
            except Exception:
                logger.exception("Callback %s failed", type(cb).__name__)
        return out

    def test(self) -> List[Dict[str, float]]:
        results = []
        for idx, loader in enumerate(self.test_loaders):
            out = self._eval_loop(loader, consts.stages.test)
            tagged = {f"{k}/{idx}" if len(self.test_loaders) > 1 else k: v for k, v in out.items()}
            self.metric_logger.log_metrics(tagged, self.global_step)
            results.append(out)
        return results

    def _on_sigterm(self, signum, frame) -> None:
        logger.warning("SIGTERM received — writing a preemption checkpoint at the next step boundary")
        self.preempted = True

    def close(self) -> None:
        if self._prev_sigterm is not None:
            import signal

            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        self.metric_logger.close()
