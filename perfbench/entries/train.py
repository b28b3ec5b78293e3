"""Training cells: the port's Trainer, built from the composed experiment as
``cli.train.run`` builds it, on a tile set made from the seed.

Set-up makes the tiles (on the device, kept on the host as a prepared set
would be) and the weights, builds one Trainer (which puts the tiles in its
device store, as ``device_resident_data="auto"`` does under the store's byte
limit), loads the weights, and drives the Trainer's own epoch
(``Trainer.train_epoch``) through the first ``checked_steps`` steps of epoch 0:
these are the steps the reference follows, and the warm-up. The window then
runs whole epochs from epoch 1 on, the same Trainer object, and stops at the
first step boundary after ``--seconds`` (the Trainer's own stop-at-a-step
flag), then synchronizes. A CUDA event recorded after each step gives the
intervals between step ends, read after the window.

Read against the reference (``reference/train.py``, float32, TF32 off), and
compared where the cell's limits file names them: each checked step's loss;
the first step's generator output; the first step's gradient, worked out per
leaf from the optimizer's first moment after one step; and each leaf's change
over the checked steps. Gradients and changes are read as norms per leaf, the gap
taken against the larger of that leaf's reference norm and the median
leaf's (of its own model, in a GAN); the worst leaf's gap and each model's
median leaf's are kept. Leaves whose reference gradient is under a
thousandth of that median leaf's have a gradient that is nought but for
rounding (the biases of the discriminator's last conv and two linears, which
shift every score alike under the relativistic losses): their gradient is
rounding noise and they move by round-off alone, so they are left out of both.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import shutil
import statistics
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import data
from perfbench.harness import Cell, Outcome
from perfbench.reference import esrgan, gan as ref_gan, train as ref_train
from perfbench.trace import WINDOW, Spans, device_pass, profiled, read_trace

ROUND_OFF_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


class _TileSet:
    """The train split in memory: what the Trainer's store reads of a prepared set."""

    def __init__(self, tiles: Dict[str, np.ndarray], hr_size: int, scale: int):
        self.tiles, self.hr_size, self.lr_size = tiles, hr_size, hr_size // scale

    def __len__(self) -> int:
        return len(self.tiles["hr"])

    def _load_normalized(self, i: int):
        t = self.tiles
        return t["hr"][i], t["elevation"][i], t["mask"][i], None


class _TileData:
    """The datamodule the run hands the Trainer; only its train split is read."""

    def __init__(self, cfg, tiles, scale: int):
        self.cfg = cfg
        self.train_dataset = _TileSet(tiles, tiles["hr"].shape[-1], scale)
        self.val_dataset = self.train_dataset
        self.test_datasets: List = []


def _check_stated(cell: Cell, gen_cfg, trainer_cfg, data_cfg, opt_cfg, sched_cfg) -> None:
    """The composed run is the one the configuration and traffic state; a run
    that departs from them is no sound run."""
    gen, tr = cell.config["generator"], cell.traffic
    got = dict(nf=gen_cfg.nf, nb=gen_cfg.nb, gc=gen_cfg.gc, in_channels=gen_cfg.in_channels,
               out_channels=gen_cfg.out_channels, scaling_factor=gen_cfg.scaling_factor,
               precision=trainer_cfg.precision, batch=data_cfg.batch_size, epochs=trainer_cfg.max_epochs,
               clip=trainer_cfg.gradient_clip_val, accumulate=trainer_cfg.accumulate_grad_batches,
               name=opt_cfg.name, lr=float(opt_cfg.lr), weight_decay=float(opt_cfg.weight_decay),
               betas=list(opt_cfg.betas), eps=float(opt_cfg.eps), schedule=sched_cfg.name,
               transforms={k: bool(getattr(data_cfg.transforms, k)) for k in tr["transforms"]},
               **{k: float(getattr(sched_cfg, k)) for k in tr["schedule"]})
    want = dict({k: gen[k] for k in ("nf", "nb", "gc", "in_channels", "out_channels", "scaling_factor")},
                precision=cell.config["precision"], batch=tr["batch_size"], epochs=tr["epochs"], clip=0.0,
                accumulate=1, schedule="one_cycle_schedule", transforms=tr["transforms"], **tr["optimizer"],
                **{k: float(v) for k, v in tr["schedule"].items()})
    if got != want:
        raise ValueError(f"the composed run departs from the cell: {got} against {want}")


def build_trainer(cell: Cell, seed: int, tiles, device, workdir: Path, vgg=None):
    """Compose the experiment with the cell's sizes and build the Trainer as
    ``cli.train.run`` does, on the in-memory tile set; ``vgg`` is handed to
    the perceptual term in place of the weights it would look up."""
    from climsr_tpu_torch.config.compose import compose, default_config_dir
    from climsr_tpu_torch.config.schemas import (
        DiscriminatorConfig, GeneratorConfig, OptimizerConfig, SchedulerConfig, SuperResolutionDataConfig,
        TaskConfig, TrainerConfig, TrainingConfig, from_dict, infer_generator_config,
    )
    from climsr_tpu_torch.training.callbacks import build_callbacks
    from climsr_tpu_torch.training.loop import Trainer

    gen, tr = cell.config["generator"], cell.traffic
    overrides = [f"experiment={tr['experiment']}", f"generator.nf={gen['nf']}", f"generator.nb={gen['nb']}",
                 f"generator.gc={gen['gc']}", f"training.seed={seed}", f"training.output_dir={workdir}",
                 f"training.batch_size={tr['batch_size']}"] + list(tr.get("overrides", []))
    cfg = compose(default_config_dir(), "config", overrides)
    training_cfg = from_dict(TrainingConfig, cfg.get("training"))
    trainer_cfg = from_dict(TrainerConfig, cfg.get("trainer"))
    task = cfg.get("task")
    if isinstance(task, dict) and isinstance(task.get("cfg"), dict):
        task = {**{k: v for k, v in task.items() if k != "cfg"}, **task["cfg"]}
    task_cfg = from_dict(TaskConfig, task)
    data_cfg = from_dict(SuperResolutionDataConfig, cfg["datamodule"]["cfg"])
    generator_cfg = infer_generator_config(from_dict(GeneratorConfig, cfg["generator"]), data_cfg)
    optimizers = {k: from_dict(OptimizerConfig, (cfg.get("optimizers") or {}).get(k))
                  for k in ("generator_optimizer", "discriminator_optimizer")}
    schedulers = {k: from_dict(SchedulerConfig, (cfg.get("schedulers") or {}).get(k))
                  for k in ("generator_scheduler", "discriminator_scheduler")}
    _check_stated(cell, generator_cfg, trainer_cfg, data_cfg, optimizers["generator_optimizer"],
                  schedulers["generator_scheduler"])
    if tr.get("task") == "gan_training":
        _check_gan_stated(cell, task_cfg)
    with _perceptual_weights(vgg):
        return Trainer(
            datamodule=_TileData(data_cfg, tiles, data_cfg.scale_factor),
            generator_cfg=generator_cfg, task_cfg=task_cfg, trainer_cfg=trainer_cfg, training_cfg=training_cfg,
            discriminator_cfg=from_dict(DiscriminatorConfig, cfg.get("discriminator")),
            optimizers=optimizers, schedulers=schedulers,
            workdir=workdir / "run", config_snapshot=cfg, callbacks=build_callbacks(cfg.get("callbacks")),
            logger_cfg=cfg.get("logger"), device=device,
        )


@contextlib.contextmanager
def _perceptual_weights(vgg):
    """While the Trainer is built, the perceptual term's weight lookup returns ``vgg``."""
    if vgg is None:
        yield
        return
    from climsr_tpu_torch.losses import perceptual

    lookup = perceptual.load_feature_weights
    perceptual.load_feature_weights = lambda cutoff="conv5_4": ({k: v.cpu() for k, v in vgg.items()}, "seeded")
    try:
        yield
    finally:
        perceptual.load_feature_weights = lookup


def _check_gan_stated(cell: Cell, task_cfg) -> None:
    w = cell.traffic["loss_weights"]
    got = dict(pixel=task_cfg.pixel_level_loss_factor, perceptual=task_cfg.perceptual_loss_factor,
               adversarial=task_cfg.adversarial_loss_factor, differentiable=task_cfg.differentiable_perceptual,
               interval=task_cfg.perceptual_interval, cutoff=task_cfg.perceptual_cutoff)
    want = dict(w, differentiable=False, interval=1, cutoff="conv5_4")
    if got != want:
        raise ValueError(f"the composed GAN run departs from the cell: {got} against {want}")


def _check_d_optimizer(cell: Cell, trainer) -> None:
    """D's optimizer as the Trainer made it: AdamW as the traffic states it,
    under G's one-cycle schedule and beta1 co-cycle."""
    d = cell.traffic["d_optimizer"]
    spec = trainer.state.d_optimizer.spec
    inner = trainer.state.d_optimizer.inner
    group = inner.param_groups[0]
    at = (0, 1, 100, 4000)
    got = dict(name=type(inner).__name__.lower(), lr=[trainer.d_schedule(i) for i in at],
               b1=[spec.b1_schedule(i) for i in at], weight_decay=group["weight_decay"], betas=list(group["betas"])[1:],
               eps=group["eps"])
    want = dict(name=d["name"], lr=[trainer.g_schedule(i) for i in at],
                b1=[trainer.state.g_optimizer.spec.b1_schedule(i) for i in at], weight_decay=d["weight_decay"],
                betas=d["betas"][1:], eps=d["eps"])
    if got != want or d != cell.traffic["optimizer"]:
        raise ValueError(f"the discriminator's optimizer departs from the cell: {got} against {want}")


class FirstOutput:
    """While active, keeps the generator's output of the step's first call
    (the tasks' ``apply_generator_batch``), as float32."""

    def __init__(self):
        self.out = None
        self._undo = []

    def __enter__(self):
        from climsr_tpu_torch.training.tasks import gan, pretrain

        for mod in (pretrain, gan):
            inner = mod.apply_generator_batch

            def keep(*args, _inner=inner, **kwargs):
                out = _inner(*args, **kwargs)
                if self.out is None:
                    self.out = out.detach().float().clone()
                return out

            mod.apply_generator_batch = keep
            self._undo.append((mod, inner))
        return self

    def __exit__(self, *exc):
        for mod, inner in self._undo:
            mod.apply_generator_batch = inner
        self._undo = []


class StepClock:
    """Stands in the Trainer's ``train_step``: runs the step, records a CUDA
    event after it, keeps its loss, and raises the Trainer's stop flag at
    ``limit`` steps or past ``deadline`` on the host clock."""

    def __init__(self, trainer, timed: bool, loss_keys=("train/loss",)):
        self.trainer, self.inner, self.timed, self.loss_keys = trainer, trainer.train_step, timed, loss_keys
        self.steps, self.limit, self.deadline = 0, None, None
        self.events: List = []
        self.losses: List[List[torch.Tensor]] = []
        self.after = {}  # step number -> callbacks after that step

    def __call__(self, state, batch):
        state, metrics = self.inner(state, batch)
        self.steps += 1
        if self.timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        if self.steps in self.after:
            self.losses.append([metrics[key].detach().clone() for key in self.loss_keys])
            for hook in self.after[self.steps]:
                hook()
        if (self.limit is not None and self.steps >= self.limit) or \
                (self.deadline is not None and time.perf_counter() >= self.deadline):
            self.trainer.preempted = True
        return state, metrics

    def run_epochs(self, first_epoch: int) -> int:
        """Whole epochs from ``first_epoch`` until the stop flag; the next epoch's number."""
        epoch = first_epoch
        self.trainer.preempted = False
        while not self.trainer.preempted:
            self.trainer.train_epoch(epoch)
            epoch += 1
        self.trainer.preempted = False
        return epoch


def _model_of(name: str) -> str:
    """The model a leaf belongs to: ``G.`` or ``D.`` in a GAN's dicts, else the one model."""
    return name.split(".", 1)[0] if name[:2] in ("G.", "D.") else ""


def _leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> Tuple[float, Dict[str, float], str]:
    """Per leaf |norm(got) - norm(ref)| over the larger of norm(ref) and its
    model's median leaf's: the worst leaf's, each model's median leaf's, and
    the worst leaf's name."""
    rn = {k: ref[k].double().norm().item() for k in keep}
    med = {m: statistics.median(v for k, v in rn.items() if _model_of(k) == m) for m in {_model_of(k) for k in rn}}
    gaps = {k: abs(got[k].double().norm().item() - rn[k]) / max(rn[k], med[_model_of(k)]) for k in keep}
    worst = max(gaps, key=gaps.get)
    medians = {m: statistics.median(v for k, v in gaps.items() if _model_of(k) == m) for m in med}
    return gaps[worst], medians, worst


def compare(losses: List[List[float]], grads: Dict[str, torch.Tensor], moved: Dict[str, torch.Tensor],
            ref: dict, p0: Dict[str, torch.Tensor], where: Dict[str, object] = None,
            out: torch.Tensor = None) -> Dict[str, float]:
    """Every number a training cell can compare with the reference (its
    limits file names those it does): the losses' widest relative gap over the
    checked steps and at the first; the first step's generator output
    ``out`` against the reference's, its widest gap over the reference's
    largest value (a row missing reads infinite); and the per-leaf gaps of the
    first gradient and of the change: the worst leaf's, and the median leaf's
    of the model where it reads worst (each model's apart, ``*_median_gap.G``
    and ``.D``, in a GAN), so that a model whose leaves are few is not
    outvoted by the other's; ``where`` gets the worst leaf of each and the
    leaves left out."""
    rg = ref["first_grads"]
    gnorm = {k: v.double().norm().item() for k, v in rg.items()}
    med = {m: statistics.median(v for k, v in gnorm.items() if _model_of(k) == m) for m in {_model_of(k) for k in rg}}
    moving = [k for k in rg if gnorm[k] >= ROUND_OFF_LEAF * med[_model_of(k)]]
    ref_moved = {k: ref["params"][k] - p0[k] for k in moving}
    steps = [max(abs(a - b) / abs(b) for a, b in zip(got, want)) for got, want in zip(losses, ref["losses"])]
    grad_gap, grad_median, grad_leaf = _leaf_gaps(grads, rg, moving)
    move_gap, move_median, move_leaf = _leaf_gaps(moved, ref_moved, moving)
    if where is not None:
        where.update(grad=grad_leaf, move=move_leaf, left_out=sorted(set(rg) - set(moving)))
    want = ref["first_out"]
    out1 = float("inf") if out is None or out.shape != want.shape else \
        ((out.to(want.device) - want).abs().max() / want.abs().max()).item()
    checks = {"loss_gap": max(steps), "loss1_gap": steps[0], "out1_gap": out1, "grad_gap": grad_gap,
              "move_gap": move_gap, "grad_median_gap": max(grad_median.values()),
              "move_median_gap": max(move_median.values())}
    if len(move_median) > 1:
        checks.update({f"grad_median_gap.{m}": v for m, v in grad_median.items()})
        checks.update({f"move_median_gap.{m}": v for m, v in move_median.items()})
    return checks


def _models(trainer, gan: bool):
    """(prefix, module, optimizer) of each trained model."""
    if gan:
        return [("G.", trainer.g_model, trainer.state.g_optimizer), ("D.", trainer.d_model, trainer.state.d_optimizer)]
    return [("", trainer.g_model, trainer.state.optimizer)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float, control: bool) -> Outcome:
    gen, tr = cell.config["generator"], cell.traffic
    k, gan = tr["checked_steps"], tr.get("task") == "gan_training"
    marks = {"start": time.perf_counter() - start}
    tiles = data.make_tiles(tr["tiles"], tr["hr_size"], seed, device)
    weights = _weights(cell, seed, device)
    marks["data"] = time.perf_counter() - start
    if control:
        return _control(cell, seed, tiles, weights, device)
    family = importlib.import_module(f"perfbench.counts.{cell.config['family']}")
    start_params = _start_params(weights, gan)
    workdir = Path(tempfile.mkdtemp(prefix="perfbench-"))
    cuda = device.type == "cuda"
    try:
        trainer = build_trainer(cell, seed, tiles, device, workdir, vgg=weights.get("vgg"))
        trainer.g_model.load_state_dict(weights["G"], strict=True)
        if gan:
            _check_d_optimizer(cell, trainer)
            trainer.d_model.load_state_dict({**weights["D"], **ref_gan.d_buffers(weights["D"])}, strict=True)
        marks["trainer"] = time.perf_counter() - start
        clock = StepClock(trainer, timed=cuda, loss_keys=tr["loss_keys"])
        trainer.train_step = clock
        snap: Dict[str, Dict[str, torch.Tensor]] = {"grads": {}, "moved": {}}
        models = _models(trainer, gan)

        def first_grads():
            for prefix, module, opt in models:
                inner = opt.inner
                beta1 = inner.param_groups[0]["betas"][0]
                # a parameter the first step left without a moment had no gradient from it
                snap["grads"].update({prefix + n: inner.state[p]["exp_avg"].detach() / (1 - beta1)
                                      if "exp_avg" in inner.state[p] else torch.zeros_like(p)
                                      for n, p in module.named_parameters()})

        def moved():
            for prefix, module, _ in models:
                snap["moved"].update({prefix + n: p.detach() - start_params[prefix + n]
                                      for n, p in module.named_parameters()})

        clock.after = {s: [] for s in range(1, k + 1)}
        clock.after[1].append(first_grads)
        clock.after[k].append(moved)
        clock.limit = k
        with FirstOutput() as first_out:
            trainer.train_epoch(0)
        trainer.preempted = False
        if clock.steps != k:
            raise RuntimeError(f"the checked steps ran {clock.steps} steps, not {k}")
        losses = [[v.item() for v in step] for step in clock.losses]
        clock.after, clock.limit, clock.events = {}, None, []

        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        setup_s = t0 - start
        if cuda:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        steps_before = clock.steps
        clock.deadline = t0 + seconds
        epoch = clock.run_epochs(1)
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        steps = clock.steps - steps_before
        ends = [mark] + clock.events if cuda else []
        intervals = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        p90 = float(np.percentile(intervals, 90)) if intervals else float("nan")
        clock.deadline, clock.events = None, []

        summary = None
        if trace:
            def traced_steps():
                nonlocal epoch
                clock.limit = clock.steps + tr["traced_steps"]
                epoch = clock.run_epochs(epoch)

            timeline = device_pass(device, traced_steps)
            spans = Spans()
            spans.rdb()
            spans.wrap(trainer, "train_step", "perfbench.train_step")
            spans.wrap(trainer.metric_logger, "log_metrics", "perfbench.log_metrics")
            try:
                with profiled() as holder:
                    with torch.profiler.record_function(WINDOW):
                        traced_steps()
                        if cuda:
                            torch.cuda.synchronize(device)
                summary = read_trace(holder[0], timeline)
                marks["trace"] = summary.counts
            finally:
                spans.close()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        grads, moves = snap["grads"], snap["moved"]
        del trainer, clock, models, snap
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    t_ref = time.perf_counter()
    ref = _reference(cell, seed, tiles, weights, device, low=False)
    marks["reference_s"] = time.perf_counter() - t_ref
    where: Dict[str, object] = {}
    checks = compare(losses, grads, moves, ref, start_params, where, first_out.out)
    lr_size = tr["hr_size"] // tr["scale"]
    step_flops = family.gan_step_flops(gen, tr["batch_size"], lr_size) if gan else \
        family.train_step_flops(gen, tr["batch_size"], lr_size)
    return Outcome(
        kind="train",
        end_to_end={"train_samples_per_s": steps * tr["batch_size"] / wall, "train_step_p90_ms": p90,
                    "setup_s": setup_s},
        attempted=steps, failed=0, memory_peak_bytes=int(peak), checks=checks, window_s=wall,
        flops=steps * step_flops, trace=summary,
        notes={"steps": steps, "losses": losses, "ref_losses": ref["losses"], "worst_leaves": where,
               "setup_marks_s": marks},
    )


def _weights(cell: Cell, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The seed's weights of every model the task trains or reads."""
    out = {"G": esrgan.seeded_params(cell.config["generator"], seed, device)}
    if cell.traffic.get("task") == "gan_training":
        out["D"] = ref_gan.seeded_d(cell.traffic["hr_size"], seed, device)
        out["vgg"] = ref_gan.seeded_vgg(seed, device)
    return out


def _start_params(weights, gan: bool) -> Dict[str, torch.Tensor]:
    if not gan:
        return weights["G"]
    return {**{f"G.{k}": v for k, v in weights["G"].items()}, **{f"D.{k}": v for k, v in weights["D"].items()}}


def _reference(cell: Cell, seed: int, tiles, weights, device, low: bool) -> dict:
    gen, tr = cell.config["generator"], cell.traffic
    if tr.get("task") == "gan_training":
        return ref_train.run_gan_steps(weights["G"], weights["D"], weights["vgg"], gen, tiles, tr, seed,
                                       tr["checked_steps"], device, low=low)
    ref = ref_train.run_steps(weights["G"], gen, tiles, tr, seed, tr["checked_steps"], device,
                              esrgan.fp8_conv if low else esrgan.f32_conv)
    ref["losses"] = [[v] for v in ref["losses"]]
    return ref


def _control(cell: Cell, seed: int, tiles, weights, device) -> Outcome:
    """The reference in float8 put in the program's place, held to the same numbers."""
    gan = cell.traffic.get("task") == "gan_training"
    start = _start_params(weights, gan)
    ref = _reference(cell, seed, tiles, weights, device, low=False)
    low = _reference(cell, seed, tiles, weights, device, low=True)
    moved = {n: low["params"][n] - start[n] for n in start}
    where: Dict[str, object] = {}
    checks = compare(low["losses"], low["first_grads"], moved, ref, start, where, low["first_out"])
    return Outcome(kind="train", end_to_end={}, attempted=0, failed=0, memory_peak_bytes=0, checks=checks,
                   notes={"worst_leaves": where})
