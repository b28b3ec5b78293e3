"""RCAN's pixel-loss pre-training cell: the port's Trainer, built from the
composed ``rcan_pre_training`` experiment as ``cli.train.run`` builds it, on a
tile set made from the seed.

The run is ``train.py``'s: the seed's tiles and weights, one Trainer (the
tiles in its device store), the first ``checked_steps`` steps of epoch 0
through ``Trainer.train_epoch`` (the steps the reference follows, and the
warm-up), then the window: the traffic's ``window_epochs`` whole epochs from
epoch 1, then whole epochs to the first step end past ``--seconds`` if that
is later, timed by a CUDA event after each step. The step is launch-bound, so
its rate follows the shared host's CPU, which drifts over tens of seconds; a
whole epoch (300 steps, 90-110 s on one H100) averages more of that drift
than 30 s does. The widths, batch, precision, optimizer and schedule come
from the preset alone (and the traffic's ``overrides``); the composed run is
checked against the configuration and the traffic and a departure raises.

A traced run runs ``traced_steps`` steps under ``trace.device_pass`` (the
idle share and the device operations that took most time), then
``profiled_steps`` (default ``traced_steps``) under the full profile (the idle
gaps by host op: a step of RCAN's ~14,000 device operations and several
times as many host ops makes the full profile the slowest part of a traced
run), then ``traced_steps`` under ``spans.span_pass`` with the program's
recording on, from which the notes take the device time launched inside the
``climsr.rcan.ca`` spans and inside the ``climsr.step.forward`` spans
(``rcan_ca``; the per-layer metrics ``rcan_ca_fwd_pct`` and
``rcan_ca_roofline_pct`` read it). A program without those spans leaves
``rcan_ca`` without them, and the metrics read nothing. Each pass's seconds go
to the notes' ``setup_marks_s``.

Read against ``reference/rcan.py`` (float32, TF32 off) and compared where the
cell's limits file names them, as ``train.compare`` reads a training cell, and
by :func:`ca_grad_gap`, the attentions' first gradient in direction.
"""
from __future__ import annotations

import gc
import shutil
import statistics
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from perfbench import data
from perfbench.counts import rcan as counts
from perfbench.entries.train import ROUND_OFF_LEAF, FirstOutput, StepClock, _TileData, compare
from perfbench.harness import Cell, Outcome
from perfbench.reference import esrgan, rcan
from perfbench.spans import SpanPass, attribute, span_pass
from perfbench.trace import WINDOW, Spans, device_pass, profiled, read_trace

WIDTHS = ("n_resgroups", "n_resblocks", "n_feats", "reduction", "in_channels", "out_channels", "scaling_factor")
CA, FORWARD, CA_CALLS = "climsr.rcan.ca", "climsr.step.forward", "climsr.rcan.ca_calls"


def _check_stated(cell: Cell, gen_cfg, trainer_cfg, data_cfg, opt_cfg, sched_cfg) -> None:
    """The composed run is the one the configuration and traffic state; a run
    that departs from them is no sound run."""
    gen, tr = cell.config["generator"], cell.traffic
    got = dict(generator=gen_cfg.name, **{k: getattr(gen_cfg, k) for k in WIDTHS},
               precision=trainer_cfg.precision, batch=data_cfg.batch_size, epochs=trainer_cfg.max_epochs,
               clip=trainer_cfg.gradient_clip_val, accumulate=trainer_cfg.accumulate_grad_batches,
               name=opt_cfg.name, lr=float(opt_cfg.lr), weight_decay=float(opt_cfg.weight_decay),
               betas=list(opt_cfg.betas), eps=float(opt_cfg.eps), schedule=sched_cfg.name,
               transforms={k: bool(getattr(data_cfg.transforms, k)) for k in tr["transforms"]},
               **{k: float(getattr(sched_cfg, k)) for k in tr["schedule"]})
    want = dict(generator=gen["name"], **{k: gen[k] for k in WIDTHS}, precision=cell.config["precision"],
                batch=tr["batch_size"], epochs=tr["epochs"], clip=0.0, accumulate=1, schedule="one_cycle_schedule",
                transforms=tr["transforms"], **tr["optimizer"], **{k: float(v) for k, v in tr["schedule"].items()})
    if got != want:
        raise ValueError(f"the composed run departs from the cell: {got} against {want}")


def build_trainer(cell: Cell, seed: int, tiles, device, workdir: Path):
    """Compose the cell's experiment (its widths and batch from the preset and
    the traffic's overrides) and build the Trainer as ``cli.train.run`` does,
    on the in-memory tile set."""
    from climsr_tpu_torch.config.compose import compose, default_config_dir
    from climsr_tpu_torch.config.schemas import (
        DiscriminatorConfig, GeneratorConfig, OptimizerConfig, SchedulerConfig, SuperResolutionDataConfig,
        TaskConfig, TrainerConfig, TrainingConfig, from_dict, infer_generator_config,
    )
    from climsr_tpu_torch.training.callbacks import build_callbacks
    from climsr_tpu_torch.training.loop import Trainer

    tr = cell.traffic
    overrides = [f"experiment={tr['experiment']}", f"training.seed={seed}",
                 f"training.output_dir={workdir}"] + list(tr.get("overrides", []))
    cfg = compose(default_config_dir(), "config", overrides)
    task = cfg.get("task")
    if isinstance(task, dict) and isinstance(task.get("cfg"), dict):
        task = {**{k: v for k, v in task.items() if k != "cfg"}, **task["cfg"]}
    data_cfg = from_dict(SuperResolutionDataConfig, cfg["datamodule"]["cfg"])
    generator_cfg = infer_generator_config(from_dict(GeneratorConfig, cfg["generator"]), data_cfg)
    trainer_cfg = from_dict(TrainerConfig, cfg.get("trainer"))
    optimizers = {k: from_dict(OptimizerConfig, (cfg.get("optimizers") or {}).get(k))
                  for k in ("generator_optimizer", "discriminator_optimizer")}
    schedulers = {k: from_dict(SchedulerConfig, (cfg.get("schedulers") or {}).get(k))
                  for k in ("generator_scheduler", "discriminator_scheduler")}
    _check_stated(cell, generator_cfg, trainer_cfg, data_cfg, optimizers["generator_optimizer"],
                  schedulers["generator_scheduler"])
    return Trainer(
        datamodule=_TileData(data_cfg, tiles, data_cfg.scale_factor),
        generator_cfg=generator_cfg, task_cfg=from_dict(TaskConfig, task), trainer_cfg=trainer_cfg,
        training_cfg=from_dict(TrainingConfig, cfg.get("training")),
        discriminator_cfg=from_dict(DiscriminatorConfig, cfg.get("discriminator")),
        optimizers=optimizers, schedulers=schedulers,
        workdir=workdir / "run", config_snapshot=cfg, callbacks=build_callbacks(cfg.get("callbacks")),
        logger_cfg=cfg.get("logger"), device=device,
    )


def ca_grad_gap(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The median, over the attentions' squeeze convs (``*.conv_du.0.weight``),
    of the first gradient's gap ||g - g_ref|| / ||g_ref||. The squeeze's
    gradient is the pooled vector times what flows back into it, so a pool
    taken over other pixels turns it where its norm, all that ``compare``
    reads, barely moves. A squeeze whose ReLU passes nothing for the batch
    has no gradient; those under ``ROUND_OFF_LEAF`` of the median leaf's, as
    ``compare`` rules, are left out."""
    norm = {k: v.double().norm().item() for k, v in ref.items()}
    floor = ROUND_OFF_LEAF * statistics.median(norm.values())
    keys = [k for k in ref if k.endswith(".conv_du.0.weight") and norm[k] >= floor]
    return statistics.median((grads[k].to(ref[k].device).double() - ref[k].double()).norm().item() / norm[k]
                             for k in keys)


def ca_readings(sp: Optional[SpanPass]) -> Dict[str, float]:
    """What the span pass holds of the channel attention: its spans and
    counter over the traced steps, the forward's spans, and on a card the
    device seconds launched inside each (an attention's inside its forward's too)."""
    if sp is None:
        return {}
    ca, fwd = sp.main_spans(CA), sp.main_spans(FORWARD)
    got = {"ca_spans": len(ca), "ca_calls": sp.counts.get(CA_CALLS, 0), "forward_spans": len(fwd)}
    if sp.device:
        device = attribute(sp)
        got["ca_device_s"] = sum(device.get(s.index, 0) for s in ca) / 1e9
        got["forward_device_s"] = sum(device.get(s.index, 0) for s in fwd) / 1e9
    return got


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float, control: bool) -> Outcome:
    gen, tr = cell.config["generator"], cell.traffic
    k = tr["checked_steps"]
    marks = {"start": time.perf_counter() - start}
    tiles = data.make_tiles(tr["tiles"], tr["hr_size"], seed, device)
    weights = rcan.seeded_params(gen, seed, device)
    marks["data"] = time.perf_counter() - start
    if control:
        return _control(cell, seed, tiles, weights, device)
    workdir = Path(tempfile.mkdtemp(prefix="perfbench-"))
    cuda = device.type == "cuda"
    ca: Dict[str, float] = {}
    try:
        trainer = build_trainer(cell, seed, tiles, device, workdir)
        trainer.g_model.load_state_dict(weights, strict=True)
        marks["trainer"] = time.perf_counter() - start
        clock = StepClock(trainer, timed=cuda, loss_keys=tr["loss_keys"])
        trainer.train_step = clock
        opt = trainer.state.optimizer
        snap: Dict[str, Dict[str, torch.Tensor]] = {"grads": {}, "moved": {}}

        def first_grads():
            inner = opt.inner
            beta1 = inner.param_groups[0]["betas"][0]
            snap["grads"].update({n: inner.state[p]["exp_avg"].detach() / (1 - beta1)
                                  if "exp_avg" in inner.state[p] else torch.zeros_like(p)
                                  for n, p in trainer.g_model.named_parameters()})

        def moved():
            snap["moved"].update({n: p.detach() - weights[n] for n, p in trainer.g_model.named_parameters()})

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
        epoch = 1
        for _ in range(tr.get("window_epochs", 0)):
            trainer.train_epoch(epoch)
            epoch += 1
        if time.perf_counter() < t0 + seconds:
            clock.deadline = t0 + seconds
            epoch = clock.run_epochs(epoch)
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
            def steps_of(n: int):
                def run():
                    nonlocal epoch
                    clock.limit = clock.steps + n
                    epoch = clock.run_epochs(epoch)
                return run

            traced_steps = steps_of(tr["traced_steps"])
            t_pass = time.perf_counter()
            timeline = device_pass(device, traced_steps)
            marks["device_pass_s"] = time.perf_counter() - t_pass
            wrapped = Spans()
            wrapped.wrap(trainer, "train_step", "perfbench.train_step")
            wrapped.wrap(trainer.metric_logger, "log_metrics", "perfbench.log_metrics")
            t_pass = time.perf_counter()
            try:
                with profiled() as holder:
                    with torch.profiler.record_function(WINDOW):
                        steps_of(tr.get("profiled_steps", tr["traced_steps"]))()
                        if cuda:
                            torch.cuda.synchronize(device)
                summary = read_trace(holder[0], timeline)
                marks["trace"] = summary.counts
            finally:
                wrapped.close()
            del holder
            marks["profile_s"] = time.perf_counter() - t_pass
            t_pass = time.perf_counter()
            ca = ca_readings(span_pass(device, traced_steps))
            marks["span_pass_s"] = time.perf_counter() - t_pass
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        grads, moves = snap["grads"], snap["moved"]
        del trainer, clock, opt, snap
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    t_ref = time.perf_counter()
    ref = _reference(cell, seed, tiles, weights, device, low=False)
    marks["reference_s"] = time.perf_counter() - t_ref
    where: Dict[str, object] = {}
    checks = compare(losses, grads, moves, ref, weights, where, first_out.out)
    checks["ca_grad_gap"] = ca_grad_gap(grads, ref["first_grads"])
    step_flops = counts.train_step_flops(gen, tr["batch_size"], tr["hr_size"] // tr["scale"])
    return Outcome(
        kind="train",
        end_to_end={"train_samples_per_s": steps * tr["batch_size"] / wall, "train_step_p90_ms": p90,
                    "setup_s": setup_s},
        attempted=steps, failed=0, memory_peak_bytes=int(peak), checks=checks, window_s=wall,
        flops=steps * step_flops, trace=summary,
        notes={"steps": steps, "losses": losses, "ref_losses": ref["losses"], "worst_leaves": where,
               "setup_marks_s": marks, "rcan_ca": ca},
    )


def _reference(cell: Cell, seed: int, tiles, weights, device, low: bool) -> dict:
    tr = cell.traffic
    ref = rcan.run_steps(weights, cell.config["generator"], tiles, tr, seed, tr["checked_steps"], device,
                         esrgan.fp8_conv if low else esrgan.f32_conv)
    ref["losses"] = [[v] for v in ref["losses"]]
    return ref


def _control(cell: Cell, seed: int, tiles, weights, device) -> Outcome:
    """The reference in float8 put in the program's place, held to the same numbers."""
    ref = _reference(cell, seed, tiles, weights, device, low=False)
    low = _reference(cell, seed, tiles, weights, device, low=True)
    moved = {n: low["params"][n] - weights[n] for n in weights}
    where: Dict[str, object] = {}
    checks = compare(low["losses"], low["first_grads"], moved, ref, weights, where, low["first_out"])
    checks["ca_grad_gap"] = ca_grad_gap(low["first_grads"], ref["first_grads"])
    return Outcome(kind="train", end_to_end={}, attempted=0, failed=0, memory_peak_bytes=0, checks=checks,
                   notes={"worst_leaves": where})
