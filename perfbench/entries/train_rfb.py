"""RFB-ESRGAN's pixel-loss pre-training cell: the port's Trainer, built from
the composed ``esrgan_pre_training`` experiment with the generator switched
(the traffic's ``overrides``: ``generator=rfb_esrgan``,
``training.generator_type=rfb_esrgan``), as ``cli.train.run`` builds it, on a
tile set made from the seed.

The run is ``train.py``'s: the seed's tiles and weights, one Trainer (the
tiles in its device store), the first ``checked_steps`` steps of epoch 0
through ``Trainer.train_epoch`` (the steps the reference follows, and the
warm-up), then the window: the traffic's ``window_epochs`` whole epochs from
epoch 1, then whole epochs to the first step end past ``--seconds`` if that
is later, timed by a CUDA event after each step. Half the step's device time
waits on the host's launches, so its rate drifts with the shared host's CPU;
a whole epoch (150 steps, about 95 s on one H100) averages more of that
drift than 30 s does. The Trainer is
``train_rcan.build_trainer``'s, with this cell's check of what was composed:
the generator's depths, channels and scale, the built trunk's 64 features
and growth 32, and the batch, precision, optimizer and schedule, against the
configuration and the traffic; a departure raises.

A traced run runs ``traced_steps`` steps under ``trace.device_pass`` (the
idle share and the device operations that took most time), then
``profiled_steps`` under the full profile with the harness's RDB spans open
(``Spans.rdb``: kernels B1 and B2 of the trunk's 48 RDBs, which
``rdb_train_roofline_pct`` reads), then ``traced_steps`` under
``spans.span_pass`` with the program's recording on, from which the notes
take the device time launched inside the ``climsr.rfb.block`` spans and
inside the ``climsr.step.forward`` spans, and the spans by block key
(``rfb``; the per-layer metrics ``rfb_fwd_pct`` and ``rfb_roofline_pct`` read
it). A program without those spans leaves ``rfb`` without them, and the
metrics read nothing. Each pass's seconds go to the notes' ``setup_marks_s``.

Read against ``reference/rfb_esrgan.py`` (float32, TF32 off) and compared
where the cell's limits file names them, as ``train.compare`` reads a
training cell.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Optional
from unittest import mock

import numpy as np
import torch

from perfbench import data
from perfbench.counts import rfb_esrgan as counts
from perfbench.entries import train_rcan
from perfbench.entries.train import FirstOutput, StepClock, compare
from perfbench.harness import Cell, Outcome
from perfbench.reference import rfb_esrgan
from perfbench.spans import SpanPass, attribute, span_pass
from perfbench.trace import WINDOW, Spans, device_pass, profiled, read_trace

WIDTHS = ("num_rrdb_blocks", "num_rrfdb_blocks", "in_channels", "out_channels", "scaling_factor")
BLOCK, FORWARD, CALLS = "climsr.rfb.block", "climsr.step.forward", "climsr.rfb.calls"


def _check_stated(cell: Cell, gen_cfg, trainer_cfg, data_cfg, opt_cfg, sched_cfg) -> None:
    """The composed run is the one the configuration and traffic state; a run
    that departs from them is no sound run."""
    gen, tr = cell.config["generator"], cell.traffic
    got = dict(generator=gen_cfg.name, **{k: getattr(gen_cfg, k) for k in WIDTHS},
               generator_type=data_cfg.generator_type, precision=trainer_cfg.precision, batch=data_cfg.batch_size,
               epochs=trainer_cfg.max_epochs, clip=trainer_cfg.gradient_clip_val,
               accumulate=trainer_cfg.accumulate_grad_batches, name=opt_cfg.name, lr=float(opt_cfg.lr),
               weight_decay=float(opt_cfg.weight_decay), betas=list(opt_cfg.betas), eps=float(opt_cfg.eps),
               schedule=sched_cfg.name, transforms={k: bool(getattr(data_cfg.transforms, k)) for k in tr["transforms"]},
               **{k: float(getattr(sched_cfg, k)) for k in tr["schedule"]})
    want = dict(generator=gen["name"], **{k: gen[k] for k in WIDTHS}, generator_type=gen["name"],
                precision=cell.config["precision"], batch=tr["batch_size"], epochs=tr["epochs"], clip=0.0, accumulate=1,
                schedule="one_cycle_schedule", transforms=tr["transforms"], **tr["optimizer"],
                **{k: float(v) for k, v in tr["schedule"].items()})
    if got != want:
        raise ValueError(f"the composed run departs from the cell: {got} against {want}")


def build_trainer(cell: Cell, seed: int, tiles, device, workdir: Path):
    """``train_rcan.build_trainer`` (the traffic's experiment and overrides,
    the Trainer as ``cli.train.run`` builds it) under this cell's check; the
    built generator's features and growth against the configuration's."""
    with mock.patch.object(train_rcan, "_check_stated", _check_stated):
        trainer = train_rcan.build_trainer(cell, seed, tiles, device, workdir)
    g, gen = trainer.g_model, cell.config["generator"]
    built = dict(nf=g.conv1.out_channels, gc=g.Trunk_A[0].RDB1.conv1[0].out_channels)
    if built != {k: gen[k] for k in built}:
        raise ValueError(f"the built generator departs from the cell: {built} against {gen}")
    return trainer


def rfb_readings(sp: Optional[SpanPass]) -> Dict[str, object]:
    """What the span pass holds of the receptive-field blocks: their spans
    (and how many of each block key) and counter over the traced steps, the
    forward's spans, and on a card the device seconds launched inside each
    (a block's inside its forward's too)."""
    if sp is None:
        return {}
    blocks, fwd = sp.main_spans(BLOCK), sp.main_spans(FORWARD)
    got: Dict[str, object] = {"block_spans": len(blocks), "block_calls": sp.counts.get(CALLS, 0),
                              "forward_spans": len(fwd), "keys": dict(Counter(s.key for s in blocks))}
    if sp.device:
        device = attribute(sp)
        got["block_device_s"] = sum(device.get(s.index, 0) for s in blocks) / 1e9
        got["forward_device_s"] = sum(device.get(s.index, 0) for s in fwd) / 1e9
    return got


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float, control: bool) -> Outcome:
    gen, tr = cell.config["generator"], cell.traffic
    k = tr["checked_steps"]
    marks = {"start": time.perf_counter() - start}
    tiles = data.make_tiles(tr["tiles"], tr["hr_size"], seed, device)
    weights = rfb_esrgan.seeded_params(gen, seed, device)
    marks["data"] = time.perf_counter() - start
    if control:
        return _control(cell, seed, tiles, weights, device)
    workdir = Path(tempfile.mkdtemp(prefix="perfbench-"))
    cuda = device.type == "cuda"
    rfb: Dict[str, object] = {}
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
            wrapped.rdb()
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
            rfb = rfb_readings(span_pass(device, traced_steps))
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
    step_flops = counts.train_step_flops(gen, tr["batch_size"], tr["hr_size"] // tr["scale"])
    return Outcome(
        kind="train",
        end_to_end={"train_samples_per_s": steps * tr["batch_size"] / wall, "train_step_p90_ms": p90,
                    "setup_s": setup_s},
        attempted=steps, failed=0, memory_peak_bytes=int(peak), checks=checks, window_s=wall,
        flops=steps * step_flops, trace=summary,
        notes={"steps": steps, "losses": losses, "ref_losses": ref["losses"], "worst_leaves": where,
               "setup_marks_s": marks, "rfb": rfb},
    )


def _reference(cell: Cell, seed: int, tiles, weights, device, low: bool) -> dict:
    tr = cell.traffic
    ref = rfb_esrgan.run_steps(weights, cell.config["generator"], tiles, tr, seed, tr["checked_steps"], device,
                               rfb_esrgan.fp8_conv if low else rfb_esrgan.f32_conv)
    ref["losses"] = [[v] for v in ref["losses"]]
    return ref


def _control(cell: Cell, seed: int, tiles, weights, device) -> Outcome:
    """The reference in float8 put in the program's place, held to the same numbers."""
    ref = _reference(cell, seed, tiles, weights, device, low=False)
    low = _reference(cell, seed, tiles, weights, device, low=True)
    moved = {n: low["params"][n] - weights[n] for n in weights}
    where: Dict[str, object] = {}
    checks = compare(low["losses"], low["first_grads"], moved, ref, weights, where, low["first_out"])
    return Outcome(kind="train", end_to_end={}, attempted=0, failed=0, memory_peak_bytes=0, checks=checks,
                   notes={"worst_leaves": where})
