# -*- coding: utf-8 -*-
"""Rank-side checks of the multi-rank code on the CPU, for
``tests/test_torch_parallel.py``, ``tests/test_torch_spatial.py`` and
``tests/test_torch_zero_services.py``.

:func:`main` runs on every rank of a gloo group started by
``parallel.launch.spawn("climsr_tpu_torch.parallel.cases:main", 4, {...})``.
It reads the suites' inputs from ``workdir/inputs.npz`` (written by the test
with numpy from a seed), runs each suite named in ``suites`` and writes each
rank's results to ``workdir/<suite>_rank<r>.npz``; the test holds them against
the JAX functions on its virtual CPU mesh or against the single-process port.
Run in a fresh interpreter, it imports neither JAX nor the tests' conftest.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from climsr_tpu_torch.parallel import halo as H
from climsr_tpu_torch.parallel.mesh import (
    broadcast_string,
    create_mesh,
    process_local_slice,
    put_global,
    put_replicated,
)
from climsr_tpu_torch.training.callbacks import ModelPruningCallback


def _t(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _n(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).contiguous().numpy()


def _rows(a: np.ndarray, rank: int, size: int) -> np.ndarray:
    h = a.shape[1] // size
    return a[:, rank * h:(rank + 1) * h]


def suite_halo(inp: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """The halo pads (values and the gradient through the exchange), the
    sharded convs, spatial_sharded_apply(_multi), and the input helpers."""
    rank, size = dist.get_rank(), dist.get_world_size()
    out: Dict[str, np.ndarray] = {}
    for name, fn, halo in (("zero", H.halo_exchange_pad, 2), ("reflect", H._halo_pad_reflect, 3)):
        x = _t(_rows(inp["halo_x"], rank, size)).requires_grad_(True)
        padded = fn(x, halo, mesh, "data")
        probe = _t(_rows(inp[f"halo_probe_{name}"], rank, size))
        (padded * probe).sum().backward()
        out[f"pad_{name}"], out[f"grad_{name}"] = _n(padded), _n(x.grad)
    for k in ("k3", "k5"):
        kernel = torch.from_numpy(inp[f"conv_{k}"].transpose(3, 2, 0, 1).copy())
        out[f"conv_{k}"] = _n(H.sharded_conv2d(_t(_rows(inp["conv_x"], rank, size)), kernel, mesh))
    kernel = torch.from_numpy(inp["apply_k"].transpose(3, 2, 0, 1).copy())

    def sr(x, e=None):
        y = F.interpolate(F.conv2d(x, kernel, padding=1), scale_factor=4, mode="nearest")
        return y if e is None else y + e

    x = _t(_rows(inp["apply_x"], rank, size))
    out["apply"] = _n(H.spatial_sharded_apply(sr, mesh, halo=4, scale=4)(x))
    out["apply_halo0"] = _n(H.spatial_sharded_apply(sr, mesh, halo=0, scale=4)(x))
    e = _t(_rows(inp["apply_e"], rank, size))
    out["apply_multi"] = _n(H.spatial_sharded_apply_multi(sr, mesh, halo=4, scale=4, input_scales=(1, 4))(x, e))
    sl = process_local_slice(8)
    out["local_slice"] = np.asarray([sl.start, sl.stop])
    try:
        process_local_slice(6)
        out["local_slice_guard"] = np.asarray(0)
    except ValueError:
        out["local_slice_guard"] = np.asarray(1)
    out["broadcast"] = np.frombuffer(broadcast_string(f"run-of-rank-{rank}").encode(), np.uint8)
    placed = put_global({"x": np.arange(8), "n": np.float32(3)}, "cpu")
    out["put_global"], out["put_global_scalar"] = placed["x"].numpy(), placed["n"].numpy()
    out["put_replicated"] = put_replicated([np.arange(3)], "cpu")[0].numpy()
    return out


ESRGAN = dict(nf=32, nb=1, gc=16, out_channels=1)
AUGMENT = dict(scale=4, use_elevation=True, use_mask=True)


def stand_in_perceptual(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """A cheap feature distance in place of VGG19, for the GAN steps' share of the perceptual term."""
    return torch.mean(torch.abs(F.avg_pool2d(sr, 2) - F.avg_pool2d(hr, 2)))


def pretrain_run(inp: Dict[str, np.ndarray], stage: int, mesh, steps: int = 3):
    """``steps`` pre-training steps of the seeded ESRGAN on the store and
    index batches of ``inp``: (state, [metrics per step]). ``mesh=None`` is
    the single-process port."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.pretrain import make_pretrain_step
    from climsr_tpu_torch.training.train_state import TrainState

    model = create_generator("esrgan", device="cpu", train=True, generator=torch.Generator().manual_seed(0),
                             **ESRGAN)
    tx = build_optimizer(OptimizerConfig(name="adam", lr=1e-3, eps=1e-3), lambda s: 1e-3, gradient_clip_val=0.05,
                         device="cpu")  # eps: see gan_run
    state = TrainState.create(model, tx, zero_stage=stage, mesh=mesh)
    store = {k: _t(inp[f"store_{k}"]) for k in ("hr", "elevation", "mask")}
    step = make_pretrain_step(model, "esrgan", compute_dtype=torch.float32, augment=AUGMENT, augment_seed=3,
                              store=store, zero=None if mesh is None else {"stage": stage}, device="cpu")
    metrics = []
    for i in range(steps):
        state, m = step(state, inp["indices"][i])
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def gan_run(inp: Dict[str, np.ndarray], stage: int, mesh, steps: int = 2):
    """``steps`` GAN steps (ESRGAN and a 2-block discriminator with BatchNorm,
    Adam, :func:`stand_in_perceptual`) on the global batches of ``inp``."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.models.discriminator import Discriminator
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.gan import make_gan_step
    from climsr_tpu_torch.training.train_state import GANTrainState

    g = create_generator("esrgan", device="cpu", train=True, generator=torch.Generator().manual_seed(0), **ESRGAN)
    with torch.no_grad():
        g.srcnn.conv3.weight.mul_(20.0)  # sr on the targets' scale: see spatial_gan_run
    d = Discriminator(in_channels=1, out_channels=16, num_conv_block=2, hr_size=32,
                      generator=torch.Generator().manual_seed(1)).train()
    # eps 1e-3, as tests/test_torch_gan.py: at 1e-8 Adam's first update moves a
    # weight whose gradient is near zero by a full step of either sign, so
    # the f32 summation order of the gradient (one process, or a sum over
    # ranks) would decide it
    tx = build_optimizer(OptimizerConfig(name="adam", lr=1e-3, eps=1e-3), lambda s: 1e-3, device="cpu")
    state = GANTrainState.create(g, tx, d, tx, zero_stage=stage, mesh=mesh)
    step = make_gan_step(g, d, "esrgan", perceptual_fn=stand_in_perceptual, compute_dtype=torch.float32,
                         zero=None if mesh is None else {"stage": stage}, device="cpu")
    metrics = []
    for i in range(steps):
        batch = {k: _t(inp[f"gan_{k}"][i]) for k in ("lr", "hr", "elevation", "mask")}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def flat_results(prefix: str, metrics: List[Dict[str, float]], models) -> Dict[str, np.ndarray]:
    out = {f"{prefix}/metric/{k}": np.asarray([m[k] for m in metrics]) for k in metrics[0]}
    for tag, model in models:
        out.update({f"{prefix}/{tag}/{k}": v.detach().numpy().copy() for k, v in model.state_dict().items()})
    return out


def suite_zero(inp: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """ZeRO stages 0-3 of the pre-training step, 3 steps each; at stage 3
    also whether any rank holds a full gradient after the step."""
    out: Dict[str, np.ndarray] = {}
    for stage in (0, 1, 2, 3):
        state, metrics = pretrain_run(inp, stage, mesh)
        part = state.partition
        out[f"s{stage}/full_grads"] = np.asarray(sum(p.grad is not None for n, p in part.named if part.is_sharded(n)))
        out[f"s{stage}/sharded"] = np.asarray(sum(part.is_sharded(n) for n, _ in part.named))
        out[f"s{stage}/shard_grad_elems"] = np.asarray(sum(s.grad.numel() for s in part.opt_params))
        if stage == 2:  # the checkpoint's optimizer state: gathered to full shape, and back to the shards
            sharded = state.optimizer.state_dict()
            full = part.full_optimizer_state(sharded)
            back = part.shard_optimizer_state(full)
            out["opt_full_shapes_match"] = np.asarray(all(
                full["state"][i]["exp_avg"].shape == p.shape for i, (_, p) in enumerate(part.named)))
            out["opt_roundtrip_equal"] = np.asarray(all(
                torch.equal(back["state"][i][k], v) for i, st in sharded["state"].items()
                for k, v in st.items() if torch.is_tensor(v)))
        part.materialize()
        out.update(flat_results(f"s{stage}", metrics, [("g", state.model)]))
        part.release()
    return out


EVAL_SIZES = (8, 5, 2)  # a batch that divides the 4 ranks, a ragged one, and one smaller than the world


def eval_run(inp: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The eval step's metrics and the GAN validation losses of the seeded
    ESRGAN and discriminator on the first ``n`` samples of the GAN batch, for
    each ``n`` of :data:`EVAL_SIZES`; across ranks each batch is split over
    them (the Trainer's eval)."""
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.models.discriminator import Discriminator
    from climsr_tpu_torch.training.tasks.gan import make_gan_val_losses
    from climsr_tpu_torch.training.tasks.pretrain import make_eval_step

    g = create_generator("esrgan", device="cpu", generator=torch.Generator().manual_seed(0), **ESRGAN)
    d = Discriminator(in_channels=1, out_channels=16, num_conv_block=2, hr_size=32,
                      generator=torch.Generator().manual_seed(1))
    eval_step = make_eval_step(g, "esrgan", compute_dtype=torch.float32, device="cpu")
    val_losses = make_gan_val_losses(g, d, "esrgan", perceptual_fn=stand_in_perceptual, compute_dtype=torch.float32,
                                     device="cpu")
    full = {k: _t(inp[f"gan_{k}"][0]) for k in ("lr", "hr", "elevation", "mask")}
    full.update(original_data=full["hr"] * 20.0, min=torch.full((8,), -10.0), max=torch.full((8,), 30.0))
    out = {}
    for n in EVAL_SIZES:
        batch = {k: v[:n] for k, v in full.items()}
        for k, v in {**eval_step(batch), **val_losses(batch)}.items():
            out[f"eval{n}/{k}"] = np.asarray(float(v))
    return out


def suite_eval(inp: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    return eval_run(inp)


def d_step_gradient(inp: Dict[str, np.ndarray], mesh) -> np.ndarray:
    """The discriminator's gradient (summed over the ranks) of the
    relativistic D loss on ``bn_hr`` and ``bn_sr``, its BatchNorm statistics
    over the data axis as the GAN step takes them, then its running
    statistics after the two forwards."""
    from climsr_tpu_torch.losses.gan import relativistic_d_loss
    from climsr_tpu_torch.models.common import TorchBatchNorm
    from climsr_tpu_torch.models.discriminator import Discriminator
    from climsr_tpu_torch.parallel.mesh import all_reduce_sum, axis_info

    d = Discriminator(in_channels=1, out_channels=16, num_conv_block=2, hr_size=32,
                      generator=torch.Generator().manual_seed(1)).train()
    hr, sr = _t(inp["bn_hr"]), _t(inp["bn_sr"])
    if mesh is None:
        relativistic_d_loss(d(hr), d(sr)).backward()
    else:
        group, _, size = axis_info(mesh, "data")
        for m in d.modules():
            if isinstance(m, TorchBatchNorm):
                m.process_group = group
        local = process_local_slice(hr.shape[0], mesh)
        relativistic_d_loss(d(hr[local]), d(sr[local]), lambda t: t.sum() / (t.numel() * size),
                            lambda t: all_reduce_sum(t.sum(), group) / (t.numel() * size)).backward()
    g = torch.cat([p.grad.reshape(-1) for p in d.parameters()])
    if mesh is not None:
        dist.all_reduce(g)
    stats = torch.cat([b.reshape(-1).float() for n, b in d.named_buffers() if "running" in n])
    return torch.cat([g, stats]).numpy()


def suite_gan(inp: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """GAN steps at ZeRO stages 0 and 2; the D step's gradient on well-conditioned inputs."""
    out: Dict[str, np.ndarray] = {"d_grad": d_step_gradient(inp, mesh)}
    for stage in (0, 2):
        state, metrics = gan_run(inp, stage, mesh)
        out.update(flat_results(f"gan{stage}", metrics, [("g", state.g_model), ("d", state.d_model)]))
    return out


def _state_dict(inp: Dict[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inp.items() if k.startswith(prefix)}


def suite_spatial(inp: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """On a (1, 4) mesh: the H-sharded ESRGAN forward (a height that does not
    divide) and its parameter gradient; RCAN's channel attention with the
    exact pool, its padded-height case and the local-pool control; a tiny
    RCAN through the sharded forward."""
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.models.rcan import CALayer
    from climsr_tpu_torch.parallel.mesh import axis_info

    out: Dict[str, np.ndarray] = {}
    # ---- ESRGAN through spatial_sharded_model_forward, loss = global mean |sr - hr|
    model = create_generator("esrgan", device="cpu", train=True, **inp_widths(inp, "esr_widths"))
    model.load_state_dict(_state_dict(inp, "esr/"), strict=True)
    fwd = H.spatial_sharded_model_forward(model, "esrgan", mesh, axis="spatial", halo=int(inp["esr_halo"]), scale=4)
    sr, rows = fwd(_t(inp["esr_lr"]), _t(inp["esr_elevation"]), _t(inp["esr_mask"]))
    hr = _t(inp["esr_hr"])
    loss = torch.abs(sr - hr[:, :, rows]).sum() / hr.numel()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    for g in grads.values():
        dist.all_reduce(g)  # the replicated parameters' gradient: the sum over ranks
    out["esr_sr"], out["esr_rows"] = _n(sr), np.asarray([rows.start, rows.stop])
    out.update({f"esr_grad/{n}": g.numpy() for n, g in grads.items()})

    # ---- RCAN channel attention: exact pool, padded height, local-pool control
    axis = axis_info(mesh, "spatial")
    _, rank, size = axis
    halo = 4
    plain = CALayer(8, 4)
    plain.load_state_dict(_state_dict(inp, "ca/"))
    for name, frame, pad in (("exact", inp["ca_x"], 0), ("pad", inp["ca_x_pad"], 3)):
        x = _t(_rows(frame, rank, size))
        padded = H._halo_pad_reflect(x, halo, mesh, "spatial")
        exact = CALayer(8, 4, spatial_axis=axis, spatial_halo=halo, spatial_pad=pad)
        exact.load_state_dict(plain.state_dict())
        with torch.no_grad():
            out[f"ca_{name}"] = _n(exact(padded)[:, :, halo:-halo])
            if name == "exact":
                out["ca_local"] = _n(plain(padded)[:, :, halo:-halo])
    rcan = create_generator("rcan", device="cpu", train=True, n_resgroups=2, n_resblocks=2, n_feats=8, reduction=4,
                            out_channels=1)
    rcan.load_state_dict(_state_dict(inp, "rcan/"), strict=True)
    fwd = H.spatial_sharded_model_forward(rcan, "rcan", mesh, axis="spatial", halo=15, scale=4)
    sr, rows = fwd(_t(inp["rcan_lr"]), _t(inp["rcan_elevation"]), _t(inp["rcan_mask"]))
    sr.sum().backward()
    out["rcan_sr"] = _n(sr)
    out["rcan_grad_finite"] = np.asarray(all(bool(torch.isfinite(p.grad).all()) for p in rcan.parameters()))
    return out


def inp_widths(inp: Dict[str, np.ndarray], key: str) -> Dict[str, int]:
    nf, nb, gc = (int(v) for v in inp[key])
    return dict(nf=nf, nb=nb, gc=gc, out_channels=1)


def suite_inference(inp: Dict[str, np.ndarray], mesh, workdir: str) -> Dict[str, np.ndarray]:
    """``inference_on_full_images(spatial_shard=True)`` over the world (rank 0
    writes the GeoTIFFs under ``workdir/spatial``)."""
    from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images
    from climsr_tpu_torch.models import create_generator

    model = create_generator("esrgan", device="cpu", dtype=torch.float32, **inp_widths(inp, "esr_widths"))
    model.load_state_dict(_state_dict(inp, "esr/"), strict=True)
    files = {k: os.path.join(workdir, str(inp[f"world_{k}"])) for k in ("nc", "elevation_file", "land_mask_file")}
    ds = CRUTSInferenceDataset(ds_path=files["nc"], elevation_file=files["elevation_file"],
                               land_mask_file=files["land_mask_file"], generator_type="esrgan", scaling_factor=4)
    written = inference_on_full_images(model, ds, os.path.join(workdir, "spatial"), "esrgan", batch_size=2,
                                       spatial_shard=True, spatial_halo=32, device="cpu")
    return {"written": np.asarray(len(written))}


SPATIAL_GAN_HALO = 6  # SRCNN's receptive field: 4 + 0 + 2 rows


class EdgeFair(torch.nn.Module):
    """A generator applied to its input reflect-padded by ``halo`` rows at the
    top and bottom, the output cropped back: the unsharded model under the
    sharded path's boundary condition (``scripts/measure_halo_error.py``)."""

    def __init__(self, model: torch.nn.Module, halo: int):
        super().__init__()
        self.model, self.halo = model, halo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.halo
        return self.model(F.pad(x, (0, 0, h, h), mode="reflect"))[:, :, h:-h]


def spatial_gan_run(inp: Dict[str, np.ndarray], mesh, steps: int = 2):
    """``steps`` GAN steps with SRCNN H-sharded over the mesh's spatial axis
    (halo = its receptive field, so the seams are exact); ``mesh=None`` is one
    process with the edge-fair SRCNN."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.models.discriminator import Discriminator
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.gan import make_gan_step
    from climsr_tpu_torch.training.train_state import GANTrainState

    g = create_generator("srcnn", device="cpu", train=True, generator=torch.Generator().manual_seed(0),
                         in_channels=3, out_channels=1)
    with torch.no_grad():
        # sr on the targets' scale: an untrained generator's near-constant
        # output leaves channels of D's first BatchNorm with a batch variance
        # (~7e-9) under its eps (1e-5), where x - mean cancels to ~1e-4 of
        # |mean| and any two f32 summation orders of the statistics (one
        # process, or a sum over ranks) part D's gradients by ~0.2%
        g.conv3.weight.mul_(20.0)
    d = Discriminator(in_channels=1, out_channels=16, num_conv_block=2, hr_size=32,
                      generator=torch.Generator().manual_seed(1)).train()
    tx = build_optimizer(OptimizerConfig(name="adam", lr=1e-3, eps=1e-3), lambda s: 1e-3, device="cpu")
    state = GANTrainState.create(g, tx, d, tx, mesh=mesh)
    model = g if mesh is not None else EdgeFair(g, SPATIAL_GAN_HALO)
    spatial = None if mesh is None else {"mesh": mesh, "axis": "spatial", "halo": SPATIAL_GAN_HALO, "scale": 4}
    step = make_gan_step(model, d, "srcnn", perceptual_fn=stand_in_perceptual, compute_dtype=torch.float32,
                         spatial=spatial, zero=None if mesh is None else {"stage": 0}, device="cpu")
    if mesh is None:
        state.g_model = model
    metrics = []
    for i in range(steps):
        batch = {k: _t(inp[f"sgan_{k}"][i]) for k in ("lr", "hr")}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def suite_spatial_gan(inp: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """The spatial GAN step on a (2, 2) mesh: 2 frames a data rank, 16 rows a spatial rank."""
    mesh22 = create_mesh(axes=("data", "spatial"), last_axis_size=2)
    state, metrics = spatial_gan_run(inp, mesh22)
    return flat_results("sgan", metrics, [("g", state.g_model), ("d", state.d_model)])


TRAIN_OVERRIDES = [
    "experiment=esrgan_pre_training", "generator.nf=32", "generator.nb=1", "generator.gc=16",
    "training.batch_size=4", "training.validation_batch_size=4", "training.num_workers=1",
    "trainer.max_epochs=2", "trainer.log_every_n_steps=1", "trainer.precision=fp32", "trainer.save_top_k=1",
    "trainer.limit_test_batches=1", "logger=csv", "print_config=false",
]


def suite_trainer(inp: Dict[str, np.ndarray], mesh, workdir: str) -> Dict[str, np.ndarray]:
    """``cli.train`` inside the group: ZeRO-3 data parallel, a resume of it
    for one more epoch, then ``plugins=spatial_shard`` (halo 4: a 32-row LR
    tile over 4 ranks)."""
    import glob

    from climsr_tpu_torch.cli.train import main

    base = TRAIN_OVERRIDES + [f"datamodule.cfg.data_path={workdir}/ds", "trainer.num_devices=4"]
    main(base + ["trainer.zero_stage=3", f"training.output_dir={workdir}/zero"], device="cpu")
    dist.barrier()  # rank 0 has written the checkpoints
    (run,) = glob.glob(f"{workdir}/zero/outputs/runs/esrgan/*")
    main(base + ["trainer.zero_stage=3", "trainer.max_epochs=3", f"trainer.resume_from_checkpoint={run}/checkpoints",
                 f"training.output_dir={workdir}/resumed"], device="cpu")
    main(base + ["plugins=spatial_shard", "trainer.spatial_shard_halo=4", f"training.output_dir={workdir}/spatial"],
         device="cpu")
    return {}


def full_state(trainer) -> Dict[str, torch.Tensor]:
    """The generator's full parameters, gathered under ZeRO-3, as CPU copies;
    read only (the shards are left as they are)."""
    with trainer._materialized([trainer.generator_partition]):
        return {k: v.detach().cpu().clone() for k, v in trainer.g_model.named_parameters()}


def pruned_are_zero(masks: Dict[str, np.ndarray], full: Dict[str, torch.Tensor], part) -> Tuple[bool, bool]:
    """Whether every position ``masks`` prunes is 0 in the full parameters,
    and in this rank's shards (the optimizer's leaves)."""
    def zero(t, m):
        return bool((t.detach().cpu()[~m] == 0).all())

    in_full = all(zero(full[k], torch.from_numpy(m)) for k, m in masks.items())
    in_shards = part is None or all(zero(part.shards[k], part.shard_of(k, torch.from_numpy(m)))
                                    for k, m in masks.items())
    return in_full, in_shards


class RecordedPruning(ModelPruningCallback):
    """``ModelPruningCallback`` that records, at fit start and at each
    train-epoch end, the generator's full parameters before and after the
    pruning, the masks, and whether the positions pruned at the epoch before
    were still 0 after this epoch's steps (in the full weights and in the
    shards), into ``record``."""

    def __init__(self, record: List, use_lottery_ticket_hypothesis: bool = False):
        super().__init__(use_lottery_ticket_hypothesis=use_lottery_ticket_hypothesis)
        self.record = record

    def on_fit_start(self, trainer) -> None:
        super().on_fit_start(trainer)
        self.record.append({"start": full_state(trainer)})

    def on_train_epoch_end(self, trainer, epoch: int) -> None:
        part = trainer.generator_partition
        before = full_state(trainer)
        kept = pruned_are_zero(self._masks, before, part) if self._masks else (True, True)
        super().on_train_epoch_end(trainer, epoch)
        after = full_state(trainer)
        self.record.append(dict(before=before, after=after, masks=dict(self._masks), kept=kept,
                                pruned=pruned_are_zero(self._masks, after, part), sparsity=self.sparsity))


PRUNING_OVERRIDES = TRAIN_OVERRIDES + ["trainer.limit_train_batches=1", "trainer.save_top_k=0",
                                       "training.run_test_after_fit=false"]


@contextlib.contextmanager
def recorded_pruning(record: List) -> Iterator[None]:
    """In the block, ``callbacks=[model_pruning]`` and ``[lottery_ticket]``
    build a :class:`RecordedPruning` that records into ``record``."""
    from climsr_tpu_torch.training import callbacks

    kept = dict(callbacks.CALLBACK_REGISTRY)
    callbacks.CALLBACK_REGISTRY.update(model_pruning=lambda: RecordedPruning(record),
                                       lottery_ticket=lambda: RecordedPruning(record, True))
    try:
        yield
    finally:
        callbacks.CALLBACK_REGISTRY.update(kept)


def pruning_fit(data_path: str, out: str, lottery: bool, extra: List[str] = ()) -> Tuple[List[dict], str]:
    """``cli.train`` on the CPU with ``callbacks=[model_pruning]`` (or
    ``[lottery_ticket]``) over :data:`PRUNING_OVERRIDES`, the callback
    recording (:class:`RecordedPruning`): (the record, the run directory)."""
    import glob

    from climsr_tpu_torch.cli.train import main

    name = "lottery_ticket" if lottery else "model_pruning"
    record: List[dict] = []
    with recorded_pruning(record):
        main(["--device=cpu", *PRUNING_OVERRIDES, f"datamodule.cfg.data_path={data_path}", f"callbacks=[{name}]",
              f"training.output_dir={out}", *extra])
    (run,) = glob.glob(f"{out}/outputs/runs/esrgan/*")
    return record, run


def digest(arrays) -> str:
    """A sha1 of the arrays' bytes, in order: whether ranks hold the same."""
    return hashlib.sha1(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()


def pruning_results(tag: str, record: List[dict], full: bool) -> Dict[str, np.ndarray]:
    """A pruning record as arrays under ``tag/``: the masks, checks and
    sparsity of each epoch, a digest of the weights each pruning read, and
    with ``full`` the weights themselves."""
    out: Dict[str, np.ndarray] = {}
    if full:
        out.update({f"{tag}/start/{k}": v.numpy() for k, v in record[0]["start"].items()})
    for e, r in enumerate(record[1:]):
        p = f"{tag}/e{e}"
        out.update({f"{p}/mask/{k}": m for k, m in r["masks"].items()})
        out.update({f"{p}/digest": np.asarray(digest(v.numpy() for v in r["before"].values())),
                    f"{p}/kept": np.asarray(r["kept"]),
                    f"{p}/pruned": np.asarray(r["pruned"]), f"{p}/sparsity": np.asarray(r["sparsity"])})
        if full:
            out.update({f"{p}/before/{k}": v.numpy() for k, v in r["before"].items()})
            out.update({f"{p}/after/{k}": v.numpy() for k, v in r["after"].items()})
    return out


PROBE_LOCAL_CAPACITY = 3  # the stand-in probe: a rank's slice fits up to 3 samples


def stand_in_fits(calls: List):
    """A ``batch_probe.fits`` stand-in for a device without memory statistics:
    it runs the step on zero batches of a rank's slice of the global batch,
    ``ceil(bs / shards)``, as ``fits`` does (where a step is given), and that
    slice fits where it holds at most :data:`PROBE_LOCAL_CAPACITY` samples;
    each call is kept in ``calls``."""
    def fits(step_fn, state, batch_template, bs, headroom, shards=1, reserve_bytes=0, trials=None):
        local = -(-bs // shards)
        calls.append((bs, shards, headroom))
        if step_fn is not None:
            step_fn(state, {k: torch.zeros((local,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
                            for k, v in batch_template.items()})
        return local <= PROBE_LOCAL_CAPACITY, 2 * local

    return fits


def suite_zero_services(inp: Dict[str, np.ndarray], mesh, workdir: str) -> Dict[str, np.ndarray]:
    """The Trainer's model-changing callbacks under ZeRO 1-3 and its batch
    probe over the ranks, through ``cli.train``: ``model_pruning`` and
    ``lottery_ticket`` at each stage (:func:`pruning_fit`; rank 0 keeps the
    weights, every rank its masks and checks), then
    ``trainer.auto_scale_batch_size`` in each mode with :func:`stand_in_fits`
    for the trials (the batch each rank ends with, and its calls)."""
    from climsr_tpu_torch.cli.train import main
    from climsr_tpu_torch.training import batch_probe, loop

    rank = dist.get_rank()
    data = f"{workdir}/ds"
    out: Dict[str, np.ndarray] = {}
    for stage in (1, 2, 3):
        for lottery in (False, True):
            tag = f"s{stage}{'lottery' if lottery else 'pruning'}"
            record, run = pruning_fit(data, f"{workdir}/{tag}", lottery,
                                      ["trainer.num_devices=4", f"trainer.zero_stage={stage}"])
            out.update(pruning_results(tag, record, full=rank == 0))
            out[f"{tag}/run"] = np.asarray(run)
    calls: List = []
    kept = batch_probe.fits
    batch_probe.fits = stand_in_fits(calls)
    chosen = []
    init = loop.Trainer.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        chosen.append(self.dm.cfg.batch_size)

    loop.Trainer.__init__ = keep
    try:
        for mode in ("power", "binsearch"):
            del calls[:]
            main(["--device=cpu", *TRAIN_OVERRIDES, f"datamodule.cfg.data_path={data}", "trainer.num_devices=4",
                  f"trainer.auto_scale_batch_size={mode}", "training.run_fit=false",
                  "training.run_test_after_fit=false", f"training.output_dir={workdir}/probe_{mode}"])
            out[f"probe_{mode}/batch"] = np.asarray(chosen[-1])
            out[f"probe_{mode}/calls"] = np.asarray(calls, dtype=np.float64).reshape(-1, 3)
    finally:
        batch_probe.fits = kept
        loop.Trainer.__init__ = init
    return out


SUITES = {"halo": suite_halo, "zero": suite_zero, "gan": suite_gan, "eval": suite_eval, "spatial": suite_spatial,
          "spatial_gan": suite_spatial_gan}
WITH_WORKDIR = {"inference": suite_inference, "trainer": suite_trainer, "zero_services": suite_zero_services}


def main(workdir: str, suites: List[str], axes: List[str] = ("data",), last_axis_size: int = None) -> None:
    torch.set_num_threads(1)
    torch.manual_seed(0)
    rank = dist.get_rank()
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    mesh = create_mesh(axes=tuple(axes), last_axis_size=last_axis_size)
    for name in suites:
        out = WITH_WORKDIR[name](inp, mesh, workdir) if name in WITH_WORKDIR else SUITES[name](inp, mesh)
        np.savez(os.path.join(workdir, f"{name}_rank{rank}.npz"), **out)
