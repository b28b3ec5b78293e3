# -*- coding: utf-8 -*-
"""Learning-rate range test (the reference's ``auto_lr_find``/``lr_find_only``):
the port of ``climsr_tpu.training.lr_finder``.

The JAX procedure as it is: sweep the LR exponentially from ``min_lr`` to
``max_lr`` over ``num_steps`` training steps of plain SGD (the gradient times
lr_t applied to a copy of the trainer's generator), record the loss, stop on
a non-finite loss or when the bias-corrected smoothed loss passes 4x its
minimum, and suggest the LR at the steepest descent of the smoothed curve
(``np.gradient`` over log10 lr, the argmin with 2 points trimmed at each
end). Writes ``lr_find.csv`` into the workdir, and ``lr_find.png`` when
matplotlib imports.

On the card each step runs the generator's kernels (for ESRGAN: B1 and B2 in
every RDB, C in the fusion head). Batches come from the trainer's device tile
store when it has one, else from its loader through ``device_prefetch``;
with device augmentation every step uses the draw of step 0, as JAX uses
``PRNGKey(0)`` for every step.
"""
from __future__ import annotations

import copy
import logging
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from climsr_tpu_torch.data.pipeline import VALID_KEY, device_prefetch, gather

logger = logging.getLogger(__name__)


def lr_range_test(
    trainer,
    min_lr: float = 1e-7,
    max_lr: float = 1.0,
    num_steps: int = 100,
    smooth_beta: float = 0.98,
) -> Tuple[float, Dict[str, List[float]]]:
    """Run the sweep on a copy of the trainer's generator; returns (suggestion, history)."""
    import climsr_tpu_torch.consts as consts
    from climsr_tpu_torch.models import apply_generator_batch
    from climsr_tpu_torch.ops.augment import augment_and_assemble, step_generator
    from climsr_tpu_torch.training.tasks.pretrain import pixel_loss_fn

    B = consts.batch_items
    gen_type = trainer.generator_type
    loss_fn = pixel_loss_fn(gen_type)
    model = copy.deepcopy(trainer.g_model)
    params = [p for p in model.parameters() if p.requires_grad]
    device = trainer.device

    gamma = math.exp(math.log(max_lr / min_lr) / max(1, num_steps - 1))
    augment_kwargs = getattr(trainer, "_augment_kwargs", None)

    def step(batch, lr: float) -> torch.Tensor:
        if augment_kwargs is not None:
            batch = augment_and_assemble(batch, step_generator(0, 0, batch[B.hr].device), gen_type,
                                         **augment_kwargs)
        for p in params:
            p.grad = None
        sr = apply_generator_batch(gen_type, model, batch, trainer.compute_dtype)
        loss = loss_fn(sr.float(), batch[B.hr].to(device=sr.device, dtype=torch.float32))
        loss.backward()
        with torch.no_grad():  # optax.sgd(1.0) on the gradients times lr
            live = [p for p in params if p.grad is not None]
            torch._foreach_add_(live, [p.grad for p in live], alpha=-lr)
        return loss.detach()

    lrs: List[float] = []
    losses: List[float] = []
    smoothed: List[float] = []
    avg = 0.0
    lr = min_lr

    def cycling_batches():
        epoch = 0
        store = getattr(trainer, "train_store", None)
        while True:
            trainer.train_loader.set_epoch(epoch)
            if store is not None:
                where = next(iter(store.values())).device
                for idx in trainer.train_loader:
                    yield gather(store, torch.as_tensor(idx, dtype=torch.int64).to(where))
            else:
                yield from device_prefetch(iter(trainer.train_loader), device)
            epoch += 1

    i = 0
    for batch in cycling_batches():
        if i >= num_steps:
            break
        batch.pop(VALID_KEY, None)
        loss = float(step(batch, lr))
        if not np.isfinite(loss):
            logger.info("LR finder stopping at lr=%.3g (non-finite loss)", lr)
            break
        avg = smooth_beta * avg + (1 - smooth_beta) * loss
        corrected = avg / (1 - smooth_beta ** (i + 1))
        if smoothed and corrected > 4 * min(smoothed):
            logger.info("LR finder stopping at lr=%.3g (loss diverged)", lr)
            break
        lrs.append(lr)
        losses.append(loss)
        smoothed.append(corrected)
        lr *= gamma
        i += 1

    suggestion = suggest(lrs, smoothed, min_lr)
    history = {"lr": lrs, "loss": losses, "smoothed": smoothed}
    _save_outputs(trainer.workdir, history, suggestion)
    logger.info("LR finder suggestion: %.3g", suggestion)
    return suggestion, history


def suggest(lrs: List[float], smoothed: List[float], min_lr: float) -> float:
    """The LR at the smoothed loss's steepest descent over log10 lr, skipping
    the first 2 and last 2 noisy points; ``min_lr`` with fewer than 5 points."""
    if len(smoothed) < 5:
        return min_lr
    log_lrs = np.log10(lrs)
    grads = np.gradient(np.asarray(smoothed), log_lrs)
    lo, hi = 2, max(3, len(grads) - 2)
    return float(lrs[lo + int(np.argmin(grads[lo:hi]))])


def _save_outputs(workdir, history: Dict[str, List[float]], suggestion: float) -> None:
    import csv

    workdir = Path(workdir)
    with open(workdir / "lr_find.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["lr", "loss", "smoothed"])
        for row in zip(history["lr"], history["loss"], history["smoothed"]):
            writer.writerow(row)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(history["lr"], history["smoothed"])
        ax.set_xscale("log")
        ax.axvline(suggestion, color="r", linestyle="--", label=f"suggestion {suggestion:.2g}")
        ax.set_xlabel("learning rate")
        ax.set_ylabel("smoothed loss")
        ax.legend()
        fig.savefig(workdir / "lr_find.png", bbox_inches="tight")
        plt.close(fig)
    except Exception:  # plotting is best-effort, as in JAX (matplotlib may be missing)
        pass
