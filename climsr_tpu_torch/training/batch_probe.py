# -*- coding: utf-8 -*-
"""auto_scale_batch_size: the largest batch whose train step fits the card.

The port of ``climsr_tpu.training.batch_probe``. The search
(:func:`probe_max_batch_size`: ``'power'`` / True doubles until a trial no
longer fits; ``'binsearch'`` then bisects between the last fit and the first
failure; a configured batch that does not fit is halved until one does) is
the JAX module's, copied as it is.

The trial (:func:`fits`) differs. XLA gives the JAX probe the memory plan of
a compiled step before anything runs; CUDA has no such plan, and unlike a
TPU it recovers from an out-of-memory error. So a trial is the reference's
own PL-Tuner semantics: one real train step on zero batches of the trial's
size, whose peak allocated bytes (``torch.cuda.max_memory_allocated`` from a
reset just before it, less what was allocated before it) are held against
``headroom`` of the card's memory, beside what was allocated before and the
``reserve_bytes`` the caller will add afterwards (the Trainer's device tile
store). ``torch.cuda.OutOfMemoryError`` is "does not fit", and so is an
error that says the batch is past a size limit (as the JAX probe takes a
compile error about memory or resources; PyTorch's NHWC nearest upsample
refuses gradients of 2^31 elements or more, but ESRGAN's head runs it only
with ``fused_upsample=False``: the phase form builds no nearest-x2 tensor, and
on an 80 GB H100 the flagship's binsearch stops at 2688 tiles on memory,
2880 needing more than the headroom). Each trial's
tensors are freed and the allocator's cache emptied before the next. On the
CPU ``fits`` returns None and the configured batch is kept, as the JAX probe
does on a backend without memory statistics.
"""
from __future__ import annotations

import gc
import logging
from typing import Callable, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

# words of an error that says the trial's batch is past a size limit (JAX's
# "memory", "resource", "exceeds", and PyTorch's 32-bit index limits)
_TOO_BIG = ("memory", "resource", "exceeds", "int_max")

# the reference's PL tuner default is max_trials=25 (2^25x the start batch),
# absurd for climate tiles: 8 doublings = 256x is plenty
MAX_TRIALS = 8


def fits(
    step_fn: Callable,
    state,
    batch_template: Dict[str, torch.Tensor],
    bs: int,
    headroom: float,
    shards: int = 1,
    reserve_bytes: int = 0,
    trials: Optional[List[Dict]] = None,
) -> Optional[Tuple[bool, int]]:
    """Run ``step_fn(state, batch)`` once on zero batches of ``ceil(bs /
    shards)`` (the per-device slice of a global batch) shaped and typed as
    ``batch_template`` beyond its leading dimension, on the template's device.

    Returns (fits, the step's peak bytes above what was allocated before it),
    or None on a device without memory statistics (the CPU). ``trials``, if
    given, gets one dict per trial (bs, peak_bytes, fits, oom, and the
    size-limit error's text or None).
    """
    dev = next(iter(batch_template.values())).device
    if dev.type != "cuda":
        return None
    local_bs = -(-bs // max(1, shards))
    total = torch.cuda.get_device_properties(dev).total_memory
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    batch = None
    oom, limit = False, None
    try:
        batch = {k: torch.zeros((local_bs,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
                 for k, v in batch_template.items()}
        step_fn(state, batch)
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError:
        oom = True
    except (RuntimeError, ValueError) as e:
        if not any(word in str(e).lower() for word in _TOO_BIG):
            raise
        limit = str(e).splitlines()[0]
    peak = torch.cuda.max_memory_allocated(dev) - before
    del batch
    opt = getattr(state, "optimizer", None)
    if opt is not None:  # gradients a failed step left behind
        opt.zero_grad()
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    ok = not oom and limit is None and before + peak + reserve_bytes <= headroom * total
    if trials is not None:
        trials.append(dict(bs=bs, peak_bytes=int(peak), fits=ok, oom=oom, limit=limit))
    logger.info("auto_scale_batch_size: batch %d %s (step peak %.3f GB%s, limit %.3f GB of %.3f)", bs,
                "fits" if ok else "does not fit", peak / 1e9,
                ", out of memory" if oom else f", {limit}" if limit else "",
                (headroom * total - before - reserve_bytes) / 1e9, total / 1e9)
    return ok, int(peak)


def probe_max_batch_size(
    step_fn: Callable,
    state,
    batch_template: Dict,
    start: int,
    mode: str = "power",
    headroom: float = 0.9,
    max_trials: int = MAX_TRIALS,
    shards: int = 1,
    _fits: Optional[Callable] = None,
) -> int:
    """Largest GLOBAL batch size whose per-device step fits the device.

    ``batch_template``: one real batch; only shapes beyond the leading batch
    dim, dtypes and the device are read. ``shards`` is the data-parallel
    factor (see :func:`fits`). ``_fits`` overrides the probe predicate (the
    Trainer passes one that reserves its store; tests script one). Returns
    ``start`` unchanged when the device reports no memory statistics.
    """
    check = _fits or (lambda bs: fits(step_fn, state, batch_template, bs, headroom, shards))
    first = check(start)
    if first is None:
        logger.warning(
            "auto_scale_batch_size: backend reports no memory stats; keeping batch_size=%d",
            start,
        )
        return start
    ok, plan = first
    if not ok:
        # configured batch already over budget: halve until it fits
        bs = start
        while bs > 1:
            bs //= 2
            res = check(bs)
            if res is None:
                return start
            if res[0]:
                logger.warning(
                    "auto_scale_batch_size: configured batch_size=%d does not fit; scaled DOWN to %d",
                    start, bs,
                )
                return bs
        raise ValueError(f"auto_scale_batch_size: even batch_size=1 exceeds device memory (start={start})")

    good, bad = start, None
    bs = start
    for _ in range(max_trials):
        bs *= 2
        res = check(bs)
        if res is None:
            return good
        if res[0]:
            good = bs
        else:
            bad = bs
            break
    if mode == "binsearch" and bad is not None:
        lo, hi = good, bad
        while hi - lo > max(1, lo // 8):  # ~12% resolution, bounded trials
            mid = (lo + hi) // 2
            res = check(mid)
            if res is None:
                break
            if res[0]:
                lo = mid
            else:
                hi = mid
        good = lo
    logger.info("auto_scale_batch_size: selected batch_size=%d (started at %d)", good, start)
    return good
