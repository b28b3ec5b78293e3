# -*- coding: utf-8 -*-
"""Device-side train-time augmentation + LR synthesis on NCHW tensors: the
port of ``climsr_tpu.ops.augment``.

Replaces the reference's per-sample host augmentation
(``climate_dataset.py:144-189``: albumentations flips/rot90 + cv2 nearest
decimation in DataLoader workers) with batched tensor ops inside the train step:

- the same distribution: v-flip w.p. 0.5, h-flip w.p. 0.5, then with p=0.5 a
  uniform 0-3x 90° rotation; the *same* transform applies to HR/elev/mask,
- LR = top-left decimation of the augmented HR (exactly cv2.INTER_NEAREST for
  integer factors, see ops/resize.py),
- per-generator channel assembly (srcnn gets the nearest-upscaled LR at HR
  size; others get the true LR with LR-decimated elev/mask channels).

The draws come from a ``torch.Generator`` on the batch's device
(:func:`step_generator` seeds it from ``(seed, step)``, as the JAX step folds
the step into its key). They are not JAX's PRNG draws, so the parity tests
pass explicit flags (:func:`apply_flips_rot`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.ops.resize import nearest_downsample, nearest_upsample

B = consts.batch_items

Flags = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # vflip (bool), hflip (bool), rot k (int) per sample


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``."""
    state = np.random.SeedSequence((int(seed), int(step))).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def draw_flags(n: int, generator: torch.Generator, v_flip: bool = True, h_flip: bool = True,
               random_90_rotation: bool = True) -> Flags:
    """Per-sample (vflip, hflip, k) on the generator's device, each draw p=0.5
    and k uniform in 0..3 (the reference's inclusive ``random.randint(0, 3)``)."""
    dev = generator.device
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    vflips = torch.rand(n, generator=generator, device=dev) < 0.5 if v_flip else false
    hflips = torch.rand(n, generator=generator, device=dev) < 0.5 if h_flip else false
    do_rot = torch.rand(n, generator=generator, device=dev) < 0.5 if random_90_rotation else false
    ks = torch.randint(0, 4, (n,), generator=generator, device=dev)
    return vflips, hflips, torch.where(do_rot, ks, torch.zeros_like(ks))


def apply_flips_rot(x: torch.Tensor, flags: Flags) -> torch.Tensor:
    """(N, C, H, W) with square frames: per sample, flip rows if vflip, then
    columns if hflip, then ``np.rot90`` by k (counter-clockwise)."""
    vflip, hflip, k = flags

    def pick(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(cond.view(-1, 1, 1, 1), a, b)

    x = pick(vflip, x.flip(-2), x)
    x = pick(hflip, x.flip(-1), x)
    out = x
    for kk in (1, 2, 3):
        out = pick(k == kk, torch.rot90(x, kk, dims=(-2, -1)), out)
    return out


def random_augment(hr: torch.Tensor, elev: torch.Tensor, mask: torch.Tensor, generator: torch.Generator,
                   v_flip: bool = True, h_flip: bool = True, random_90_rotation: bool = True,
                   flags: Optional[Flags] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched random flips/rot90, the same transform per sample across the
    three rasters. ``flags`` replaces the draws."""
    if flags is None:
        flags = draw_flags(hr.shape[0], generator, v_flip, h_flip, random_90_rotation)
    return apply_flips_rot(hr, flags), apply_flips_rot(elev, flags), apply_flips_rot(mask, flags)


def assemble_train_inputs(
    hr: torch.Tensor,
    elev: torch.Tensor,
    mask: torch.Tensor,
    generator_type: str,
    scale: int = 4,
    use_elevation: bool = True,
    use_mask: bool = True,
) -> torch.Tensor:
    """LR-input channel stack from augmented HR rasters (climate_dataset.py:94-120)."""
    lr = nearest_downsample(hr, scale)
    if generator_type == consts.models.srcnn:
        parts = [nearest_upsample(lr, scale)] + [elev] * use_elevation + [mask] * use_mask
    else:
        parts = ([lr] + [nearest_downsample(elev, scale)] * use_elevation
                 + [nearest_downsample(mask, scale)] * use_mask)
    return torch.cat(parts, dim=1)


def augment_and_assemble(
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    generator_type: str,
    scale: int = 4,
    use_elevation: bool = True,
    use_mask: bool = True,
    v_flip: bool = True,
    h_flip: bool = True,
    random_90_rotation: bool = True,
    flags: Optional[Flags] = None,
) -> Dict[str, torch.Tensor]:
    """Raw {hr, elevation, mask} tiles -> full train batch {lr, hr, elevation, mask}."""
    hr, elev, mask = random_augment(batch[B.hr], batch[B.elevation], batch[B.mask], generator,
                                    v_flip, h_flip, random_90_rotation, flags)
    lr = assemble_train_inputs(hr, elev, mask, generator_type, scale, use_elevation, use_mask)
    return {B.lr: lr, B.hr: hr, B.elevation: elev, B.mask: mask}
