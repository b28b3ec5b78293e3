# -*- coding: utf-8 -*-
"""Typed config dataclasses: the port of ``climsr_tpu/config/schemas.py``.

The same groups, field names and defaults as the JAX schemas (reference
``climsr/core/config.py``), and the same :func:`from_dict` and
:func:`infer_generator_config`. One check the JAX package leaves to the
inference run is made here: ``InferenceConfig.readback`` must be "pack12" or
"f16" (``__post_init__``, so ``from_dict`` raises too).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.data import normalization

MISSING = "???"

# the tiled inference path's readback encodings (inference/run.py)
READBACKS = ("pack12", "f16")


def _default_resolution_list() -> List[str]:
    return [consts.world_clim.resolution_5m, consts.world_clim.resolution_2_5m]


# keys legitimately present in composed group dicts that are not dataclass
# fields (reference-parity plumbing, not typos)
_FROM_DICT_PASSTHROUGH = {"_target_", "defaults", "name"}


def from_dict(cls, data: Optional[Dict[str, Any]], warn_unknown: bool = True):
    """Build dataclass ``cls`` from a (possibly over-complete) dict, recursively.

    Unknown keys are dropped — but WARNED about (``warn_unknown``), because a
    silently-ignored key is how a misspelled CLI override (``trainer.max_stepz=7``)
    turns into a full training run on defaults. Hydra's struct mode errors here;
    a loud warning keeps the free-form groups (callbacks, logger) usable."""
    if data is None:
        return None
    fields = {f.name: f for f in dataclasses.fields(cls)}
    if warn_unknown:
        unknown = [k for k in data if k not in fields and k not in _FROM_DICT_PASSTHROUGH]
        if unknown:
            import logging

            logging.getLogger(__name__).warning(
                "%s: ignoring unknown config key(s) %s — misspelled override?",
                cls.__name__, ", ".join(sorted(unknown)),
            )
    kwargs = {}
    for name, f in fields.items():
        if name not in data:
            continue
        value = data[name]
        sub = _nested_dataclass(f.type)
        if sub is not None and isinstance(value, dict):
            value = from_dict(sub, value)
        elif isinstance(value, list) and f.type in ("Tuple[int, int]", "Tuple[float, float]"):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


def _nested_dataclass(type_str: Any):
    mapping = {
        "TransformsCfg": TransformsCfg,
        "Optional[TransformsCfg]": TransformsCfg,
    }
    return mapping.get(type_str if isinstance(type_str, str) else getattr(type_str, "__name__", None))


@dataclass
class DataDownloadConfig:
    download_path: str = "./datasets"
    parallel_downloads: int = 8


@dataclass
class PreProcessingConfig:
    data_dir_cruts: str = MISSING
    data_dir_world_clim: str = MISSING
    output_path: str = MISSING

    world_clim_elevation_fp: str = MISSING
    elevation_file: str = MISSING
    land_mask_file: str = MISSING

    run_cruts_to_tiff: bool = False
    run_tavg_rasters_generation: bool = False
    run_statistics_computation: bool = False
    run_world_clim_resize: bool = False
    run_world_clim_tiling: bool = False
    run_train_val_test_split: bool = True
    run_extent_extraction: bool = False
    run_z_score_stats_computation: bool = False
    run_min_max_stats_computation: bool = False

    patch_size: Tuple[int, int] = (128, 128)
    patch_stride: int = 64
    n_workers: int = 8
    threads_per_worker: int = 1

    train_years: Tuple[int, int] = (1961, 1999)
    val_years: Tuple[int, int] = (2000, 2005)
    test_years: Tuple[int, int] = (2006, 2020)


@dataclass
class TransformsCfg:
    v_flip: bool = True
    h_flip: bool = True
    random_90_rotation: bool = True


@dataclass
class SuperResolutionDataConfig:
    data_path: str = MISSING
    europe_extent: bool = False
    world_clim_variable: str = consts.world_clim.temp
    generator_type: str = consts.models.rcan
    resolutions: List[str] = field(default_factory=_default_resolution_list)
    batch_size: int = 192
    validation_batch_size: int = 192
    num_workers: int = 8
    scale_factor: int = 4
    seed: int = 42
    normalization_method: str = normalization.minmax
    normalization_range: Tuple[float, float] = (-1.0, 1.0)
    pin_memory: bool = False  # accepted for config parity; prefetch is always pinned
    use_elevation: bool = True
    use_mask: bool = True
    use_global_min_max: bool = True
    use_extra_data: bool = False
    transforms: Optional[TransformsCfg] = field(default_factory=TransformsCfg)


@dataclass
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 1e-3
    weight_decay: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    momentum: float = 0.0  # sgd/rmsprop


@dataclass
class SchedulerConfig:
    name: str = "one_cycle_schedule"
    num_training_steps: int = -1
    num_warmup_steps: float = 0.1
    # cosine / hard-restarts
    num_cycles: float = 0.5
    # one-cycle (torch OneCycleLR parity)
    max_lr: Optional[float] = None
    pct_start: float = 0.05
    div_factor: float = 2.0
    final_div_factor: float = 100.0
    # torch OneCycleLR momentum co-cycle (defaults match torch: ON, 0.85/0.95);
    # for Adam this cycles beta1 inversely to the lr
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    # polynomial
    power: float = 1.0
    lr_end: float = 1e-7


@dataclass
class TrainerConfig:
    """The JAX package's trainer knobs, with its names and defaults.

    The devices are the ranks of the ``torch.distributed`` world, one per
    rank: ``num_devices`` must be its size (``cli.train`` starts that many
    ranks where no group is initialized), ``mesh_axes``, ``zero_stage`` /
    ``shard_optimizer_state`` and ``spatial_shard_size`` / ``spatial_shard_halo``
    shape the Trainer's mesh as in the JAX package. ``remat`` is taken for
    parity and changes nothing.
    """

    max_epochs: int = 1
    max_steps: Optional[int] = None
    limit_train_batches: Optional[float] = None
    limit_val_batches: Optional[float] = None
    limit_test_batches: Optional[float] = None
    check_val_every_n_epoch: int = 1
    log_every_n_steps: int = 50
    accumulate_grad_batches: int = 1
    gradient_clip_val: float = 0.0
    precision: str = "bf16"  # "bf16" (bf16 compute, f32 parameters) or "fp32"
    seed: int = 42
    deterministic: bool = False
    fast_dev_run: bool = False

    # devices and sharding: the ranks of the torch.distributed world (see the docstring)
    num_devices: Optional[int] = None  # None = all visible
    mesh_axes: Tuple[str, ...] = ("data",)
    shard_optimizer_state: bool = False
    zero_stage: Optional[int] = None
    spatial_shard_size: int = 0
    spatial_shard_halo: int = 8  # LR rows of context exchanged per neighbor
    remat: bool = False
    auto_scale_batch_size: Any = False
    # flips/rot90 + LR synthesis inside the train step (ops/augment.py); the
    # host then only ships raw normalized tiles
    device_augment: bool = True
    # keep the whole train tile store on the device and gather batches there
    # ("auto": when the store fits device_store_max_bytes)
    device_resident_data: Any = "auto"
    device_store_max_bytes: int = 6_000_000_000

    # checkpointing / resume
    default_root_dir: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None
    save_top_k: int = 100
    early_stopping_patience: Optional[int] = 100
    terminate_on_nan: bool = False

    # profiler: None | "simple" (stage-time table) | "jax" (the fit's
    # torch.profiler Chrome trace under profiler_dir) | "advanced"/"pytorch"
    # (stage table + a table of self device time by op over epoch 0)
    profiler: Optional[str] = None
    profiler_dir: str = "profiles"


@dataclass
class GeneratorConfig:
    name: str = MISSING
    in_channels: int = 3
    out_channels: int = 1
    scaling_factor: int = 4
    # family-specific knobs (ignored by families that don't use them)
    nf: int = 64
    nb: int = 23
    gc: int = 32
    n_resgroups: int = 10
    n_resblocks: int = 20
    n_feats: int = 64
    reduction: int = 16
    num_rrdb_blocks: int = 16
    num_rrfdb_blocks: int = 8
    # the JAX package's Pallas switch; the port takes it for config parity
    # and runs its CUDA kernels on the card whatever its value
    use_pallas: Optional[bool] = None


@dataclass
class DiscriminatorConfig:
    name: str = "default"
    in_channels: int = 1


@dataclass
class TaskConfig:
    name: str = "generator_pre_training"  # or "gan_training"
    generator: Optional[GeneratorConfig] = None
    discriminator: Optional[DiscriminatorConfig] = None
    optimizers: Optional[Dict[str, Optional[OptimizerConfig]]] = None
    schedulers: Optional[Dict[str, Optional[SchedulerConfig]]] = None
    initial_hp_metric_val: float = 5e-3
    # GAN loss weights (conf/task/gan_training.yaml)
    pixel_level_loss_factor: float = 0.01
    perceptual_loss_factor: float = 1.0
    adversarial_loss_factor: float = 0.005
    # Reference keeps the VGG perceptual loss under no_grad (perceptual.py:23);
    # flip to True to actually backprop through it.
    differentiable_perceptual: bool = False
    # VGG truncation depth for the perceptual loss; the reference uses
    # features[:35] == conv5_4. Shallower cuts (e.g. conv2_2) give a cheap
    # variant for CI and ablations.
    perceptual_cutoff: str = "conv5_4"
    # Evaluate the VGG perceptual graph only every k-th step (1 = every step,
    # the reference behavior). Under the reference's no-grad quirk the term is
    # metrics-only, so k>1 changes nothing but the logged value on skipped
    # steps — it just buys GAN step throughput.
    perceptual_interval: int = 1


@dataclass
class TrainingConfig:
    lr: float = 1e-4
    output_dir: str = "."
    generator_type: str = MISSING
    experiment_name: str = "climsr"
    seed: int = 42
    run_fit: bool = True
    run_test_after_fit: bool = True
    batch_size: int = 192
    validation_batch_size: int = 384
    num_workers: int = 4
    lr_find_only: bool = False
    model_weights: Optional[str] = None  # fine-tune restore (cli/train.py:112-121)
    optimized_metric: Optional[str] = None


@dataclass
class InferenceConfig:
    ds_path: str = MISSING
    data_dir: str = MISSING
    original_full_res_cruts_data_path: str = MISSING
    inference_out_path: str = MISSING

    tiff_dir: str = MISSING
    extent_out_path_sr: str = MISSING
    extent_out_path_sr_nc: str = MISSING

    pretrained_model: str = MISSING
    results_dir: str = MISSING

    use_netcdf_datasets: bool = False
    temp_only: bool = True
    generator_type: str = MISSING

    elevation_file: str = MISSING
    land_mask_file: str = MISSING
    use_elevation: bool = True
    use_mask: bool = True
    use_global_min_max: bool = True
    cruts_variable: Optional[str] = "tmp"
    scaling_factor: int = 4
    normalize: bool = True
    normalization_range: Tuple[float, float] = (-1.0, 1.0)
    min_max_lookup: str = MISSING
    zscore_lookup: str = MISSING

    run_inference: bool = True
    extract_polygon_extent: bool = True
    to_netcdf: bool = True

    # TPU additions: batch whole months together and tile large frames
    batch_size: int = 16
    tile_size: Optional[int] = None  # None = whole-frame (reference behavior)
    tile_overlap: int = 16
    # Multi-chip whole-globe SR: H-shard each frame over the device mesh with
    # one halo exchange (parallel/halo.py), instead of single-device tiling.
    # Requires frame height divisible by the device count; falls back to the
    # tiled path otherwise.
    spatial_shard: bool = False
    spatial_halo: int = 32  # LR rows of context exchanged per neighbor
    # D2H transport encoding of the tiled path's packed land vector:
    # "pack12" (12-bit fixed point, 25% fewer bytes than f16 at 3.7e-4
    # worst-case abs error on the normalized output) or "f16".
    readback: str = "pack12"

    def __post_init__(self):
        if self.readback not in READBACKS:
            raise ValueError(f"inference.readback must be one of {READBACKS}, got {self.readback!r}")



@dataclass
class ResultInspectionConfig:
    ds_temp_nn_path: str = MISSING
    ds_temp_cru_path: str = MISSING
    peaks_feather: str = MISSING
    results_dir: str = MISSING


def infer_generator_config(generator_cfg: GeneratorConfig, data_config: SuperResolutionDataConfig) -> GeneratorConfig:
    """in_channels = 1 + use_elevation + use_mask (reference config.py:229-238)."""
    in_channels = 3
    if not data_config.use_elevation:
        in_channels -= 1
    if not data_config.use_mask:
        in_channels -= 1
    generator_cfg.in_channels = in_channels
    return generator_cfg
