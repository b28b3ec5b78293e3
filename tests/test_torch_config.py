# -*- coding: utf-8 -*-
"""The port's config layer against the JAX package's, on the CPU.

- ``yaml_subset.load_yaml`` gives PyYAML's result (through the JAX composer's
  ``_yaml_load``, with its float rule) on every file under ``conf/``, and on
  override values; what is outside the subset raises ``ConfigError`` with the
  file and line;
- ``compose`` gives the JAX composer's config for every experiment preset,
  with overrides, and for ``inference.yaml``;
- ``from_dict`` and ``infer_generator_config`` give the JAX schemas' fields;
- ``InferenceConfig.readback`` is checked at the config level (both values
  reach ``inference_on_full_images``).
All comparisons are exact.
"""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from climsr_tpu.cli.train import _flatten_task_cfg as jax_flatten
from climsr_tpu.config import schemas as jax_schemas
from climsr_tpu.config.compose import _yaml_load
from climsr_tpu.config.compose import compose as jax_compose
from climsr_tpu_torch.cli.train import _flatten_task_cfg
from climsr_tpu_torch.config import schemas
from climsr_tpu_torch.config.compose import ConfigError, compose, default_config_dir
from climsr_tpu_torch.config.yaml_subset import load_yaml

torch.set_num_threads(1)

CONF = default_config_dir()
YAML_FILES = sorted(p.relative_to(CONF).as_posix() for p in CONF.rglob("*.yaml"))
EXPERIMENTS = sorted(p.stem for p in (CONF / "experiment").glob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of equal types (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_conf_tree_is_the_one_the_jax_composer_reads():
    from climsr_tpu.config.compose import default_config_dir as jax_default_config_dir

    assert CONF == jax_default_config_dir() == Path(__file__).resolve().parents[1] / "conf"
    assert len(YAML_FILES) >= 90 and len(EXPERIMENTS) >= 16


@pytest.mark.parametrize("rel", YAML_FILES)
def test_yaml_subset_reads_every_conf_file_as_pyyaml_does(rel):
    text = (CONF / rel).read_text()
    assert _same(load_yaml(text, rel), _yaml_load(text))


@pytest.mark.parametrize("raw", [
    "1e-4", "3e-7", "1.0", "-1", "010", "0x1f", "0b101", "1_000", "1:30", "+1", ".5", "-.inf", ".nan",
    "yes", "off", "True", "~", "null", "???", "${training.lr}", "/tmp/some-dir/ds", "'a''b'", '"a\\"b\\u00e9"',
    "{name: esrgan, nf: 16, nb: 1}", "[[-1.0, 1.0], [0.0, 1.0]]", "[]", "{}", "[a, 'b c', 3, null]",
    "esrgan_pre_training", "fp32",
])
def test_yaml_subset_reads_override_values_as_pyyaml_does(raw):
    assert _same(load_yaml(raw), _yaml_load(raw))


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 2\n", 2), ("a: |\n  text\n", 1), ("a: !!str 1\n", 1), ("a: [1,\n  2]\n", 1),
    ("a: 1\n---\nb: 2\n", 2), ("a: 2001-01-01\n", 1), ("a: b: c\n", 1), ("a:\n  b: 1\n   c: 2\n", 3),
])
def test_yaml_subset_refuses_what_conf_does_not_use(text, line):
    with pytest.raises(ConfigError, match=rf"f\.yaml:{line}:"):
        load_yaml(text, "f.yaml")


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_compose_matches_jax_for_every_experiment(name):
    overrides = [f"experiment={name}", "trainer.max_epochs=2", "datamodule.cfg.data_path=/data/x",
                 "generator={name: esrgan, nf: 16, nb: 1}", "training.lr=3e-4"]
    for ov in ([f"experiment={name}"], overrides):
        assert _same(compose(CONF, "config", ov), jax_compose(CONF, "config", ov))


def test_compose_matches_jax_for_inference_and_refuses_what_jax_refuses():
    for ov in ([], ["inference.generator_type=esrgan", "inference.tile_size=128", "inference.readback=f16"]):
        assert _same(compose(CONF, "inference", ov), jax_compose(CONF, "inference", ov))
    for bad in (["experiment=nope"], ["trainer.max_epochs"], ["generator=esrgan"], ["x=${nowhere.at.all}"]):
        with pytest.raises(Exception) as jax_err:
            jax_compose(CONF, "config", bad)
        with pytest.raises(ConfigError):
            compose(CONF, "config", bad)
        assert isinstance(jax_err.value, ValueError)


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_from_dict_and_infer_generator_config_match_jax(name):
    cfg = compose(CONF, "config", [f"experiment={name}"])
    jcfg = jax_compose(CONF, "config", [f"experiment={name}"])

    def both(cls_name, value, jvalue):
        got = schemas.from_dict(getattr(schemas, cls_name), value)
        want = jax_schemas.from_dict(getattr(jax_schemas, cls_name), jvalue)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want), cls_name
        return got, want

    both("TrainingConfig", cfg["training"], jcfg["training"])
    both("TrainerConfig", cfg["trainer"], jcfg["trainer"])
    both("TaskConfig", _flatten_task_cfg(cfg["task"]), jax_flatten(jcfg["task"]))
    both("DiscriminatorConfig", cfg["discriminator"], jcfg["discriminator"])
    for key in ("generator_optimizer", "discriminator_optimizer"):
        both("OptimizerConfig", cfg["optimizers"].get(key), jcfg["optimizers"].get(key))
    for key in ("generator_scheduler", "discriminator_scheduler"):
        both("SchedulerConfig", cfg["schedulers"].get(key), jcfg["schedulers"].get(key))
    data, jdata = both("SuperResolutionDataConfig", cfg["datamodule"]["cfg"], jcfg["datamodule"]["cfg"])
    gen, jgen = both("GeneratorConfig", cfg["generator"], jcfg["generator"])
    got = schemas.infer_generator_config(gen, data)
    want = jax_schemas.infer_generator_config(jgen, jdata)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_inference_config_checks_readback(monkeypatch, tmp_path):
    """Fault 2 closed: a readback outside {"pack12", "f16"} raises at the
    config, directly and through from_dict; both values pass through
    ``run_inference`` to ``inference_on_full_images``."""
    from climsr_tpu_torch.data.tables import Table
    from climsr_tpu_torch.inference import run

    with pytest.raises(ValueError, match="readback"):
        schemas.InferenceConfig(readback="u8")
    with pytest.raises(ValueError, match="readback"):
        schemas.from_dict(schemas.InferenceConfig, {"readback": "pack16"})
    stats = Table({"dataset": ["cru-ts"], "variable": ["tmp"], "filename": ["a.tif"], "min": [0.0], "max": [1.0]})
    monkeypatch.setattr(run, "load_generator", lambda *a, **k: torch.nn.Identity())
    monkeypatch.setattr(run, "read_feather", lambda path: stats)
    monkeypatch.setattr(run, "CRUTSInferenceDataset", lambda **k: "dataset")
    seen = []
    monkeypatch.setattr(run, "inference_on_full_images", lambda model, ds, **k: seen.append(k["readback"]))
    for readback in schemas.READBACKS:
        cfg = schemas.from_dict(schemas.InferenceConfig, {
            "readback": readback, "use_netcdf_datasets": True, "ds_path": "x.nc", "pretrained_model": "m.ckpt",
            "generator_type": "esrgan", "inference_out_path": str(tmp_path), "min_max_lookup": "mm.feather",
        })
        run.run_inference(cfg, ["tmp"], device="cpu")
    assert seen == ["pack12", "f16"]


def test_inference_cli_requires_the_mandatory_values(tmp_path):
    from climsr_tpu_torch.cli.inference import main

    with pytest.raises(ValueError, match="inference.pretrained_model"):
        main([f"inference.inference_out_path={tmp_path}"], device="cpu")


def test_instantiator_builds_the_port_objects():
    from climsr_tpu_torch.config.instantiator import default_instantiator as inst

    model = inst.instantiate(schemas.GeneratorConfig(name="esrgan", nf=8, nb=1, gc=8), device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0 and next(model.parameters()).device.type == "cpu"
    opt = inst.optimizer({"name": "adamw", "lr": 1e-3}, device="cpu")
    assert opt.cfg.lr == 1e-3 and opt.schedule(5) == 1e-3
    sched = inst.scheduler({"name": "one_cycle_schedule", "max_lr": 1e-3}, 1e-3, 10)
    assert np.isfinite(sched(3))
    with pytest.raises(TypeError):
        inst.instantiate(schemas.TrainerConfig())
