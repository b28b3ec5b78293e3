# -*- coding: utf-8 -*-
"""The port stands alone: no JAX, nothing of the JAX package, nothing the GPU
machine may lack on the main path, and no silent move to the CPU."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import climsr_tpu_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(climsr_tpu_torch.__file__).resolve().parent
MODULES = sorted(m.name for m in pkgutil.walk_packages([str(PORT)], prefix="climsr_tpu_torch."))


def test_every_module_imports_without_jax_or_the_jax_package():
    """In a fresh interpreter: import every port module (and chip_smoke.py);
    no jax, flax or climsr_tpu module is loaded, none of the packages the GPU
    machine may lack (cv2, pandas, yaml, PIL, matplotlib), and none of the
    checkpoint libraries the JAX package writes with (orbax, tensorstore,
    zstandard, google_crc32c, zarr, numcodecs)."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for name in {MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'climsr_tpu', 'cv2', 'pandas', 'yaml', 'PIL', 'matplotlib',\n"
        "              'orbax', 'tensorstore', 'zstandard', 'google_crc32c', 'zarr', 'numcodecs'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 25
    for name in ("config.compose", "config.yaml_subset", "config.instantiator", "data.tables", "data.synthetic",
                 "data.climate_dataset", "data.datamodule", "data.pipeline", "ops.augment", "utils.core",
                 "utils.logging", "training.checkpoint", "training.callbacks", "training.loop", "cli.train",
                 "cli.inference", "ops.pixel_shuffle", "models.rcan", "models.drln", "models.rfb_esrgan",
                 "training.batch_probe", "training.lr_finder", "training.hparams_search", "utils.profiling",
                 "scripts.bench_rdb_widths", "io.feather", "native", "preprocessing.preprocessing",
                 "preprocessing.cleanup", "preprocessing.data_download", "preprocessing.scrape_polish_mountains",
                 "result_inspection.models", "cli.preprocess", "cli.data_download", "cli.data_preparation",
                 "cli.inspect_results", "data.utils", "consts.plotting", "consts.result_inspection",
                 "parallel.mesh", "parallel.halo", "parallel.launch", "parallel.cases", "io.zstd", "io.crc32c",
                 "io.ocdbt", "interop.orbax"):
        assert f"climsr_tpu_torch.{name}" in MODULES


def test_feather_io_needs_no_pandas_and_preprocessing_no_torch(tmp_path):
    """In a fresh interpreter with pandas and pyarrow blocked (an import of
    either raises): the port writes and reads a feather file. The
    preprocessing module, which the ``spawn`` pool's workers import, loads no
    torch."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None; sys.modules['pyarrow'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "import climsr_tpu_torch.preprocessing.preprocessing\n"
        "assert 'torch' not in sys.modules, 'torch loaded'\n"
        "from climsr_tpu_torch.data.tables import Table, read_feather, write_feather\n"
        f"path = {str(tmp_path / 't.feather')!r}\n"
        "write_feather(Table({'s': ['a', None], 'x': [1, 2], 'f': [0.5, np.nan]}), path)\n"
        "t = read_feather(path)\n"
        "assert list(t['s']) == ['a', None] and t['x'].tolist() == [1, 2] and np.isnan(t['f'][1])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr


def test_orbax_fixture_reads_with_the_checkpoint_libraries_blocked(tmp_path):
    """In a fresh interpreter with orbax, tensorstore, zstandard,
    google_crc32c, zarr, numcodecs, jax and flax blocked (an import of any
    raises): the port reads the committed JAX checkpoint and loads its
    generator strictly."""
    import tarfile

    with tarfile.open(ROOT / "tests" / "fixtures" / "jax_orbax_ckpt.tar") as tar:
        tar.extractall(tmp_path, filter="data")
    code = (
        "import sys\n"
        "for name in ('orbax', 'tensorstore', 'zstandard', 'google_crc32c', 'zarr', 'numcodecs', 'jax', 'flax'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch\n"
        "from climsr_tpu_torch.interop.params import load_generator_checkpoint\n"
        "from climsr_tpu_torch.models import create_generator\n"
        "from climsr_tpu_torch.training.checkpoint import load_checkpoint\n"
        f"root = {str(tmp_path / 'checkpoints')!r}\n"
        "m = create_generator('esrgan', dtype=torch.float32, device='cpu', nf=64, nb=1, gc=16, in_channels=3,\n"
        "                     out_channels=1)\n"
        "m.load_state_dict(load_generator_checkpoint(root), strict=True)\n"
        "assert load_checkpoint(root)['global_step'] == 2\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr


def test_sources_import_no_jax_and_nothing_of_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|climsr_tpu|orbax|tensorstore|zstandard|google_crc32c"
                         r"|zarr|numcodecs)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f}: {m.group(0).strip()}" for f in files for m in pattern.finditer(f.read_text())]
    assert not offenders


def test_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    """``device=None`` means CUDA: without a card every entry point raises
    instead of running on the CPU."""
    from climsr_tpu_torch.cli.train import main as train_main
    from climsr_tpu_torch.config.schemas import OptimizerConfig, TrainerConfig
    from climsr_tpu_torch.data.pipeline import build_device_store, device_prefetch
    from climsr_tpu_torch.training.loop import Trainer
    from climsr_tpu_torch.inference.run import inference_on_full_images, load_generator
    from climsr_tpu_torch.inference.tiled import TiledSR, whole_frame_sr
    from climsr_tpu_torch.losses.perceptual import build_perceptual_loss
    from climsr_tpu_torch.models import create_discriminator, create_generator
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.gan import make_gan_step, make_gan_val_losses
    from climsr_tpu_torch.training.tasks.pretrain import make_eval_step, make_pretrain_step

    cpu_model = create_generator("esrgan", device="cpu", train=True, nf=8, nb=1, gc=8)
    cpu_d = create_discriminator("esrgan", device="cpu", out_channels=8, num_conv_block=2, hr_size=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: create_generator("esrgan"),
        lambda: create_generator("esrgan", train=True, dtype=torch.bfloat16),
        lambda: build_optimizer(OptimizerConfig(), lambda step: 1e-4),
        lambda: make_pretrain_step(cpu_model, "esrgan"),
        lambda: make_eval_step(cpu_model, "esrgan"),
        lambda: load_generator(str(tmp_path / "missing.ckpt"), "esrgan"),
        lambda: TiledSR(lambda *a: a[0], scale=4, tile_size=16, overlap=4),
        lambda: whole_frame_sr(lambda *a: a[0], np.zeros((1, 4, 4, 1), np.float32)),
        lambda: inference_on_full_images(torch.nn.Identity(), None, str(tmp_path / "o"), "esrgan"),
        lambda: create_discriminator("esrgan"),
        lambda: make_gan_step(cpu_model, cpu_d, "esrgan"),
        lambda: make_gan_val_losses(cpu_model, cpu_d, "esrgan"),
        lambda: build_perceptual_loss(cutoff="conv1_2"),
        lambda: Trainer(None, None, None, TrainerConfig(), None),
        lambda: train_main(["experiment=esrgan_pre_training"]),
        lambda: build_device_store(None),
        lambda: next(device_prefetch(iter([{"hr": np.zeros((1, 4, 4, 1), np.float32)}]))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = create_generator("esrgan", device="cpu", nf=8, nb=1, gc=8)
    assert next(model.parameters()).device.type == "cpu"


def test_chip_smoke_exits_nonzero_and_prints_no_result_without_a_card(tmp_path):
    """Alone in a directory (no package beside it) and here without CUDA."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=300,
                             cwd=script.parent, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
