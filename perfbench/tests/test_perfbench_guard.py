"""The run's import guard compares whole top-level names."""
import subprocess
import sys
from pathlib import Path

from perfbench.guard import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]


def test_rejects_jax_and_the_jax_package():
    assert forbidden_loaded(["jax", "numpy"]) == ["jax"]
    assert forbidden_loaded(["jaxlib.xla_client"]) == ["jaxlib"]
    assert forbidden_loaded(["flax.linen"]) == ["flax"]
    assert forbidden_loaded(["climsr_tpu", "climsr_tpu.models.esrgan"]) == ["climsr_tpu"]


def test_accepts_the_port_and_lookalikes():
    assert forbidden_loaded(["climsr_tpu_torch", "climsr_tpu_torch.ops.rdb", "jaxtyping", "flaxen"]) == []


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.harness, perfbench.entries.train, perfbench.entries.sweep, perfbench.reference.train;"
            "import climsr_tpu_torch.training.loop, climsr_tpu_torch.inference.run;"
            "from perfbench.guard import forbidden_loaded; print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "esrgan-flagship.globe-sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and out.stdout.strip() == ""
