# -*- coding: utf-8 -*-
"""The port's GAN fine-tune slice against the JAX package's, on the CPU in f32.

JAX weights are carried into the port (``discriminator_state_dict_from_flax``,
``vgg_state_dict_from_flax``, ``state_dict_from_flax``) and the same seeded
numpy inputs go through both:

- the discriminator (``num_conv_block=2``, ``out_channels=16``, HR 32, so
  the unpadded head convs fit) in train mode (logits and the BatchNorm
  running statistics it leaves) and in eval mode;
- VGG19 through conv2_2 against JAX ``VGG19Features`` and against the
  committed torch goldens ``tests/fixtures/vgg19_goldens.npz``;
- the relativistic G and D losses;
- 3 ``make_gan_step`` steps (ESRGAN nf=16 nb=1 gc=8, LR 8x8 -> HR 32x32,
  batch 2, Adam, perceptual at conv2_2 every 2nd step) against the JAX step:
  every logged term, the final G and D parameters and the BN statistics;
- one ``make_gan_val_losses`` call.

Tolerances are stated at each test; f32 differences are summation order only.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
from climsr_tpu.config.schemas import TaskConfig as JaxTaskConfig
from climsr_tpu.losses.gan import relativistic_d_loss as jax_d_loss
from climsr_tpu.losses.gan import relativistic_g_loss as jax_g_loss
from climsr_tpu.losses.perceptual import build_perceptual_loss as jax_build_perceptual_loss
from climsr_tpu.models import create_discriminator as jax_create_discriminator
from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.models.vgg import VGG19Features as JaxVGG19Features
from climsr_tpu.models.vgg import seeded_vgg19_variables
from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from climsr_tpu.training.tasks.gan import make_gan_step as jax_make_gan_step
from climsr_tpu.training.tasks.gan import make_gan_val_losses as jax_make_gan_val_losses
from climsr_tpu.training.train_state import GANTrainState as JaxGANTrainState
from climsr_tpu_torch.config.schemas import OptimizerConfig, TaskConfig
from climsr_tpu_torch.interop.params import (
    discriminator_state_dict_from_flax, load_discriminator_checkpoint, state_dict_from_flax, vgg_state_dict_from_flax,
)
from climsr_tpu_torch.losses.gan import relativistic_d_loss, relativistic_g_loss
from climsr_tpu_torch.losses.perceptual import build_perceptual_loss
from climsr_tpu_torch.models import create_discriminator, create_generator
from climsr_tpu_torch.models.vgg import VGG19Features, load_feature_weights, seeded_vgg19_state_dict
from climsr_tpu_torch.training.optimizers import build_optimizer
from climsr_tpu_torch.training.tasks.gan import make_gan_step, make_gan_val_losses
from climsr_tpu_torch.training.train_state import GANTrainState

torch.set_num_threads(1)

GOLDENS = Path(__file__).parent / "fixtures" / "vgg19_goldens.npz"
D_KW = dict(in_channels=1, out_channels=16, num_conv_block=2)
HR = 32


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_discriminator():
    model = jax_create_discriminator("esrgan", dtype=jnp.float32, **D_KW)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, HR, HR, 1), jnp.float32), train=False)
    return model, variables["params"], variables["batch_stats"]


def _port_discriminator(params, batch_stats, train=True):
    d = create_discriminator("esrgan", device="cpu", train=train, hr_size=HR, **D_KW)
    d.load_state_dict(discriminator_state_dict_from_flax(_np(params), _np(batch_stats)), strict=True)
    return d


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12), err_msg=what)


def test_discriminator_matches_jax_in_train_and_eval_mode(rng):
    """Logits to 1e-5 of max|ref|, running statistics to 1e-6 of theirs:
    f32 summation order only. The running variance is the unbiased one, the
    normalisation the biased one (torch's split)."""
    model, params, stats = _jax_discriminator()
    x = rng.normal(size=(3, HR, HR, 1)).astype(np.float32)
    want, upd = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    d = _port_discriminator(params, stats)
    got = d(_nchw(x))
    assert got.shape == (3, 1)
    _close(got.detach(), want, 1e-5, "train logits")
    new = discriminator_state_dict_from_flax(_np(params), _np(upd["batch_stats"]))
    for k, v in d.state_dict().items():
        if "running" in k:
            _close(v, new[k].numpy(), 1e-6, k)
    assert int(d.feature_extraction[3].num_batches_tracked) == 1

    want_eval = model.apply({"params": params, "batch_stats": upd["batch_stats"]}, jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(d.eval()(_nchw(x)), want_eval, 1e-5, "eval logits")


def test_discriminator_keys_are_the_reference_checkpoint_keys(tmp_path):
    """A reference PL ``.ckpt``'s ``discriminator.`` part loads with
    strict=True; fc1's fan-in at 128 px is the reference's 8192; an input of
    another size raises. The RFB-ESRGAN discriminator's own ``.ckpt`` loads
    with strict=True too."""
    d = create_discriminator("esrgan", device="cpu", generator=torch.Generator().manual_seed(0))
    assert d.classification[0].in_features == 8192
    keys = set(d.state_dict())
    for i in range(4):
        assert {f"feature_extraction.{7 * i + 1}.weight", f"feature_extraction.{7 * i + 3}.running_var",
                f"feature_extraction.{7 * i + 5}.bias"} <= keys
    assert {"feature_extraction.28.weight", "feature_extraction.30.weight", "classification.1.bias"} <= keys
    ckpt = {"state_dict": {**{f"discriminator.{k}": v for k, v in d.state_dict().items()},
                           "generator.conv_first.weight": torch.zeros(1)}}
    torch.save(ckpt, tmp_path / "gan.ckpt")
    fresh = create_discriminator("default", device="cpu")
    fresh.load_state_dict(load_discriminator_checkpoint(tmp_path / "gan.ckpt"), strict=True)
    assert torch.equal(fresh.classification[0].weight, d.classification[0].weight)
    with pytest.raises(ValueError, match="128x128"):
        fresh(torch.zeros(1, 1, 64, 64))
    # the RFB-ESRGAN discriminator builds (hr_size dropped) and reads its own .ckpt
    rfb = create_discriminator("rfb_esrgan", device="cpu", generator=torch.Generator().manual_seed(1), hr_size=128)
    torch.save({"state_dict": {f"discriminator.{k}": v for k, v in rfb.state_dict().items()}}, tmp_path / "rfb.ckpt")
    rfb_fresh = create_discriminator("rfb_esrgan", device="cpu")
    rfb_fresh.load_state_dict(load_discriminator_checkpoint(tmp_path / "rfb.ckpt"), strict=True)
    assert torch.equal(rfb_fresh.fc[0].weight, rfb.fc[0].weight)
    torch.save({"state_dict": {"generator.x": torch.zeros(1)}}, tmp_path / "g.ckpt")
    with pytest.raises(KeyError):
        load_discriminator_checkpoint(tmp_path / "g.ckpt")


def test_vgg_matches_jax_and_the_committed_goldens(rng):
    """Against JAX ``VGG19Features`` on its seeded weights (1e-5 of max|ref|)
    and against the torch goldens on their weights (as
    ``tests/test_vgg_golden.py``: 1e-4 absolute, 1e-5 relative for the L1)."""
    variables = seeded_vgg19_variables(cutoff="conv2_2")
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    want = JaxVGG19Features(cutoff="conv2_2").apply(variables, jnp.asarray(x))
    model = VGG19Features("conv2_2")
    model.load_state_dict(vgg_state_dict_from_flax(_np(variables["params"])), strict=True)
    with torch.no_grad():
        _close(model(_nchw(x)).permute(0, 2, 3, 1), want, 1e-5)

    goldens = np.load(GOLDENS)
    sd = {k: torch.from_numpy(goldens[k]) for k in goldens.files if k.startswith("features.")}
    for cutoff, key in (("conv1_2", "act_conv1_2"), ("conv2_2", "act_conv2_2")):
        m = VGG19Features(cutoff)
        m.load_state_dict({k: v for k, v in sd.items() if k in m.state_dict()}, strict=True)
        with torch.no_grad():
            got = m(torch.from_numpy(goldens["input_x"]))
        np.testing.assert_allclose(got.numpy(), goldens[key], atol=1e-4, rtol=1e-4)
    # the goldens' L1 is on 3-channel inputs; the loss repeats a 1-channel raster to 3
    fx, fy = (torch.from_numpy(goldens[k]) for k in ("input_x", "input_y"))
    with torch.no_grad():
        l1 = torch.mean(torch.abs(m(fx) - m(fy))).item()
    np.testing.assert_allclose(l1, float(goldens["perceptual_l1_conv2_2"]), rtol=1e-5)
    perceptual = build_perceptual_loss(compute_dtype=torch.float32, state_dict=sd, cutoff="conv2_2", device="cpu")
    one = torch.from_numpy(rng.normal(size=(2, 1, 16, 16)).astype(np.float32)).requires_grad_(True)
    got = perceptual(-one, one)
    assert got.grad_fn is None  # the reference's no-grad term
    with torch.no_grad():
        want_l1 = torch.mean(torch.abs(m(one.repeat(1, 3, 1, 1)) - m(-one.repeat(1, 3, 1, 1))))
    np.testing.assert_allclose(got.item(), want_l1.item(), rtol=1e-6)


def test_vgg_weights_fall_back_to_the_seeded_stand_in(tmp_path, monkeypatch):
    """No file on disk: the seeded stand-in, reproducible; a shallow npz cache counts as missing."""
    from climsr_tpu_torch.models import vgg

    monkeypatch.setattr(vgg, "default_weights_path", lambda: tmp_path / "vgg19_features.npz")
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    sd, provenance = load_feature_weights("conv1_2")
    assert provenance == "seeded" and set(sd) == {f"features.{i}.{k}" for i in (0, 2) for k in ("weight", "bias")}
    assert all(torch.equal(sd[k], v) for k, v in seeded_vgg19_state_dict("conv1_2").items())
    np.savez(tmp_path / "vgg19_features.npz", **{"conv1_1.kernel": np.ones((3, 3, 3, 64), np.float32),
                                                   "conv1_1.bias": np.zeros(64, np.float32)})
    assert load_feature_weights("conv1_1")[1] == "pretrained"
    assert torch.equal(load_feature_weights("conv1_1")[0]["features.0.weight"], torch.ones(64, 3, 3, 3))
    assert load_feature_weights("conv1_2")[1] == "seeded"


def test_relativistic_losses_match_jax(rng):
    """To 1e-6 relative; the G loss keeps the reference's swapped labels."""
    real, fake = (rng.normal(size=(5, 1)).astype(np.float32) * 3 for _ in range(2))
    for port, ref in ((relativistic_g_loss, jax_g_loss), (relativistic_d_loss, jax_d_loss)):
        got = port(torch.from_numpy(real), torch.from_numpy(fake)).item()
        np.testing.assert_allclose(got, float(ref(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6)
    assert relativistic_g_loss(torch.from_numpy(real), torch.from_numpy(fake)).item() != pytest.approx(
        relativistic_d_loss(torch.from_numpy(real), torch.from_numpy(fake)).item())


def test_task_config_carries_the_jax_fields():
    import dataclasses

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxTaskConfig)}
    assert {f.name: f.default for f in dataclasses.fields(TaskConfig)} == jax_fields


def _gan_batch(rng, n=2, lr=HR // 4):
    return {
        "lr": rng.normal(size=(n, lr, lr, 3)).astype(np.float32),
        "hr": np.clip(rng.normal(size=(n, HR, HR, 1)), -1, 1).astype(np.float32),
        "elevation": rng.normal(size=(n, HR, HR, 1)).astype(np.float32),
        "mask": (rng.random((n, HR, HR, 1)) > 0.3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def gan_case():
    """Both packages' models from the same JAX init, the JAX step's 3 steps and val losses."""
    rng = np.random.default_rng(7)
    batch = _gan_batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    g_model = jax_create_generator("esrgan", nf=16, nb=1, gc=8, out_channels=1, dtype=jnp.float32)
    g_params = g_model.init(jax.random.PRNGKey(0), jbatch["lr"], jbatch["elevation"], jbatch["mask"])["params"]
    d_model, d_params, d_stats = _jax_discriminator()
    vgg = seeded_vgg19_variables(cutoff="conv2_2")
    perceptual = jax_build_perceptual_loss(compute_dtype=jnp.float32, variables=vgg, cutoff="conv2_2")
    cfg = JaxOptimizerConfig(name="adam", lr=1e-3, weight_decay=1e-4, eps=1e-3)
    g_tx, d_tx = (jax_build_optimizer(cfg, lambda s: 1e-3) for _ in range(2))
    state = JaxGANTrainState.create(g_params, g_tx, d_params, d_tx, d_stats)
    step = jax_make_gan_step(g_model, d_model, "esrgan", g_tx, d_tx, perceptual_fn=perceptual,
                             perceptual_interval=2, compute_dtype=jnp.float32, donate=False)
    metrics = []
    for _ in range(3):
        state, m = step(state, jbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    val = jax_make_gan_val_losses(g_model, d_model, "esrgan", perceptual_fn=perceptual, compute_dtype=jnp.float32)
    val_metrics = {k: float(v) for k, v in val(state.g_params, state.d_params, state.d_batch_stats, jbatch).items()}
    return dict(batch=batch, init=(_np(g_params), _np(d_params), _np(d_stats)), vgg=_np(vgg["params"]),
                metrics=metrics, final=state, val=val_metrics)


def _port_gan(case):
    g_params, d_params, d_stats = case["init"]
    g = create_generator("esrgan", device="cpu", train=True, nf=16, nb=1, gc=8, out_channels=1)
    g.load_state_dict(state_dict_from_flax("esrgan", g_params), strict=True)
    d = _port_discriminator(d_params, d_stats)
    perceptual = build_perceptual_loss(compute_dtype=torch.float32, state_dict=vgg_state_dict_from_flax(case["vgg"]),
                                       cutoff="conv2_2", device="cpu")
    cfg = OptimizerConfig(name="adam", lr=1e-3, weight_decay=1e-4, eps=1e-3)  # see the step test
    state = GANTrainState.create(g, build_optimizer(cfg, lambda s: 1e-3, device="cpu"),
                                 d, build_optimizer(cfg, lambda s: 1e-3, device="cpu"))
    return state, perceptual


def test_three_gan_steps_match_the_jax_step(gan_case):
    """Every logged term to 1e-5 relative (the perceptual term is 0.0 on step
    2 of 3 with ``perceptual_interval=2``); the final parameters to 1e-6
    absolute (1e-3 of the lr) and the BN statistics to 1e-5 of theirs. Adam
    runs with eps 1e-3 here: its first updates are lr * g / (|g| + eps), and at
    the default 1e-8 a weight whose gradient is near zero moves by a full step
    of either sign, so f32 summation-order noise in g decides it (measured at
    1e-8: 1 D and 2 G weights of 25,000 off by up to 1.9e-5)."""
    state, perceptual = _port_gan(gan_case)
    step = make_gan_step(state.g_model, state.d_model, "esrgan", perceptual_fn=perceptual, perceptual_interval=2,
                         compute_dtype=torch.float32, device="cpu")
    batch = {k: _nchw(v) for k, v in gan_case["batch"].items()}
    for i, want in enumerate(gan_case["metrics"]):
        state, m = step(state, batch)
        assert set(m) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, atol=1e-7, err_msg=f"step {i + 1} {k}")
    assert gan_case["metrics"][1]["train/perceptual_loss"] == 0.0 and state.step == 3
    final = gan_case["final"]
    g_want = state_dict_from_flax("esrgan", _np(final.g_params))
    for k, p in state.g_model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), g_want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    d_want = discriminator_state_dict_from_flax(_np(final.d_params), _np(final.d_batch_stats))
    for k, p in state.d_model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(p) == 4 * 3, k  # hr, sr, hr, sr detached per step
        elif "running" in k:
            _close(p, d_want[k].numpy(), 1e-5, k)
        else:
            np.testing.assert_allclose(p.numpy(), d_want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_gan_val_losses_match_jax(gan_case):
    """One call on the models as JAX's 3 steps left them (1e-5 relative); D
    keeps its train mode and its statistics."""
    state, perceptual = _port_gan(gan_case)
    final = gan_case["final"]
    state.g_model.load_state_dict(state_dict_from_flax("esrgan", _np(final.g_params)), strict=True)
    state.d_model.load_state_dict(discriminator_state_dict_from_flax(_np(final.d_params),
                                                                     _np(final.d_batch_stats)), strict=True)
    before = {k: v.clone() for k, v in state.d_model.state_dict().items()}
    val = make_gan_val_losses(state.g_model, state.d_model, "esrgan", perceptual_fn=perceptual,
                              compute_dtype=torch.float32, device="cpu")
    got = val({k: _nchw(v) for k, v in gan_case["batch"].items()})
    assert set(got) == set(gan_case["val"])
    for k, v in gan_case["val"].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-5, err_msg=k)
    assert state.d_model.training
    assert all(torch.equal(v, before[k]) for k, v in state.d_model.state_dict().items())


def test_gan_step_refuses_options_of_later_slices():
    g = create_generator("esrgan", device="cpu", train=True, nf=16, nb=1, gc=8, out_channels=1)
    d = create_discriminator("esrgan", device="cpu", hr_size=HR, **D_KW)
    # zero and spatial are ported (tests/test_torch_parallel.py,
    # tests/test_torch_spatial.py): a malformed dict of either raises
    for value in ({}, {"stage": -1}, {"stage": 1, "g_shardings": None}):
        with pytest.raises(ValueError, match="zero"):
            make_gan_step(g, d, "esrgan", device="cpu", zero=value)
    for value in ({}, {"mesh": None, "shardings": None}):
        with pytest.raises(ValueError, match="spatial"):
            make_gan_step(g, d, "esrgan", device="cpu", spatial=value)
    with pytest.raises(ValueError):
        make_gan_val_losses(g, d, "esrgan", device="meta")
