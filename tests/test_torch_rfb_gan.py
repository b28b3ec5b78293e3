# -*- coding: utf-8 -*-
"""The port's RFB-ESRGAN discriminator and the GAN fine-tune that pairs it
with the ESRGAN generator, against the JAX package's, on the CPU in f32.

Seeded numpy params in the JAX modules' trees are carried over by
``rfb_discriminator_state_dict_from_flax`` (and ``state_dict_from_flax``,
``vgg_state_dict_from_flax``); the same seeded numpy inputs go through:

- the discriminator at HR 32 (8 -> 2 px after its four stride-2 convs, then
  up-pooled to 14x14) in train mode (its sigmoid output and the BatchNorm
  running statistics it leaves) and in eval mode;
- a reference-key ``.ckpt`` (the JAX package's own spec) into the port's
  discriminator with ``strict=True``, and its output at other input sizes;
- 2 ``make_gan_step`` steps (ESRGAN nf=16 nb=1 gc=8, LR 8 -> HR 32, batch 2,
  Adam, VGG19 to conv1_2) against the JAX step;
- the training CLI on the CPU: the ``esrgan_fine_tune_no_gan_pre_training``
  preset at tiny widths on a europe-extent set (HR 452) from a generator
  checkpoint, the graft copying every tensor.

The discriminator has no width knob in either package: its fc1 holds
512 x 14 x 14 x 1024 weights (411 MB in f32) at any test size. The JAX side
runs compiled (``jax.jit``). Tolerances are stated at each test; f32
differences are summation order only.
"""
import glob

import numpy as np
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
from climsr_tpu.interop.torch_import import _rfb_discriminator_spec
from climsr_tpu.losses.perceptual import build_perceptual_loss as jax_build_perceptual_loss
from climsr_tpu.models import create_discriminator as jax_create_discriminator
from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.models.vgg import seeded_vgg19_variables
from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from climsr_tpu.training.tasks.gan import make_gan_step as jax_make_gan_step
from climsr_tpu.training.train_state import GANTrainState as JaxGANTrainState
from climsr_tpu_torch.config.schemas import OptimizerConfig
from climsr_tpu_torch.interop.params import (
    load_discriminator_checkpoint, rfb_discriminator_state_dict_from_flax, state_dict_from_flax,
    vgg_state_dict_from_flax,
)
from climsr_tpu_torch.losses.perceptual import build_perceptual_loss
from climsr_tpu_torch.models import create_discriminator, create_generator
from climsr_tpu_torch.training.optimizers import build_optimizer
from climsr_tpu_torch.training.tasks.gan import make_gan_step
from climsr_tpu_torch.training.train_state import GANTrainState

torch.set_num_threads(1)

HR = 32
G_KW = dict(nf=16, nb=1, gc=8, out_channels=1)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12), err_msg=what)


def _seeded(shapes, rng):
    """Numpy values for a tree of shapes: kernels U(+-1/sqrt(fan_in)), BatchNorm
    scales U(0.8, 1.2), running variances U(0.5, 1.5), the rest U(+-0.1)."""

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, size=leaf.shape).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, size=leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_discriminator(rng):
    model = jax_create_discriminator("rfb_esrgan", dtype=jnp.float32, in_channels=1)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x, train=False), jnp.zeros((1, HR, HR, 1)))
    return model, _seeded(shapes["params"], rng), _seeded(shapes["batch_stats"], rng)


def _port_discriminator(params, stats, train=True):
    d = create_discriminator("rfb_esrgan", device="cpu", train=train, in_channels=1, hr_size=HR)
    d.load_state_dict(rfb_discriminator_state_dict_from_flax(params, stats), strict=True)
    return d


def test_rfb_discriminator_matches_jax_in_train_and_eval_mode(rng):
    """Output to 1e-5 of max|ref|, running statistics to 1e-6 of theirs. The
    running variance is the unbiased one, the normalisation the biased one."""
    model, params, stats = _jax_discriminator(rng)
    x = rng.normal(size=(3, HR, HR, 1)).astype(np.float32)
    want, upd = jax.jit(lambda p, s: model.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=True,
                                                 mutable=["batch_stats"]))(params, stats)
    d = _port_discriminator(params, stats)
    got = d(_nchw(x))
    assert got.shape == (3, 1)
    _close(got.detach(), want, 1e-5, "train output")
    new = rfb_discriminator_state_dict_from_flax(params, _np(upd["batch_stats"]))
    for k, v in d.state_dict().items():
        if "running" in k:
            _close(v, new[k].numpy(), 1e-6, k)
    assert int(d.features[3].num_batches_tracked) == 1

    want_eval = jax.jit(lambda p, s: model.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=False))(
        params, upd["batch_stats"])
    with torch.no_grad():
        _close(d.eval()(_nchw(x)), want_eval, 1e-5, "eval output")


def test_rfb_discriminator_reference_checkpoint_loads_strict(rng, tmp_path):
    """Reference keys from the JAX package's spec (``features.{0,3i-1,3i}``,
    ``fc.{0,2}``) in a PL ``.ckpt`` beside a generator: ``strict=True`` into
    the port module, equal to ``rfb_discriminator_state_dict_from_flax``. The
    module takes any input size (the Trainer's ``hr_size`` is dropped)."""
    _, params, stats = _jax_discriminator(rng)
    sd = {}
    for tk, fp, kind in _rfb_discriminator_spec({}):
        if kind == "bn":
            sd.update({f"{tk}.weight": params[fp]["scale"], f"{tk}.bias": params[fp]["bias"],
                       f"{tk}.running_mean": stats[fp]["mean"], f"{tk}.running_var": stats[fp]["var"],
                       f"{tk}.num_batches_tracked": np.array(0)})
        else:
            leaf = params[fp]["Conv_0" if kind == "conv" else "Dense_0"]
            sd[f"{tk}.weight"] = leaf["kernel"].transpose(3, 2, 0, 1) if kind == "conv" else leaf["kernel"].T
            if "bias" in leaf:
                sd[f"{tk}.bias"] = leaf["bias"]
    ckpt = {f"discriminator.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    ckpt["generator.conv_first.weight"] = torch.zeros(1)
    torch.save({"state_dict": ckpt}, tmp_path / "gan.ckpt")
    d = create_discriminator("rfb_esrgan", device="cpu", train=False, hr_size=452)
    missing, unexpected = d.load_state_dict(load_discriminator_checkpoint(tmp_path / "gan.ckpt"), strict=True)
    assert not missing and not unexpected
    want = rfb_discriminator_state_dict_from_flax(params, stats)
    assert all(torch.equal(v, want[k]) for k, v in d.state_dict().items() if "num_batches" not in k)
    with torch.no_grad():
        for side in (HR, 36, 64):
            out = d(torch.from_numpy(rng.normal(size=(2, 1, side, side)).astype(np.float32)))
            assert out.shape == (2, 1) and bool(((out > 0) & (out < 1)).all())


def _jax_gan_steps(steps: int):
    """The JAX step's ``steps`` steps from seeded params: the batch, the initial
    params, the VGG params, each step's metrics, and the final G and D state
    dicts under the port's keys (the JAX state is dropped before the port runs)."""
    rng = np.random.default_rng(11)
    batch = {
        "lr": rng.normal(size=(2, HR // 4, HR // 4, 3)).astype(np.float32),
        "hr": np.clip(rng.normal(size=(2, HR, HR, 1)), -1, 1).astype(np.float32),
        "elevation": rng.normal(size=(2, HR, HR, 1)).astype(np.float32),
        "mask": (rng.random((2, HR, HR, 1)) > 0.3).astype(np.float32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    g_model = jax_create_generator("esrgan", dtype=jnp.float32, **G_KW)
    g_shapes = jax.eval_shape(g_model.init, jax.random.PRNGKey(0), jbatch["lr"], jbatch["elevation"], jbatch["mask"])
    g_params = _seeded(g_shapes["params"], rng)
    d_model, d_params, d_stats = _jax_discriminator(rng)
    vgg = seeded_vgg19_variables(cutoff="conv1_2")
    perceptual = jax_build_perceptual_loss(compute_dtype=jnp.float32, variables=vgg, cutoff="conv1_2")
    # Adam eps 1e-3: see test_torch_gan's step test
    cfg = JaxOptimizerConfig(name="adam", lr=1e-3, weight_decay=1e-4, eps=1e-3)
    g_tx, d_tx = (jax_build_optimizer(cfg, lambda s: 1e-3) for _ in range(2))
    state = JaxGANTrainState.create(g_params, g_tx, d_params, d_tx, d_stats)
    step = jax_make_gan_step(g_model, d_model, "esrgan", g_tx, d_tx, perceptual_fn=perceptual,
                             compute_dtype=jnp.float32, donate=False)
    metrics = []
    for _ in range(steps):
        state, m = step(state, jbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(batch=batch, init=(g_params, d_params, d_stats), vgg=_np(vgg["params"]), metrics=metrics,
                g_final=state_dict_from_flax("esrgan", _np(state.g_params)),
                d_final=rfb_discriminator_state_dict_from_flax(_np(state.d_params), _np(state.d_batch_stats)))


def test_two_gan_steps_with_the_rfb_discriminator_match_the_jax_step():
    """Every logged term to 1e-5 relative; the final G and D parameters to 1e-6
    absolute (1e-3 of the lr) and the BatchNorm statistics to 1e-5 of theirs.
    D's sigmoid output goes into the BCE-with-logits losses in both packages."""
    case = _jax_gan_steps(2)
    g_params, d_params, d_stats = case.pop("init")
    g = create_generator("esrgan", device="cpu", train=True, **G_KW)
    g.load_state_dict(state_dict_from_flax("esrgan", g_params), strict=True)
    d = _port_discriminator(d_params, d_stats)
    del g_params, d_params, d_stats
    perceptual = build_perceptual_loss(compute_dtype=torch.float32, state_dict=vgg_state_dict_from_flax(case["vgg"]),
                                       cutoff="conv1_2", device="cpu")
    cfg = OptimizerConfig(name="adam", lr=1e-3, weight_decay=1e-4, eps=1e-3)
    state = GANTrainState.create(g, build_optimizer(cfg, lambda s: 1e-3, device="cpu"),
                                 d, build_optimizer(cfg, lambda s: 1e-3, device="cpu"))
    step = make_gan_step(g, d, "esrgan", perceptual_fn=perceptual, compute_dtype=torch.float32, device="cpu")
    batch = {k: _nchw(v) for k, v in case["batch"].items()}
    for i, want in enumerate(case["metrics"]):
        state, m = step(state, batch)
        assert set(m) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, atol=1e-7, err_msg=f"step {i + 1} {k}")
    with torch.no_grad():
        for model, want in ((g, case["g_final"]), (d, case["d_final"])):
            for k, p in model.state_dict().items():
                if k.endswith("num_batches_tracked"):
                    assert int(p) == 4 * 2, k  # hr, sr, hr, sr detached per step
                    continue
                # torch ops, not numpy's: fc.0 holds 100M weights
                err = (p - want[k]).abs().max().item()
                limit = 1e-5 * want[k].abs().max().item() if "running" in k else 1e-6
                assert err <= limit, f"{k}: {err:.3e} > {limit:.3e}"


def test_cli_gan_fine_tune_preset_with_the_rfb_discriminator(tmp_path):
    """``esrgan_fine_tune_no_gan_pre_training`` (the RFB discriminator) from a
    generator checkpoint: the graft copies every tensor, the GAN terms and val
    losses are logged, and the checkpoint's discriminator loads into a fresh
    RFB discriminator with strict=True. The set is the preset's europe extent
    (HR 452); one step of batch 1, one val and one test frame."""
    from climsr_tpu_torch.cli.train import main
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
    from climsr_tpu_torch.training import loop

    make_synthetic_dataset(tmp_path / "eu", n_tiles_per_stage=(2, 1, 1), variables=["tmax"], europe_extent=True)
    src = create_generator("esrgan", device="cpu", generator=torch.Generator().manual_seed(0), nf=8, nb=1, gc=8,
                           out_channels=1)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in src.state_dict().items()}}, tmp_path / "pre.ckpt")
    grafts = []
    init = loop.Trainer.__init__

    def keep_graft(self, *args, **kwargs):
        init(self, *args, **kwargs)
        grafts.append(self.graft)

    loop.Trainer.__init__ = keep_graft
    try:
        hp = main(["--device=cpu", "experiment=esrgan_fine_tune_no_gan_pre_training", "generator.nf=8",
                   "generator.nb=1", "generator.gc=8", "task.perceptual_cutoff=conv1_2", "training.batch_size=1",
                   "training.validation_batch_size=1", "training.num_workers=2", "trainer.max_epochs=1",
                   "trainer.limit_train_batches=1", "trainer.limit_test_batches=1", "trainer.log_every_n_steps=1",
                   "trainer.precision=fp32", "logger=csv", "print_config=false",
                   "datamodule.cfg.world_clim_variable=tmax", f"datamodule.cfg.data_path={tmp_path / 'eu'}",
                   f"training.model_weights={tmp_path / 'pre.ckpt'}", f"training.output_dir={tmp_path / 'out'}"])
    finally:
        loop.Trainer.__init__ = init
    (copied, total), = grafts
    assert copied == total > 0 and np.isfinite(hp)
    (run,) = glob.glob(f"{tmp_path}/out/outputs/runs/esrgan/*")
    text = open(f"{run}/metrics.csv").read()
    assert "train/loss_D" in text and "val/loss_G" in text and "test/rmse" in text
    (ckpt,) = glob.glob(f"{run}/checkpoints/*.ckpt")
    fresh = create_discriminator("rfb_esrgan", device="cpu")
    fresh.load_state_dict(load_discriminator_checkpoint(ckpt), strict=True)
