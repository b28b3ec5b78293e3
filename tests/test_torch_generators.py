# -*- coding: utf-8 -*-
"""The port's RCAN, DRLN and RFB-ESRGAN generators against the JAX package's,
on the CPU in f32.

Seeded numpy params in each JAX module's tree are carried over by
``state_dict_from_flax`` and the same seeded numpy inputs go through:

- ``pixel_shuffle`` / ``pixel_unshuffle``, ``adaptive_avg_pool`` (8 -> 14
  up-pooling included) and the non-square, dilated, bias-free convs of the
  RFB branches;
- each family's forward (RCAN 2 groups x 2 RCABs x 16 with ``reduction=4``;
  DRLN ``channels=16``; RFB-ESRGAN 1 RRDB + 1 RRFDB; 8x8 LR) and the
  gradients of a scalar loss w.r.t. every parameter;
- 2 pre-training steps of ``rcan`` against JAX's ``make_pretrain_step``;
- a reference-key checkpoint (the JAX package's ``export_generator_params``)
  into each port module with ``strict=True``, DRLN with its dead ``c4``;
- the training CLI on the CPU: a tiny ``rcan_pre_training`` fit and test,
  then ``rcan_fine_tuning`` from its best checkpoint on a europe-extent set,
  whose graft copies every tensor.

DRLN runs at 16 channels, not 8: its channel attention is ``channels // 16 *
3`` wide, and at 8 that is a zero-width conv that neither package can
initialise. Tolerance: 1e-4 of max|ref| (f32 summation order only).
"""
import functools
import glob

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
from climsr_tpu.interop.torch_import import export_generator_params
from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.models.common import TorchConv as JaxTorchConv
from climsr_tpu.models.common import adaptive_avg_pool as jax_adaptive_avg_pool
from climsr_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from climsr_tpu.ops.pixel_shuffle import pixel_unshuffle as jax_pixel_unshuffle
from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from climsr_tpu.training.tasks.pretrain import make_pretrain_step as jax_make_pretrain_step
from climsr_tpu.training.train_state import TrainState as JaxTrainState
from climsr_tpu_torch.config.schemas import OptimizerConfig
from climsr_tpu_torch.interop.params import load_generator_checkpoint, state_dict_from_flax
from climsr_tpu_torch.models import FUSION_GENERATORS, apply_generator, create_generator
from climsr_tpu_torch.models.common import TorchConv, adaptive_avg_pool, global_avg_pool
from climsr_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from climsr_tpu_torch.training.optimizers import build_optimizer
from climsr_tpu_torch.training.tasks.pretrain import make_pretrain_step
from climsr_tpu_torch.training.train_state import TrainState

torch.set_num_threads(1)

REL_TOL = 1e-4
FAMILIES = {
    "rcan": dict(n_resgroups=2, n_resblocks=2, n_feats=16, reduction=4, out_channels=1),
    "drln": dict(channels=16, in_channels=3, out_channels=1),
    "rfb_esrgan": dict(num_rrdb_blocks=1, num_rrfdb_blocks=1, out_channels=1),
}


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL_TOL * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("factor", [2, 3])
def test_pixel_shuffle_and_unshuffle_match_jax(rng, factor):
    """Exact: the ops move elements. The port keeps channels_last bf16 tensors so."""
    x = rng.normal(size=(2, 5, 7, 4 * factor * factor)).astype(np.float32)
    y = jax_pixel_shuffle(jnp.asarray(x), factor)
    np.testing.assert_array_equal(_nhwc(pixel_shuffle(_nchw(x), factor)), np.asarray(y))
    np.testing.assert_array_equal(_nhwc(pixel_unshuffle(_nchw(np.asarray(y)), factor)),
                                  np.asarray(jax_pixel_unshuffle(y, factor)))
    bf = _nchw(x).to(torch.bfloat16)
    out = pixel_shuffle(bf, factor)
    assert out.dtype == torch.bfloat16 and out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(pixel_unshuffle(out, factor), bf)


@pytest.mark.parametrize("hw,out_hw", [((8, 8), (14, 14)), ((29, 29), (14, 14)), ((7, 10), (3, 4)), ((5, 6), (1, 1))])
def test_adaptive_avg_pool_matches_jax(rng, hw, out_hw):
    """torch's windows, which the JAX pool copies, up-pooling included (8 -> 14
    is the RFB discriminator's at HR 128). 1e-6 of max|ref|."""
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    want = jax_adaptive_avg_pool(jnp.asarray(x), out_hw)
    got = adaptive_avg_pool(_nchw(x), out_hw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-6 * np.abs(want).max())
    if out_hw == (1, 1):
        np.testing.assert_allclose(_nhwc(global_avg_pool(_nchw(x))), np.asarray(want), rtol=0, atol=1e-6)
    bf = adaptive_avg_pool(_nchw(x).to(torch.bfloat16), out_hw)
    assert bf.dtype == torch.bfloat16 and tuple(bf.shape[2:]) == out_hw


@pytest.mark.parametrize("kernel_size,padding,dilation", [((1, 3), (0, 1), 1), ((3, 1), (1, 0), 1), (3, None, 3),
                                                          (3, None, 5)])
def test_bias_free_rfb_convs_match_jax(rng, kernel_size, padding, dilation):
    x = rng.normal(size=(2, 12, 13, 4)).astype(np.float32)
    mod = JaxTorchConv(6, kernel_size=kernel_size, padding=padding, dilation=dilation, use_bias=False)
    v = mod.init(jax.random.PRNGKey(0), x)
    conv = TorchConv(4, 6, kernel_size, padding=padding, bias=False, dilation=dilation)
    conv.load_state_dict({"weight": torch.from_numpy(np.asarray(v["params"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
                                                     .copy())}, strict=True)
    with torch.no_grad():
        _close(_nhwc(conv(_nchw(x))), mod.apply(v, x))


def _seeded_params(model, args, seed: int):
    """Params of ``model``'s tree, drawn with numpy: kernels U(+-1/sqrt(fan_in)),
    biases U(+-0.1) (the shapes from ``jax.eval_shape``, so no flax init runs)."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.1
        return rng.uniform(-bound, bound, size=leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(fill, shapes)


def _inputs(rng, name, n=2, lr=8):
    x = rng.normal(size=(n, lr, lr, 3)).astype(np.float32)
    if name not in FUSION_GENERATORS:
        return (x,)
    return (x, rng.normal(size=(n, 4 * lr, 4 * lr, 1)).astype(np.float32),
            (rng.random((n, 4 * lr, 4 * lr, 1)) > 0.3).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _case(name):
    """The family's JAX module on seeded params and inputs: its output, and the
    gradient of sum(out * w) w.r.t. every parameter (one compiled ``jax.vjp``:
    eager op-by-op dispatch compiles each conv shape apart and took 4x longer
    for RFB-ESRGAN)."""
    rng = np.random.default_rng(sorted(FAMILIES).index(name))
    args = _inputs(rng, name)
    model = jax_create_generator(name, dtype=jnp.float32, **FAMILIES[name])
    params = _seeded_params(model, args, seed=1)
    w = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)

    @jax.jit
    def out_and_grads(p):
        out, vjp = jax.vjp(lambda q: model.apply({"params": q}, *args), p)
        return out, vjp(w)[0]

    out, grads = out_and_grads(params)
    return dict(params=params, args=args, w=w, out=np.asarray(out), grads=_np(grads))


def _port(name, params):
    port = create_generator(name, device="cpu", train=True, **FAMILIES[name])
    port.load_state_dict(state_dict_from_flax(name, params), strict=True)
    return port


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_matches_jax(name):
    case = _case(name)
    with torch.no_grad():
        got = apply_generator(name, _port(name, case["params"]), *(_nchw(a) for a in case["args"]))
    assert got.shape == (2, 1, 32, 32)
    _close(_nhwc(got), case["out"])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_parameter_gradients_match_jax(name):
    """d(sum(out * w))/d(param) for every parameter, each to 1e-4 of its own max|ref|."""
    case = _case(name)
    port = _port(name, case["params"])
    loss = (apply_generator(name, port, *(_nchw(a) for a in case["args"])) * _nchw(case["w"])).sum()
    loss.backward()
    want = state_dict_from_flax(name, case["grads"])
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        _close(p.grad.numpy(), want[k].numpy(), k)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_reference_checkpoint_loads_strict(tmp_path, name):
    """The JAX package's export of the same params (reference keys) in a PL
    ``.ckpt`` loads into the port module with strict=True and gives the
    ``state_dict_from_flax`` tensors; DRLN's dead ``c4`` is dropped on load."""
    params = _case(name)["params"]
    port = _port(name, params)
    ref = export_generator_params(name, params)
    sd = {f"generator.{k}": torch.from_numpy(np.array(v)) for k, v in ref.items()}
    if name == "drln":
        sd["generator.c4.body.0.weight"] = torch.zeros(16, 32, 3, 3)
        sd["generator.c4.body.0.bias"] = torch.zeros(16)
    torch.save({"state_dict": sd, "epoch": 0}, tmp_path / "ref.ckpt")
    loaded = load_generator_checkpoint(tmp_path / "ref.ckpt", name)
    fresh = create_generator(name, device="cpu", **FAMILIES[name])
    fresh.load_state_dict(loaded, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    if name == "drln":
        assert "c4.body.0.weight" in load_generator_checkpoint(tmp_path / "ref.ckpt")


def test_two_rcan_pretrain_steps_match_the_jax_step(rng):
    """Loss and grad norm to 1e-5 relative, parameters to 1e-6 absolute (about
    1e-3 of the lr). AdamW runs with eps 1e-3: at the default 1e-8 its first
    update moves a weight whose gradient is near zero by a full step of
    either sign, so f32 summation-order noise decides it (measured at 1e-8: 1
    of 9,216 upsampler weights off by 1.1e-6)."""
    lr, steps = 1e-3, 2
    n, hw = 2, 8
    batch = {"lr": rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
             "hr": rng.normal(size=(n, 4 * hw, 4 * hw, 1)).astype(np.float32),
             "elevation": rng.normal(size=(n, 4 * hw, 4 * hw, 1)).astype(np.float32),
             "mask": (rng.random((n, 4 * hw, 4 * hw, 1)) > 0.3).astype(np.float32)}
    model = jax_create_generator("rcan", dtype=jnp.float32, **FAMILIES["rcan"])
    params = _seeded_params(model, (batch["lr"], batch["elevation"], batch["mask"]), seed=2)
    cfg = dict(name="adamw", lr=lr, weight_decay=1e-4, eps=1e-3)  # eps: see test_torch_gan's step test
    tx = jax_build_optimizer(JaxOptimizerConfig(**cfg), lambda s: lr)
    state = JaxTrainState.create(params, tx)
    step = jax_make_pretrain_step(model, "rcan", tx, compute_dtype=jnp.float32, donate=False)
    want = []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append((float(m["train/loss"]), float(m["grad_norm"])))

    port = create_generator("rcan", dtype=torch.float32, device="cpu", train=True, **FAMILIES["rcan"])
    port.load_state_dict(state_dict_from_flax("rcan", params), strict=True)
    pstate = TrainState.create(port, build_optimizer(OptimizerConfig(**cfg), lambda s: lr, device="cpu"))
    pstep = make_pretrain_step(port, "rcan", compute_dtype=torch.float32, device="cpu")
    tbatch = {k: _nchw(v) for k, v in batch.items()}
    for i in range(steps):
        pstate, m = pstep(pstate, tbatch)
        np.testing.assert_allclose([float(m["train/loss"]), float(m["grad_norm"])], want[i], rtol=1e-5)
    final = state_dict_from_flax("rcan", _np(state.params))
    for k, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["drln", "rfb_esrgan"])
def test_pre_training_with_the_generator_switched_composes_as_jax_does(name):
    """The override ``chip_smoke.py`` phase D runs (``esrgan_pre_training`` with
    ``generator=<name>`` and ``training.generator_type=<name>``): the port's
    composer gives the JAX composer's config, the family named throughout."""
    from climsr_tpu.config.compose import compose as jax_compose
    from climsr_tpu_torch.config.compose import compose, default_config_dir

    overrides = ["experiment=esrgan_pre_training", f"generator={name}", f"training.generator_type={name}"]
    got = compose(default_config_dir(), "config", overrides)
    assert got == jax_compose(default_config_dir(), "config", overrides)
    assert got["generator"]["name"] == got["training"]["generator_type"] == name
    assert got["datamodule"]["cfg"]["generator_type"] == name and got["training"]["batch_size"] == 192


# RCAN at test width: 4 steps of batch 2, one validation and test batch each
RCAN_OVERRIDES = [
    "generator.n_resgroups=1", "generator.n_resblocks=1", "generator.n_feats=8", "generator.reduction=4",
    "training.batch_size=2", "training.validation_batch_size=2", "training.num_workers=2",
    "trainer.limit_train_batches=2", "trainer.limit_val_batches=1", "trainer.limit_test_batches=1",
    "trainer.max_epochs=2", "trainer.log_every_n_steps=1", "trainer.precision=fp32", "logger=csv",
    "print_config=false",
]


def test_cli_rcan_pre_training_then_fine_tuning(tmp_path):
    """``rcan_pre_training`` fits, validates, tests and writes checkpoints;
    ``rcan_fine_tuning`` (europe extent, HR 452) grafts every tensor of its
    best checkpoint and trains on."""
    from climsr_tpu_torch.cli.train import main
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
    from climsr_tpu_torch.training import loop

    make_synthetic_dataset(tmp_path / "ds", n_tiles_per_stage=(2, 1, 1), variables=["tmax"])
    make_synthetic_dataset(tmp_path / "eu", n_tiles_per_stage=(2, 1, 1), variables=["tmax"], europe_extent=True)
    hp = main(["--device=cpu", "experiment=rcan_pre_training", *RCAN_OVERRIDES, "datamodule.cfg.world_clim_variable=tmax",
               f"datamodule.cfg.data_path={tmp_path / 'ds'}", f"training.output_dir={tmp_path / 'pre'}"])
    assert np.isfinite(hp)
    (run,) = glob.glob(f"{tmp_path}/pre/outputs/runs/rcan/*")
    assert glob.glob(f"{run}/checkpoints/*.ckpt")

    grafts = []
    init = loop.Trainer.__init__

    def keep_graft(self, *args, **kwargs):
        init(self, *args, **kwargs)
        grafts.append(self.graft)

    loop.Trainer.__init__ = keep_graft
    try:
        hp = main(["--device=cpu", "experiment=rcan_fine_tuning", *RCAN_OVERRIDES,
                   "datamodule.cfg.world_clim_variable=tmax", "trainer.max_epochs=1",
                   f"datamodule.cfg.data_path={tmp_path / 'eu'}", f"training.model_weights={run}/checkpoints",
                   f"training.output_dir={tmp_path / 'fine'}"])
    finally:
        loop.Trainer.__init__ = init
    (copied, total), = grafts
    assert copied == total > 0 and np.isfinite(hp)
