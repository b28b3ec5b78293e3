# -*- coding: utf-8 -*-
"""The port's pre-training slice against the JAX package's, on the CPU in f32.

- 3 steps of ``make_pretrain_step`` (ESRGAN nf=16 nb=1 gc=8, batch 2, LR 8x16,
  AdamW with the one-cycle lr and beta1) against the JAX step with
  ``use_pallas=True`` (Pallas kernels in interpret mode): loss, grad norm and
  the final parameters,
- every optimizer name of the config group, with clipping, accumulation and a
  cycled beta1/momentum, against the optax chain on the same gradients,
- every schedule against the JAX schedule,
- ``create_generator(train=True)``: float32 parameters under bf16 compute,
  and an inference model's numbers unchanged.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.config.schemas import OptimizerConfig as JaxOptimizerConfig
from climsr_tpu.config.schemas import SchedulerConfig as JaxSchedulerConfig
from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.training import schedules as jax_schedules
from climsr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from climsr_tpu.training.tasks.pretrain import make_pretrain_step as jax_make_pretrain_step
from climsr_tpu.training.train_state import TrainState as JaxTrainState
from climsr_tpu_torch.config.schemas import OptimizerConfig, SchedulerConfig
from climsr_tpu_torch.interop.params import state_dict_from_flax
from climsr_tpu_torch.models import apply_generator_batch, create_generator
from climsr_tpu_torch.training import schedules
from climsr_tpu_torch.training.optimizers import build_optimizer
from climsr_tpu_torch.training.tasks.pretrain import make_eval_step, make_pretrain_step
from climsr_tpu_torch.training.train_state import TrainState

torch.set_num_threads(1)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _batch(rng, n=2, h=8, w=16):
    return {
        "lr": rng.normal(size=(n, h, w, 3)).astype(np.float32),
        "hr": rng.normal(size=(n, 4 * h, 4 * w, 1)).astype(np.float32),
        "elevation": rng.normal(size=(n, 4 * h, 4 * w, 1)).astype(np.float32),
        "mask": (rng.random((n, 4 * h, 4 * w, 1)) > 0.3).astype(np.float32),
    }


def test_three_pretrain_steps_match_the_jax_pallas_step(rng):
    """Loss and grad norm to 1e-5 relative, parameters to 1e-6 absolute (about
    1e-3 of the lr: AdamW's normalised update carries the f32 differences of
    the gradient's summation order)."""
    batch = _batch(rng)
    lr, steps = 1e-3, 3
    jax_sched = JaxSchedulerConfig(name="one_cycle_schedule", max_lr=lr, num_training_steps=10)
    model = jax_create_generator("esrgan", nf=16, nb=1, gc=8, out_channels=1, use_pallas=True, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), batch["lr"], batch["elevation"], batch["mask"])["params"]
    tx = jax_build_optimizer(JaxOptimizerConfig(name="adamw", lr=lr, weight_decay=1e-4),
                             jax_schedules.resolve_schedule(jax_sched, lr, 10),
                             b1_schedule=jax_schedules.resolve_momentum_schedule(jax_sched, 10))
    state = JaxTrainState.create(params, tx)
    step = jax_make_pretrain_step(model, "esrgan", tx, compute_dtype=jnp.float32, donate=False)
    want = []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append((float(m["train/loss"]), float(m["grad_norm"])))

    sched = SchedulerConfig(name="one_cycle_schedule", max_lr=lr, num_training_steps=10)
    port = create_generator("esrgan", dtype=torch.float32, device="cpu", train=True, nf=16, nb=1, gc=8,
                            out_channels=1)
    port.load_state_dict(state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, params)), strict=True)
    ptx = build_optimizer(OptimizerConfig(name="adamw", lr=lr, weight_decay=1e-4),
                          schedules.resolve_schedule(sched, lr, 10),
                          b1_schedule=schedules.resolve_momentum_schedule(sched, 10), device="cpu")
    pstate = TrainState.create(port, ptx)
    pstep = make_pretrain_step(port, "esrgan", compute_dtype=torch.float32, device="cpu")
    tbatch = {k: _nchw(v) for k, v in batch.items()}
    for i in range(steps):
        pstate, m = pstep(pstate, tbatch)
        np.testing.assert_allclose([float(m["train/loss"]), float(m["grad_norm"])], want[i], rtol=1e-5)
    assert pstate.step == steps and pstate.optimizer.updates == steps
    final = state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, state.params))
    for k, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


OPTIMIZERS = [
    pytest.param(dict(name=name), {}, id=name)
    for name in ("adam", "fusedadam", "adamw", "adamax", "adadelta", "adagrad", "rmsprop", "sgd", "asgd", "rprop")
] + [
    pytest.param(dict(name="adam"), dict(gradient_clip_val=0.5), id="adam-clip"),
    pytest.param(dict(name="adamw"), dict(accumulate_grad_batches=2), id="adamw-accumulate2"),
    pytest.param(dict(name="adamw"), dict(b1=True), id="adamw-one-cycle-beta1"),
    pytest.param(dict(name="sgd", momentum=0.9), dict(b1=True), id="sgd-momentum-one-cycle"),
    pytest.param(dict(name="rmsprop", momentum=0.9), dict(b1=True, gradient_clip_val=0.5), id="rmsprop-momentum"),
    pytest.param(dict(name="adagrad", weight_decay=0.0), dict(accumulate_grad_batches=3), id="adagrad-accumulate3"),
]


@pytest.mark.parametrize("cfg,opts", OPTIMIZERS)
def test_optimizer_matches_the_optax_chain(rng, cfg, opts):
    """6 updates on the same gradients (which flip sign, for rprop). Params to
    2e-6 absolute: f32 rounding only (torch's Adam divides by the bias
    corrections in another order than optax), about 3e-5 of the 6e-2 the
    parameters move."""
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * (-1) ** i for k, s in shapes.items()} for i in range(6)]
    schedule = lambda s: 1e-2 * (1.0 + 0.1 * s)  # noqa: E731
    b1 = (lambda s: 0.9 - 0.01 * s) if opts.get("b1") else None  # noqa: E731
    kwargs = dict(gradient_clip_val=opts.get("gradient_clip_val", 0.0),
                  accumulate_grad_batches=opts.get("accumulate_grad_batches", 1), b1_schedule=b1)
    full = dict(dict(lr=1e-2, weight_decay=1e-2), **cfg)
    tx = jax_build_optimizer(JaxOptimizerConfig(**full), schedule, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = build_optimizer(OptimizerConfig(**full), schedule, device="cpu", **kwargs)(tp.values())
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=2e-6, err_msg=k)


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError):
        build_optimizer(OptimizerConfig(name="lamb"), lambda s: 1e-3, device="cpu")


SCHEDULES = [
    dict(name="constant_schedule"),
    dict(name="constant_schedule_with_warmup", num_warmup_steps=3),
    dict(name="linear_schedule_with_warmup", num_warmup_steps=0.2),
    dict(name="cosine_schedule_with_warmup", num_warmup_steps=2, num_cycles=0.5),
    dict(name="cosine_with_hard_restarts_schedule_with_warmup", num_warmup_steps=2, num_cycles=2.0),
    dict(name="polynomial_decay_schedule_with_warmup", num_warmup_steps=2, power=2.0, lr_end=1e-5),
    dict(name="one_cycle_schedule", max_lr=3e-3, pct_start=0.3),
    dict(name="one_cycle_schedule", cycle_momentum=False),
]


@pytest.mark.parametrize("fields", SCHEDULES,
                         ids=lambda f: f["name"] + ("-no-momentum" if "cycle_momentum" in f else ""))
def test_schedule_matches_jax(fields):
    """To 1e-5 relative: the JAX schedules compute in float32, the port's in float64."""
    total = 17
    lr = schedules.resolve_schedule(SchedulerConfig(**fields), 1e-3, total)
    jlr = jax_schedules.resolve_schedule(JaxSchedulerConfig(**fields), 1e-3, total)
    steps = range(total + 3)
    np.testing.assert_allclose([lr(s) for s in steps], [float(jlr(s)) for s in steps], rtol=1e-5, atol=1e-12)
    mom = schedules.resolve_momentum_schedule(SchedulerConfig(**fields), total)
    jmom = jax_schedules.resolve_momentum_schedule(JaxSchedulerConfig(**fields), total)
    assert (mom is None) == (jmom is None)
    if mom is not None:
        np.testing.assert_allclose([mom(s) for s in steps], [float(jmom(s)) for s in steps], rtol=1e-5)
    assert schedules.resolve_schedule(None, 2e-3, total)(5) == 2e-3


def test_train_model_keeps_f32_params_and_computes_in_bf16(rng):
    """Fault 2: parameters and compute type are separate. A bf16 inference model
    and a train model with bf16 compute give the same numbers, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    train = create_generator("esrgan", dtype=torch.bfloat16, generator=gen, device="cpu", train=True,
                             nf=16, nb=1, gc=8, out_channels=1)
    assert train.training and train.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in train.parameters())
    infer = create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                             device="cpu", nf=16, nb=1, gc=8, out_channels=1)
    assert not infer.training and all(p.dtype == torch.bfloat16 for p in infer.parameters())
    batch = {k: _nchw(v) for k, v in _batch(rng, n=1, h=4, w=6).items()}
    with torch.inference_mode():
        a = apply_generator_batch("esrgan", train, batch, torch.bfloat16)
        b = apply_generator_batch("esrgan", infer, batch, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    sr = apply_generator_batch("esrgan", train, batch, torch.bfloat16)
    sr.float().mean().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in train.parameters())


def test_steps_refuse_options_of_later_slices():
    """``zero`` and ``spatial`` are ported (tests/test_torch_parallel.py,
    tests/test_torch_spatial.py); a malformed dict of either raises, and so
    does a ZeRO stage the state was not made at."""
    model = create_generator("esrgan", device="cpu", train=True, nf=16, nb=1, gc=8, out_channels=1)
    for option, value in (("zero", {}), ("zero", {"stage": 4}), ("zero", {"stage": 2, "shardings": None}),
                          ("spatial", {}), ("spatial", {"mesh": None, "halo": 8, "depth": 2})):
        with pytest.raises(ValueError, match=option):
            make_pretrain_step(model, "esrgan", device="cpu", **{option: value})
    step = make_pretrain_step(model, "esrgan", device="cpu", zero={"stage": 2})
    tx = build_optimizer(OptimizerConfig(name="adam", lr=1e-3), lambda s: 1e-3, device="cpu")
    with pytest.raises(ValueError, match="needs a state made with a mesh"):
        step(TrainState.create(model, tx), {})
    with pytest.raises(ValueError, match="needs a mesh"):
        TrainState.create(model, tx, zero_stage=1)
    with pytest.raises(ValueError):
        make_eval_step(model, "esrgan", device="meta")
