# -*- coding: utf-8 -*-
"""The training step's gradient tail on the CPU: the global norm and the
fused Adam/AdamW update of ``training/optimizers.py``.

- the version contract: after one update every parameter's ``_version`` has
  advanced, so an RDB's packed kernel weights (cached by data pointer and
  version) are packed anew from the updated weights;
- the fused update against torch's for-loop update, five steps under the
  one-cycle lr and beta1 of the pre-training cells; a ``state_dict`` round
  trip, a state saved by another implementation and an optax state load into
  it and step;
- ``global_norm`` against the per-leaf formula, in a number of dispatched ops
  that does not grow with the leaves, and the clip that scales by it.
"""
import copy
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from climsr_tpu_torch.config.schemas import OptimizerConfig, SchedulerConfig
from climsr_tpu_torch.interop.params import _optimizer_state
from climsr_tpu_torch.models.esrgan import ResidualDenseBlock
from climsr_tpu_torch.ops.rdb import pack_rdb_weights
from climsr_tpu_torch.training import schedules
from climsr_tpu_torch.training.optimizers import build_optimizer, global_norm

torch.set_num_threads(1)

SHAPES = [(16, 8, 3, 3), (16,), (1, 24, 3, 3), (1,), (5, 7)]
# the one-cycle lr and beta1 of perfbench/traffic/pretrain-b192.json (AdamW, lr 1e-4)
ONE_CYCLE = SchedulerConfig(name="one_cycle_schedule", max_lr=1e-4, pct_start=0.05, div_factor=2.0,
                            final_div_factor=100.0, base_momentum=0.85, max_momentum=0.95)
TOTAL_STEPS = 20  # the warm-up ends at step 1, so five steps climb and descend


def _spec(name, weight_decay=1e-4, **kwargs):
    return build_optimizer(OptimizerConfig(name=name, lr=1e-4, weight_decay=weight_decay, betas=(0.9, 0.999),
                                           eps=1e-8),
                           schedules.resolve_schedule(ONE_CYCLE, 1e-4, TOTAL_STEPS),
                           b1_schedule=schedules.resolve_momentum_schedule(ONE_CYCLE, TOTAL_STEPS), device="cpu",
                           **kwargs)


def _params():
    g = torch.Generator().manual_seed(0)
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in SHAPES]


def _grads(step, params):
    g = torch.Generator().manual_seed(1000 + step)
    return [torch.randn(p.shape, generator=g) * 10.0 ** (k % 3 - 2) for k, p in enumerate(params)]


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_update_advances_versions_and_the_rdb_packing_is_rebuilt(name):
    rdb = ResidualDenseBlock(nf=16, gc=8)
    params = list(rdb.parameters())
    opt = _spec(name)(params)
    assert opt.fused
    before = rdb.packed_weights(torch.float32)
    assert rdb.packed_weights(torch.float32) is before  # cached while nothing changes
    versions = [p._version for p in params]
    rdb(torch.randn(2, 16, 6, 6)).square().mean().backward()
    opt.step()
    assert all(p._version > v for p, v in zip(params, versions))
    after = rdb.packed_weights(torch.float32)
    fresh = pack_rdb_weights(rdb.weights(), torch.float32)
    assert after is not before
    assert torch.equal(after.w, fresh.w) and torch.equal(after.b, fresh.b)
    assert not torch.equal(before.w, fresh.w)  # the step moved the weights the stale packing held


def _reference(name, params, weight_decay):
    """torch's for-loop Adam/AdamW with the schedules set as the chain sets them."""
    cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
    return cls(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, foreach=False)


def _reference_step(opt, i):
    for group in opt.param_groups:
        group["lr"] = schedules.resolve_schedule(ONE_CYCLE, 1e-4, TOTAL_STEPS)(i)
        group["betas"] = (schedules.resolve_momentum_schedule(ONE_CYCLE, TOTAL_STEPS)(i), group["betas"][1])
    opt.step()


def _assert_close(a, b):
    np.testing.assert_allclose(a.detach().double().numpy(), b.detach().double().numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4], ids=["wd0", "wd1e-4"])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_fused_update_matches_the_for_loop_update(name, weight_decay):
    """Five steps: parameters and both moments to 1e-6 relative."""
    fused_params, ref_params = _params(), _params()
    opt = _spec(name, weight_decay)(fused_params)
    ref = _reference(name, ref_params, weight_decay)
    assert opt.fused and opt.inner.param_groups[0]["fused"]
    for i in range(5):
        for p, q, g in zip(fused_params, ref_params, _grads(i, fused_params)):
            p.grad, q.grad = g.clone(), g.clone()
        opt.step()
        _reference_step(ref, i)
    assert opt.updates == 5
    for p, q in zip(fused_params, ref_params):
        _assert_close(p, q)
        for key in ("exp_avg", "exp_avg_sq"):
            _assert_close(opt.inner.state[p][key], ref.state[q][key])


def _relaid(t):
    return t.transpose(0, -1).contiguous().transpose(0, -1) if t.dim() > 1 else t


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


@pytest.mark.parametrize("param_layout, tensor_layout", [(lambda t: t, _relaid), (_channels_last, lambda t: t)],
                         ids=["relaid-tensors", "channels_last-params"])
def test_fused_update_takes_gradients_and_moments_in_another_layout(param_layout, tensor_layout):
    """Gradients and loaded moments laid out unlike their parameters (the
    models' ``channels_last`` convolutions against an orbax state's plain
    OIHW moments or a ZeRO shard's gradient): the update is still the
    for-loop one (torch's fused kernel walks each tensor's memory in order)."""
    fused_params, ref_params = _params(), _params()
    opt = _spec("adamw")(fused_params)
    ref = _reference("adamw", ref_params, 1e-4)
    for i in range(2):
        for p, q, g in zip(fused_params, ref_params, _grads(i, fused_params)):
            p.grad, q.grad = g.clone(), g.clone()
        opt.step()
        _reference_step(ref, i)
    state = copy.deepcopy(opt.state_dict())
    for s in state["state"].values():
        s["exp_avg"], s["exp_avg_sq"] = tensor_layout(s["exp_avg"]), tensor_layout(s["exp_avg_sq"])
    params = [torch.nn.Parameter(param_layout(p.detach().clone())) for p in fused_params]
    assert any(s["exp_avg"].stride() != p.stride() for s, p in zip(state["state"].values(), params))
    loaded = _spec("adamw")(params)
    loaded.load_state_dict(state)
    for p, q, g in zip(params, ref_params, _grads(2, params)):
        p.grad, q.grad = tensor_layout(g.clone()), g.clone()
    loaded.step()
    _reference_step(ref, 2)
    for p, q in zip(params, ref_params):
        _assert_close(p, q)
        for key in ("exp_avg", "exp_avg_sq"):
            _assert_close(loaded.inner.state[p][key], ref.state[q][key])


@pytest.mark.parametrize("source", ["fused", "for-loop", "float-step"])
def test_saved_state_loads_into_the_fused_optimizer_and_steps(source):
    """A fused optimizer's own state, one saved by torch's other
    implementations (``fused`` unset in its groups), and one whose ``step`` is
    a Python number: the loaded optimizer stays fused, its ``step`` is a
    float32 tensor, and its next update is the saved optimizer's."""
    saved_params = _params()
    saved = _spec("adamw")(saved_params)
    if source != "fused":
        saved.inner = _reference("adamw", saved_params, 1e-4)
        saved.fused = False
    for i in range(2):
        for p, g in zip(saved_params, _grads(i, saved_params)):
            p.grad = g
        saved.step()
    state = copy.deepcopy(saved.state_dict())
    if source == "float-step":
        for s in state["state"].values():
            s["step"] = float(s["step"])
    assert state["param_groups"][0]["fused"] is (True if source == "fused" else None)

    params = [torch.nn.Parameter(p.detach().clone()) for p in saved_params]
    opt = _spec("adamw")(params)
    opt.load_state_dict(state)
    assert opt.fused and opt.inner.param_groups[0]["fused"] is True and opt.updates == 2
    for p in params:
        step = opt.inner.state[p]["step"]
        assert torch.is_tensor(step) and step.dtype == torch.float32 and float(step) == 2.0
    for p, q, g in zip(params, saved_params, _grads(2, params)):
        p.grad, q.grad = g.clone(), g.clone()
    opt.step()
    saved.step()
    for p, q in zip(params, saved_params):
        _assert_close(p, q)


def test_optax_state_loads_into_the_fused_optimizer_and_steps():
    """An optax adamw state (``scale_by_adam``'s count, mu and nu, then the
    decay and the lr), as ``payload_from_jax_state`` converts it: it loads,
    stays fused, and steps as a for-loop AdamW holding the same moments."""
    params = _params()
    names = [f"p{k}" for k in range(len(params))]
    rng = np.random.default_rng(0)
    mu = {n: rng.normal(size=tuple(p.shape)).astype(np.float32) * 1e-3 for n, p in zip(names, params)}
    nu = {n: rng.random(size=tuple(p.shape)).astype(np.float32) * 1e-6 for n, p in zip(names, params)}
    optax_state = [{"count": np.int32(3), "mu": mu, "nu": nu}, (), {"count": np.int32(3)}]
    state = _optimizer_state(optax_state, lambda t: {n: torch.from_numpy(np.array(t[n])) for n in names},
                             len(params), 3)
    assert state["chain"]["from_jax"] == "adam"

    opt = _spec("adamw")(params)
    opt.load_state_dict(state)
    assert opt.fused and opt.inner.param_groups[0]["fused"] is True and opt.updates == 3
    ref_params = [torch.nn.Parameter(p.detach().clone()) for p in params]
    ref = _reference("adamw", ref_params, 1e-4)
    for q, n in zip(ref_params, names):
        ref.state[q] = {"step": torch.tensor(3.0), "exp_avg": torch.from_numpy(mu[n].copy()),
                        "exp_avg_sq": torch.from_numpy(nu[n].copy())}
    for p, q, g in zip(params, ref_params, _grads(3, params)):
        p.grad, q.grad = g.clone(), g.clone()
    opt.step()
    _reference_step(ref, 3)
    for p, q in zip(params, ref_params):
        _assert_close(p, q)


def _per_leaf_norm(grads):
    return math.sqrt(sum(float(g.double().square().sum()) for g in grads if g is not None))


def test_global_norm_is_the_per_leaf_formula_in_f32():
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(s, generator=g) * 10.0 ** (k % 4 - 2) for k, s in enumerate(SHAPES + [(64, 64, 3, 3)])]
    grads.insert(2, None)  # a leaf without a gradient is skipped
    norm = global_norm(grads)
    assert norm.dtype == torch.float32 and norm.shape == ()
    np.testing.assert_allclose(float(norm), _per_leaf_norm(grads), rtol=1e-6)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_global_norm_dispatches_as_many_ops_for_700_leaves_as_for_10():
    counts = []
    for n in (10, 700):
        grads = [torch.full((3, 2), 0.5) for _ in range(n)]
        with _Ops() as mode:
            norm = global_norm(grads)
        counts.append(len(mode.ops))
        np.testing.assert_allclose(float(norm), math.sqrt(n * 6 * 0.25), rtol=1e-6)
    assert counts[0] == counts[1] <= 4


@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clips", "does-not-clip"])
@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_clip_scales_as_the_per_leaf_formula(name, clip):
    """The gradients that reach the inner update: scaled by clip / norm where
    the norm is not under the clip (the host-summed formula), else as given."""
    params = _params()
    opt = _spec(name, gradient_clip_val=clip)(params)
    grads = _grads(0, params)
    norm = _per_leaf_norm(grads)
    assert (norm > clip) == (clip == 0.5)
    want = [g * (clip / norm) for g in grads] if not norm < clip else grads
    seen = []
    inner_step = opt.inner.step
    opt.inner.step = lambda: (seen.extend(p.grad.clone() for p in params), inner_step())
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt.step()
    assert len(seen) == len(params)
    for s, w in zip(seen, want):
        _assert_close(s, w)
