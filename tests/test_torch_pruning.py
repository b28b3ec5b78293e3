# -*- coding: utf-8 -*-
"""The port's pruning callbacks against the JAX package's, on the CPU.

``model_pruning`` and ``lottery_ticket`` (``ModelPruningCallback``) on one
tiny ESRGAN (nf=8, nb=1, gc=8, f32): the JAX callback on the flax params and
the port's on the same weights through ``state_dict_from_flax``, with the
same seeded "training" moves between the hooks. After each epoch end the
masks and the weights are JAX's exactly (both take L1 thresholds with
``np.partition`` on the same f32 values); the per-step re-application zeroes
the same weights; sparsity is 50% and then 75%; the lottery ticket rewinds
the survivors to the fit-start values; biases are never pruned nor rewound.
The in-place writes bump the parameters' versions, so a block's cached
kernel packing is redone.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from climsr_tpu.models import create_generator as jax_create_generator
from climsr_tpu.training.callbacks import ModelPruningCallback as JaxPruning
from climsr_tpu_torch.interop.params import state_dict_from_flax
from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.training.callbacks import CALLBACK_REGISTRY, ModelPruningCallback, build_callbacks

torch.set_num_threads(1)


class _JaxTrainer:
    def __init__(self, params):
        self.params = params

    def _generator_params(self):
        return self.params

    def _set_generator_params(self, params):
        self.params = params


class _PortTrainer:
    """One process: the generator's parameters are its own full ones."""

    generator_partition = None

    def __init__(self, model):
        self.g_model = model

    @contextlib.contextmanager
    def generator_full_params(self):
        yield self.g_model


def _tree_to_torch(tree):
    return state_dict_from_flax("esrgan", jax.tree_util.tree_map(np.asarray, tree))


def _jax_masks(cb, params):
    """JAX's masks as a torch state dict (1 kept, 0 pruned; 1 for leaves it does not prune)."""
    flat, treedef = jax.tree_util.tree_flatten(params)
    masks = jax.tree_util.tree_leaves(cb._masks, is_leaf=lambda x: x is None or isinstance(x, np.ndarray))
    ones = [np.ones(np.shape(p), np.float32) if m is None else m.astype(np.float32) for p, m in zip(flat, masks)]
    return _tree_to_torch(jax.tree_util.tree_unflatten(treedef, ones))


@pytest.mark.parametrize("lottery", [False, True], ids=["model_pruning", "lottery_ticket"])
def test_pruning_matches_jax(lottery):
    rng = np.random.default_rng(0)
    x = np.zeros((1, 4, 4, 3), np.float32)
    hr = np.zeros((1, 16, 16, 1), np.float32)
    model = jax_create_generator("esrgan", nf=8, nb=1, gc=8, out_channels=1, use_pallas=False, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x, hr, hr)["params"]
    port = create_generator("esrgan", dtype=torch.float32, device="cpu", train=True, nf=8, nb=1, gc=8,
                            out_channels=1)
    port.load_state_dict(_tree_to_torch(params), strict=True)
    jt, pt = _JaxTrainer(params), _PortTrainer(port)
    jcb = JaxPruning(use_lottery_ticket_hypothesis=lottery)
    pcb = ModelPruningCallback(use_lottery_ticket_hypothesis=lottery)
    jcb.on_fit_start(jt)
    pcb.on_fit_start(pt)
    prunable = {k for k, p in port.named_parameters() if p.ndim >= 2}
    biases0 = {k: p.detach().clone() for k, p in port.named_parameters() if k not in prunable}

    def train(scale):
        """The same seeded move of every weight on both sides (an optimizer's stand-in)."""
        delta = jax.tree_util.tree_map(lambda p: (scale * rng.normal(size=np.shape(p))).astype(np.float32),
                                       jt.params)
        jt.params = jax.tree_util.tree_map(lambda p, d: jnp.asarray(np.asarray(p) + d), jt.params, delta)
        with torch.no_grad():
            for k, d in _tree_to_torch(delta).items():
                port.state_dict()[k].add_(d)

    for epoch, sparsity in ((0, 0.5), (1, 0.75)):
        train(0.05)
        versions = {k: p._version for k, p in port.named_parameters()}
        jcb.on_train_epoch_end(jt, epoch)
        pcb.on_train_epoch_end(pt, epoch)
        want = _tree_to_torch(jt.params)
        masks = _jax_masks(jcb, jt.params)
        for k, p in port.named_parameters():
            assert torch.equal(p.detach(), want[k]), k
            if k in prunable:
                assert np.array_equal(pcb._masks[k], masks[k].numpy().astype(bool)), k
                assert p._version > versions[k]  # a cached kernel packing of p is stale now
            else:
                assert (masks[k] == 1).all()
        assert pcb.sparsity == pytest.approx(sparsity, abs=0.01)
        zeros = sum(int((port.state_dict()[k] == 0).sum()) for k in prunable)
        assert zeros / sum(port.state_dict()[k].numel() for k in prunable) == pytest.approx(pcb.sparsity, abs=1e-6)
        # the per-step re-application after the weights move off zero
        train(0.01)
        jcb.on_train_batch_end(jt)
        pcb.on_train_batch_end(pt)
        want = _tree_to_torch(jt.params)
        for k, p in port.named_parameters():
            assert torch.equal(p.detach(), want[k]), k
            if k in prunable:
                assert (p.detach()[torch.from_numpy(~pcb._masks[k])] == 0).all()
    if lottery:  # the survivors hold their fit-start values, the biases their trained ones
        start = _tree_to_torch(params)
        for k in prunable:
            keep = torch.from_numpy(pcb._masks[k])
            moved = port.state_dict()[k][keep] - start[k][keep]
            assert moved.abs().max() < 0.05  # one 0.01 move since the rewind, not 0.12 of training
    for k, b0 in biases0.items():
        assert not torch.equal(port.state_dict()[k], b0)  # trained, never pruned or rewound


def test_registry_builds_the_pruning_callbacks():
    cbs = build_callbacks(["model_pruning", "lottery_ticket"])
    assert [type(cb) for cb in cbs] == [ModelPruningCallback, ModelPruningCallback]
    assert [cb.use_lottery_ticket_hypothesis for cb in cbs] == [False, True] and cbs[0].amount == 0.5
    assert {"model_pruning", "lottery_ticket"} <= set(CALLBACK_REGISTRY)


def test_pruned_esrgan_repacks_its_kernel_weights():
    """A block's cached packing is keyed by each parameter's (data pointer,
    version): the in-place pruning writes change the key, so the next
    launch packs the pruned weights (kernels A, B1 and B2 read the packing)."""
    port = create_generator("esrgan", dtype=torch.float32, device="cpu", train=True, nf=16, nb=1, gc=16,
                            out_channels=1, generator=torch.Generator().manual_seed(0))
    block = port.RRDB_trunk[0].RDB1
    before = block.packed_weights(torch.bfloat16)
    assert block.packed_weights(torch.bfloat16) is before  # cached while nothing changes
    cb = ModelPruningCallback()
    cb.on_train_epoch_end(_PortTrainer(port), 0)
    after = block.packed_weights(torch.bfloat16)
    assert after is not before and not torch.equal(after.w, before.w)
    cb.on_train_batch_end(_PortTrainer(port))
    assert block.packed_weights(torch.bfloat16) is not after
