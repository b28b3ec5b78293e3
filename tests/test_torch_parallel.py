# -*- coding: utf-8 -*-
"""The port's mesh, halo and ZeRO code on 4 gloo ranks of the CPU, against the
JAX package on its virtual CPU mesh (``create_mesh(4, ...)``) and against the
single-process port.

One group of 4 ranks runs per file (``parallel.launch.spawn`` of
``climsr_tpu_torch.parallel.cases:main``, fresh interpreters that import no
JAX): the module fixture writes the seeded numpy inputs, the ranks write
their results, and each test reads them.

- ``halo_exchange_pad`` and ``_halo_pad_reflect`` (values, and the gradient
  through the exchange), ``sharded_conv2d`` at 3x3 and 5x5 and
  ``spatial_sharded_apply(_multi)`` against the JAX functions, atol 1e-5 /
  1e-6 as ``tests/test_parallel.py``; even kernels are rejected;
- the ZeRO rules against the JAX rules through the layout map of
  ``interop/params.py``; ``process_local_slice`` and ``broadcast_string``
  with their guards;
- 3 pre-training steps at ZeRO stages 0-3 and 2 GAN steps at stages 0 and 2
  (nf=32, gc=16, nb=1) against the single-process port on the
  global batch: losses at rtol 1e-5 (data parallel) and 1e-6 (ZeRO), the
  parameters, and the discriminator's batch statistics;
- the eval step and the GAN validation losses with each batch split over the
  ranks against one process on the whole batch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from climsr_tpu.parallel import halo as jax_halo
from climsr_tpu.parallel.mesh import create_mesh as jax_create_mesh
from climsr_tpu_torch.parallel import halo as H
from climsr_tpu_torch.parallel.launch import spawn
from climsr_tpu_torch.parallel.mesh import (
    broadcast_string,
    process_local_slice,
    shard_largest_divisible_dim,
    shard_leading_dim_if_divisible,
)

torch.set_num_threads(1)
RANKS = 4


def _inputs(rng):
    return {
        "halo_x": rng.normal(size=(2, 32, 8, 3)).astype(np.float32),
        "halo_probe_zero": rng.normal(size=(2, RANKS * 12, 8, 3)).astype(np.float32),
        "halo_probe_reflect": rng.normal(size=(2, RANKS * 14, 8, 3)).astype(np.float32),
        "conv_x": rng.normal(size=(1, 40, 16, 2)).astype(np.float32),
        "conv_k3": (rng.normal(size=(3, 3, 2, 4)) * 0.1).astype(np.float32),
        "conv_k5": (rng.normal(size=(5, 5, 2, 4)) * 0.1).astype(np.float32),
        "apply_x": rng.normal(size=(1, 64, 16, 1)).astype(np.float32),
        "apply_k": (rng.normal(size=(3, 3, 1, 2)) * 0.3).astype(np.float32),
        "apply_e": rng.normal(size=(1, 256, 64, 2)).astype(np.float32),
        # pre-training: a store of 16 raw 32-px tiles, 3 global index batches of 8
        "store_hr": rng.normal(size=(16, 32, 32, 1)).astype(np.float32),
        "store_elevation": rng.normal(size=(16, 32, 32, 1)).astype(np.float32),
        "store_mask": (rng.random((16, 32, 32, 1)) > 0.3).astype(np.float32),
        "indices": np.stack([rng.permutation(16)[:8] for _ in range(3)]).astype(np.int64),
        # GAN: 2 global batches of 8
        "gan_lr": rng.normal(size=(2, 8, 8, 8, 3)).astype(np.float32),
        "gan_hr": rng.normal(size=(2, 8, 32, 32, 1)).astype(np.float32),
        "gan_elevation": rng.normal(size=(2, 8, 32, 32, 1)).astype(np.float32),
        "gan_mask": (rng.random((2, 8, 32, 32, 1)) > 0.3).astype(np.float32),
        "bn_hr": rng.normal(size=(8, 32, 32, 1)).astype(np.float32),
    }


def _with_sr(inp):
    inp["bn_sr"] = (inp["bn_hr"] + 0.3 * np.random.default_rng(8).normal(size=inp["bn_hr"].shape)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the suites once on 4 gloo ranks; returns (inputs, {suite: [per-rank results]})."""
    workdir = tmp_path_factory.mktemp("ranks")
    inp = _with_sr(_inputs(np.random.default_rng(7)))
    np.savez(workdir / "inputs.npz", **inp)
    suites = ["halo", "zero", "gan", "eval"]
    spawn("climsr_tpu_torch.parallel.cases:main", RANKS, {"workdir": str(workdir), "suites": suites},
          env={"OMP_NUM_THREADS": "1"}, timeout=600)
    return inp, {s: [dict(np.load(workdir / f"{s}_rank{r}.npz")) for r in range(RANKS)] for s in suites}


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_create_mesh(RANKS, ("data",))


def _cat(results, key):
    return np.concatenate([r[key] for r in results], axis=1)


def _shard_mapped(mesh, fn, n_in=1):
    spec = P(None, "data", None, None)
    return shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in, out_specs=spec)


@pytest.mark.parametrize("name,halo", [("zero", 2), ("reflect", 3)])
def test_halo_pads_and_their_gradient_match_jax(ranks, jax_mesh, name, halo):
    inp, res = ranks
    fn = jax_halo.halo_exchange_pad if name == "zero" else jax_halo._halo_pad_reflect
    pad = _shard_mapped(jax_mesh, lambda xl: fn(xl, halo, "data"))
    x = jnp.asarray(inp["halo_x"])
    np.testing.assert_allclose(_cat(res["halo"], f"pad_{name}"), np.asarray(pad(x)), atol=1e-6)
    grad = jax.grad(lambda v: jnp.sum(pad(v) * inp[f"halo_probe_{name}"]))(x)
    np.testing.assert_allclose(_cat(res["halo"], f"grad_{name}"), np.asarray(grad), atol=1e-5)


@pytest.mark.parametrize("k", ["k3", "k5"])
def test_sharded_conv2d_matches_jax(ranks, jax_mesh, k):
    inp, res = ranks
    want = jax_halo.sharded_conv2d(jnp.asarray(inp["conv_x"]), jnp.asarray(inp[f"conv_{k}"]), jax_mesh)
    np.testing.assert_allclose(_cat(res["halo"], f"conv_{k}"), np.asarray(want), atol=1e-5)


def test_sharded_conv2d_rejects_even_kernels():
    with pytest.raises(ValueError, match="odd kernel"):
        H.sharded_conv2d(torch.zeros(1, 2, 16, 8), torch.zeros(4, 2, 2, 3), None)


def _jax_sr(kernel):
    from climsr_tpu.ops.resize import nearest_upsample

    def sr(x, e=None):
        dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape, ("NHWC", "HWIO", "NHWC"))
        y = nearest_upsample(jax.lax.conv_general_dilated(x, kernel, (1, 1), "SAME", dimension_numbers=dn), 4)
        return y if e is None else y + e

    return sr


@pytest.mark.parametrize("key,halo", [("apply", 4), ("apply_halo0", 0)])
def test_spatial_sharded_apply_matches_jax(ranks, jax_mesh, key, halo):
    inp, res = ranks
    fn = jax_halo.spatial_sharded_apply(_jax_sr(jnp.asarray(inp["apply_k"])), jax_mesh, halo=halo, scale=4)
    np.testing.assert_allclose(_cat(res["halo"], key), np.asarray(fn(jnp.asarray(inp["apply_x"]))), atol=1e-6)


def test_spatial_sharded_apply_multi_matches_jax(ranks, jax_mesh):
    inp, res = ranks
    fn = jax_halo.spatial_sharded_apply_multi(_jax_sr(jnp.asarray(inp["apply_k"])), jax_mesh, halo=4, scale=4,
                                              input_scales=(1, 4))
    want = fn(jnp.asarray(inp["apply_x"]), jnp.asarray(inp["apply_e"]))
    np.testing.assert_allclose(_cat(res["halo"], "apply_multi"), np.asarray(want), atol=1e-6)


def test_process_local_slice_and_broadcast_string_across_ranks(ranks):
    _, res = ranks
    for r, out in enumerate(res["halo"]):
        assert tuple(out["local_slice"]) == (2 * r, 2 * r + 2)
        assert int(out["local_slice_guard"]) == 1  # 6 rows over 4 ranks raise
        assert bytes(out["broadcast"]).decode() == "run-of-rank-0"


def test_put_global_moves_each_ranks_slice(ranks):
    _, res = ranks
    for r, out in enumerate(res["halo"]):
        np.testing.assert_array_equal(out["put_global"], [2 * r, 2 * r + 1])
        assert float(out["put_global_scalar"]) == 3.0
        np.testing.assert_array_equal(out["put_replicated"], [0, 1, 2])


def test_input_helpers_on_one_process():
    assert process_local_slice(6) == slice(0, 6)
    assert broadcast_string("x" * 256) == "x" * 256
    with pytest.raises(ValueError, match="exceeds max_len"):
        broadcast_string("x" * 257)


def test_zero_rules_match_jax_through_the_layout_map(jax_mesh):
    """The port's rules on OIHW tensors pick the JAX rule's dim through
    HWIO -> OIHW, except on ties (the first largest dim in each layout)."""
    from climsr_tpu.parallel.mesh import shard_largest_divisible_dim as jax_largest
    from climsr_tpu.parallel.mesh import shard_leading_dim_if_divisible as jax_leading

    hwio_to_oihw = {0: 2, 1: 3, 2: 1, 3: 0}
    tree = {"conv_kernel": (3, 3, 64, 48), "leading": (512, 7), "none_divisible": (3, 3, 7, 5),
            "small": (8, 8), "tie": (3, 3, 64, 64)}
    jax_tree = {k: jnp.zeros(v) for k, v in tree.items()}
    torch_tree = {k: (v[3], v[2], v[0], v[1]) if len(v) == 4 else v for k, v in tree.items()}
    for jax_rule, rule in ((jax_largest, shard_largest_divisible_dim),
                           (jax_leading, shard_leading_dim_if_divisible)):
        want = jax_rule(jax_tree, jax_mesh, min_size=1024)
        got = rule(torch_tree, jax_mesh.shape["data"], min_size=1024)
        for k, v in tree.items():
            spec = tuple(want[k].spec)
            jax_dim = spec.index("data") if "data" in spec else None
            mapped = None if jax_dim is None else (hwio_to_oihw[jax_dim] if len(v) == 4 else jax_dim)
            if k == "tie" and rule is shard_largest_divisible_dim:
                assert (jax_dim, got[k]) == (2, 0)  # cin in HWIO, cout in OIHW: the elementwise update is the same
            elif rule is shard_leading_dim_if_divisible and len(v) == 4:
                assert got[k] == (0 if torch_tree[k][0] % RANKS == 0 and np.prod(v) >= 1024 else None)
            else:
                assert got[k] == mapped, k
    assert shard_largest_divisible_dim({"w": (64, 64, 3, 3)}, 4)["w"] == 0
    assert shard_largest_divisible_dim({"w": (16, 16, 3, 3)}, 4)["w"] is None  # under 2**14 elements


@pytest.fixture(scope="module")
def single(ranks):
    """The single-process port on the same global batches."""
    from climsr_tpu_torch.parallel.cases import flat_results, gan_run, pretrain_run

    inp, _ = ranks
    state, metrics = pretrain_run(inp, 0, None)
    out = flat_results("s", metrics, [("g", state.model)])
    state, metrics = gan_run(inp, 0, None)
    out.update(flat_results("gan", metrics, [("g", state.g_model), ("d", state.d_model)]))
    return out


def _compare(got, want, prefix_got, prefix_want, loss_rtol, param_atol):
    """The first step's metrics at ``loss_rtol`` (the JAX tests' one-step
    tolerance), later steps' at 1e-5 (they start from parameters that differ
    by the f32 summation order of the gradients); parameters and BatchNorm
    statistics at ``param_atol``."""
    keys = [k for k in want if k.startswith(prefix_want + "/")]
    assert keys
    for k in keys:
        g = got[prefix_got + k[len(prefix_want):]]
        if "/metric/" in k:
            np.testing.assert_allclose(g[0], want[k][0], rtol=loss_rtol, err_msg=k)
            np.testing.assert_allclose(g[1:], want[k][1:], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(g, want[k], atol=param_atol, err_msg=k)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_dp_and_zero_pretrain_steps_match_the_single_process_step(ranks, single, stage):
    """3 steps (store, augmentation drawn for the global batch, Adam with a
    clip on the global norm): the first step's loss and grad norm at rtol
    1e-5 (DP) / 1e-6 (ZeRO), parameters at atol 1e-6, on every rank."""
    _, res = ranks
    for out in res["zero"]:
        _compare(out, single, f"s{stage}", "s", 1e-5 if stage == 0 else 1e-6, param_atol=1e-6)
        # the three conv5 (32 x 96 x 3 x 3) have 2**14 elements or more
        assert int(out[f"s{stage}/sharded"]) == (0 if stage == 0 else 3)
    if stage == 2:  # a checkpoint's optimizer state: full shapes, and back to the same shards
        assert all(bool(out["opt_full_shapes_match"]) and bool(out["opt_roundtrip_equal"]) for out in res["zero"])
    if stage == 3:
        total = sum(v.size for k, v in single.items() if k.startswith("s/g/"))
        for out in res["zero"]:
            assert int(out["s3/full_grads"]) == 0  # no rank keeps a full gradient
            assert int(out["s3/shard_grad_elems"]) < total


@pytest.mark.parametrize("stage", [0, 2])
def test_dp_and_zero_gan_steps_match_the_single_process_step(ranks, single, stage):
    """2 GAN steps: every loss term, G and D parameters, and D's BatchNorm
    running statistics (taken over the global batch). The generator's output
    is scaled to the targets' range (``cases.gan_run``): an untrained one
    leaves a channel of D's BatchNorm with a variance under its eps, where no
    two f32 summation orders of the statistics agree (~0.2% of D's gradient)."""
    _, res = ranks
    for out in res["gan"]:
        _compare(out, single, f"gan{stage}", "gan", 1e-5 if stage == 0 else 1e-6, param_atol=1e-6)
    assert any("running_var" in k for k in single)


@pytest.mark.parametrize("n", [8, 5, 2], ids=["divides", "ragged", "fewer-than-ranks"])
def test_eval_split_over_ranks_matches_the_single_process_eval(ranks, n):
    """The eval step's 18 metrics and the GAN validation losses with each
    batch split over the 4 ranks (the generator and D on a rank's share, the
    outputs all-gathered) against one process on the whole batch, on every
    rank: rtol 1e-5."""
    from climsr_tpu_torch.parallel.cases import eval_run

    inp, res = ranks
    want = {k: v for k, v in eval_run(inp).items() if k.startswith(f"eval{n}/")}
    assert len(want) == 21
    for out in res["eval"]:
        for k, v in want.items():
            np.testing.assert_allclose(out[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_discriminator_gradient_with_batch_statistics_over_ranks(ranks):
    """The D step's gradient and D's running statistics after it, the
    BatchNorm statistics all-reduced over the 4 ranks and the scores centred
    on the global means, against one process on the global batch: 1e-6 (f32)."""
    from climsr_tpu_torch.parallel.cases import d_step_gradient

    inp, res = ranks
    want = d_step_gradient(inp, None)
    for out in res["gan"]:
        np.testing.assert_allclose(out["d_grad"], want, atol=1e-6, rtol=0)
