# -*- coding: utf-8 -*-
"""The port's RFB-ESRGAN against the benchmark's plain reference
(``perfbench/reference/rfb_esrgan.py``), on the CPU in float32, its
receptive-field-block spans, and its bias-free RDB on the RDB kernels' entry.

- seeded weights (the reference's ``seeded_params``) at 1 RRDB + 1 RRFDB, 3
  channels in and 1 out, load into the port with ``strict=True``; on a batch
  of 2 LR frames of 8 x 8 the output, the input gradient and every
  parameter's gradient agree with the reference's;
- with the recording on, a forward records one ``climsr.rfb.block`` span an
  RFB, keyed 0-17 in order, and the counter ``climsr.rfb.calls`` reads 18;
- the ``state_dict`` keys are the reference checkpoint's, with no bias;
- the bias-free RDB through ``fused_rdb`` (and ``FusedRDB``'s gradient)
  equals the module's own chain of convs;
- on a card (``cuda``, skipped here): a training step at the published
  widths launches 48 B1 and 48 B2 and no A.
"""
import sys
from pathlib import Path

import pytest
import torch

from climsr_tpu_torch.models import create_generator
from climsr_tpu_torch.models.rfb_esrgan import RFBESRGANGenerator, RFBResidualDenseBlock
from climsr_tpu_torch.ops import rdb
from climsr_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.reference import rfb_esrgan as ref  # noqa: E402

torch.set_num_threads(1)

GEN = dict(name="rfb_esrgan", num_rrdb_blocks=1, num_rrfdb_blocks=1, in_channels=3, out_channels=1,
           scaling_factor=4)
PUBLISHED = dict(GEN, num_rrdb_blocks=16, num_rrfdb_blocks=8)
WIDTHS = ("num_rrdb_blocks", "num_rrfdb_blocks", "in_channels", "out_channels", "scaling_factor")


def _model(gen=GEN, seed=3, device="cpu"):
    params = ref.seeded_params(gen, seed, torch.device(device))
    model = create_generator("rfb_esrgan", dtype=torch.float32, device=device, train=True,
                             **{k: gen[k] for k in WIDTHS})
    model.load_state_dict(params, strict=True)
    return model, params


def _lr(seed=0, n=2, h=8):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, h, h, generator=g)


def test_forward_and_gradients_match_the_reference():
    """Output to 1e-5 of its largest value; the input gradient and each
    parameter's to 1e-4 of that leaf's largest reference value: float32
    throughout, so only the summation order differs (the port's channels_last
    convs and the RDB's explicit backward algebra against autograd through
    the reference's NCHW convs), about 1e-6 relative, carried through 3 RDBs
    and 15 RFBs and back."""
    model, params = _model()
    x = _lr().contiguous(memory_format=torch.channels_last).requires_grad_(True)
    w = torch.randn(2, 1, 32, 32, generator=torch.Generator().manual_seed(1))
    out = model(x)
    (out * w).sum().backward()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    rx = x.detach().contiguous().requires_grad_(True)
    want = ref.forward(leaves, GEN, rx)
    (want * w).sum().backward()
    assert out.shape == want.shape == (2, 1, 32, 32)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(x.grad, rx.grad, rtol=0, atol=1e-4 * rx.grad.abs().max().item())
    got = dict(model.named_parameters())
    assert set(got) == set(leaves) and len(got) == 271
    for k, leaf in leaves.items():
        torch.testing.assert_close(got[k].grad, leaf.grad, rtol=0, atol=1e-4 * leaf.grad.abs().max().item() + 1e-12,
                                   msg=k)


def test_receptive_field_block_spans_and_counter():
    model, _ = _model()
    x = _lr().contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        off = model(x)
        with profiling.recording() as rec:
            with profiling.span("climsr.step.forward"):
                on = model(x)
        again = model(x)
    blocks = [s for s in rec.spans if s.name == "climsr.rfb.block"]
    assert [s.key for s in blocks] == list(range(18)) and rec.counts == {"climsr.rfb.calls": 18}
    assert all(s.parent == 0 and s.end_ns >= s.start_ns > 0 for s in blocks)
    assert len(rec.spans) == 19  # the forward after it records nothing
    assert torch.equal(off, on) and torch.equal(off, again)


def test_state_dict_keys_are_the_reference_checkpoints_with_no_bias():
    with torch.device("meta"):
        port = RFBESRGANGenerator(**{k: PUBLISHED[k] for k in WIDTHS})
    keys = list(port.state_dict())
    assert keys == [name for name, _, _ in ref.param_shapes(PUBLISHED)] and len(keys) == 1966
    assert not [k for k in keys if k.endswith(".bias")]
    assert [k for k in keys if k.startswith("Trunk_A.15.RDB3.")] == [
        f"Trunk_A.15.RDB3.conv{k}.0.weight" for k in range(1, 5)] + ["Trunk_A.15.RDB3.conv5.weight"]


@pytest.mark.parametrize("outer", [False, True], ids=["rdb", "rdb-x0"])
def test_bias_free_rdb_through_fused_rdb_is_the_modules_chain(outer):
    """The block's ``fused_rdb`` call (the plain version here, ``FusedRDB``
    with its explicit backward under autograd) against the module's own convs
    chained by hand: forward to 1e-6 and every gradient to 1e-5 of its
    largest value (float32; the backward's algebra sums in another order)."""
    torch.manual_seed(0)
    block = RFBResidualDenseBlock(16, 8)
    for p in block.parameters():
        p.data.normal_(0, 0.1)
    x, x0 = (torch.randn(2, 16, 6, 7).contiguous(memory_format=torch.channels_last) for _ in range(2))
    g = torch.randn(2, 16, 6, 7)

    def chain(v, r):
        feats = [v]
        for k in range(1, 5):
            feats.append(getattr(block, f"conv{k}")(torch.cat(feats, 1)))
        out = block.conv5(torch.cat(feats, 1)) * 0.2 + v
        return out * 0.2 + r if outer else out

    grads = []
    for run in (lambda v, r: block(v, outer_residual=r if outer else None), chain):
        block.zero_grad()
        v, r = x.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        out = run(v, r)
        (out * g).sum().backward()
        grads.append([out, v.grad] + ([r.grad] if outer else []) + [p.grad for p in block.parameters()])
    assert all(b is None for _, b in block.weights()) and len(list(block.parameters())) == 5
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels A, B1 and B2 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_published_width_step_launches_48_b1_and_48_b2(cuda_device):
    """One bf16 pre-training step of RFB-ESRGAN at 16 RRDBs + 8 RRFDBs: the
    trunk's 48 RDBs each run B1 forward and B2 backward, source-major at
    gc=32, and no A and no library conv for the trunk."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.pretrain import make_pretrain_step
    from climsr_tpu_torch.training.train_state import TrainState

    model = create_generator("rfb_esrgan", dtype=torch.bfloat16, device=cuda_device, train=True,
                             generator=torch.Generator().manual_seed(0), **{k: PUBLISHED[k] for k in WIDTHS})
    state = TrainState.create(model, build_optimizer(OptimizerConfig(name="adamw", lr=1e-4), lambda s: 1e-4,
                                                     device=cuda_device))
    step = make_pretrain_step(model, "rfb_esrgan", compute_dtype=torch.bfloat16, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"lr": torch.randn(4, 3, 32, 32, generator=g, device=cuda_device),
             "hr": torch.rand(4, 1, 128, 128, generator=g, device=cuda_device) * 2 - 1}
    batch["elevation"], batch["mask"] = batch["hr"], torch.ones_like(batch["hr"])
    counters = (rdb.fused_rdb, rdb.fused_rdb_fwd_save, rdb.fused_rdb_bwd)
    for c in counters:
        c.launches = c.source_major = 0
    state, metrics = step(state, {k: v.contiguous(memory_format=torch.channels_last) for k, v in batch.items()})
    torch.cuda.synchronize(cuda_device)
    assert [(c.launches, c.source_major) for c in counters] == [(0, 0), (48, 48), (48, 48)]
    assert torch.isfinite(metrics["train/loss"]).item()
