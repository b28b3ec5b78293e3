# -*- coding: utf-8 -*-
"""The discriminator's chain between convolutions (``ops/d_tail.py``).

On the CPU the wrappers run their plain versions: they are held against the
module chain they replace (conv, bias, LeakyReLU, ``TorchBatchNorm``,
``nn.ReflectionPad2d``), in f32 and bf16, forward, running statistics and every
gradient; their hand-written backward against ``gradcheck`` in f64; and
``Discriminator.fused_features`` against ``feature_extraction``. The tests
marked ``cuda`` hold the kernels against the plain versions at D's shapes on a
card and skip without one.
"""
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from climsr_tpu_torch.models.common import TorchBatchNorm, TorchConv, init_torch_default_
from climsr_tpu_torch.models.discriminator import Discriminator
from climsr_tpu_torch.ops import d_tail

torch.set_num_threads(1)

SLOPE = 0.01
# f32: max |got - ref| over max |ref| against the module chain (the order of
# f32 sums). bf16: the chain's own roundings sit elsewhere on the CPU (its conv
# adds the bias inside, its pad's backward sums in bf16), so each value is
# held against the chain run in f32 and may stray from it no more than the bf16
# chain does, times 1.5 plus 2e-3 of room
TOL = 2e-5


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30)).item()


def _assert_held(names, got, chain, truth=None, each=1.5):
    """``got`` against the module chain's ``chain``; in bf16 through ``truth``,
    the f32 chain's: each value within ``each`` times the chain's distance."""
    ratios = []
    for name, g, r, t in zip(names, got, chain, truth or chain):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if truth is None:
            assert rel(g, r) <= TOL, name
        else:
            assert rel(g, t) <= each * rel(r, t) + 2e-3, (name, rel(g, t), rel(r, t))
            ratios.append(rel(g, t) / max(rel(r, t), 1e-9))
    return ratios


def _modules(c: int, stride: int, training: bool, seed: int, copies: int = 3):
    """``copies`` equal (conv, BatchNorm) pairs with drawn parameters and statistics."""
    gen = torch.Generator().manual_seed(seed)
    conv = init_torch_default_(TorchConv(8, c, 3, padding=0, stride=stride), gen)
    bn = TorchBatchNorm(c)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
        bn.running_mean.uniform_(-0.2, 0.2, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    pairs = [(conv, bn.train(training))]
    for _ in range(copies - 1):
        conv2, bn2 = TorchConv(8, c, 3, padding=0, stride=stride), TorchBatchNorm(c)
        conv2.load_state_dict(conv.state_dict())
        bn2.load_state_dict(bn.state_dict())
        pairs.append((conv2, bn2.train(training)))
    return pairs


def _conv_without_bias(conv, x):
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


def _run(fn, conv, bn, x, seed):
    """fn(conv, bn, x) and the gradients of x and of every parameter for a
    drawn output gradient, then BatchNorm's running statistics."""
    x = x.detach().clone().requires_grad_(True)
    out = fn(conv, bn, x)
    params = [x, conv.weight, conv.bias] + ([] if bn is None else [bn.weight, bn.bias])
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(out.dtype)
    stats = [] if bn is None else [bn.running_mean.clone(), bn.running_var.clone()]
    return [out, *torch.autograd.grad(out, params, g)] + stats


BN_NAMES = ("out", "x", "conv.weight", "conv.bias", "bn.weight", "bn.bias", "running_mean", "running_var")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [(64, 7, 6), (128, 6, 9), (256, 4, 5), (512, 3, 4)])
@pytest.mark.parametrize("training", [True, False])
def test_bias_leaky_bn_pad_matches_the_module_chain(dtype, c, h, w, training):
    """conv, bias, LeakyReLU, TorchBatchNorm, reflect pad as modules against
    the conv without its bias and the op: output, the gradients of the input,
    the conv's weight and bias and BatchNorm's weight and bias, the running
    statistics and num_batches_tracked."""
    (conv, bn), (conv2, bn2), (conv3, bn3) = _modules(c, 1, training, seed=c + h)
    x = torch.randn(2, 8, h + 2, w + 2, generator=torch.Generator().manual_seed(w)).to(dtype)

    def chain(cv, b, t):
        return nn.Sequential(cv, nn.LeakyReLU(SLOPE), b, nn.ReflectionPad2d(1))(t)

    def ops(cv, b, t):
        return d_tail.bias_leaky_bn_pad(_conv_without_bias(cv, t), cv.bias, b, SLOPE)

    ref = _run(chain, conv, bn, x, seed=1)
    got = _run(ops, conv2, bn2, x, seed=1)
    truth = None if dtype == torch.float32 else _run(chain, conv3, bn3, x.float(), seed=1)
    assert got[0].shape == (2, c, h + 2, w + 2) and got[0].dtype == dtype
    _assert_held(BN_NAMES, got, ref, truth)
    assert bn2.num_batches_tracked.item() == bn.num_batches_tracked.item() == int(training)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [(64, 7, 6), (128, 5, 8), (512, 2, 3)])
def test_bias_leaky_pad_matches_the_module_chain(dtype, c, h, w):
    """Strided conv, bias, LeakyReLU and the next block's reflect pad as
    modules against the conv without its bias and the op."""
    (conv, _), (conv2, _), (conv3, _) = _modules(c, 2, True, seed=c + w)
    x = torch.randn(2, 8, 2 * h + 1, 2 * w + 1, generator=torch.Generator().manual_seed(h)).to(dtype)

    def chain(cv, _, t):
        return nn.Sequential(cv, nn.LeakyReLU(SLOPE), nn.ReflectionPad2d(1))(t)

    def ops(cv, _, t):
        return d_tail.bias_leaky_pad(_conv_without_bias(cv, t), cv.bias, SLOPE)

    ref, got = _run(chain, conv, None, x, seed=2), _run(ops, conv2, None, x, seed=2)
    truth = None if dtype == torch.float32 else _run(chain, conv3, None, x.float(), seed=2)
    assert got[0].shape == (2, c, h + 2, w + 2) and got[0].dtype == dtype
    _assert_held(BN_NAMES[:4], got, ref, truth)


def test_fold_reflect_pad1_is_the_pads_backward():
    """The fold at every H, W from 2 to 5: the gradient of F.pad(mode='reflect')."""
    for h in range(2, 6):
        for w in range(2, 6):
            x = torch.randn(2, 3, h, w, dtype=torch.float64, requires_grad=True)
            gp = torch.randn(2, 3, h + 2, w + 2, dtype=torch.float64)
            (want,) = torch.autograd.grad(F.pad(x, (1, 1, 1, 1), mode="reflect"), x, gp)
            torch.testing.assert_close(d_tail.fold_reflect_pad1(gp), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("h,w", [(3, 4), (2, 5)])
def test_bias_leaky_bn_pad_backward_gradcheck(training, h, w):
    """The plain backward (the kernels' formulas) against finite differences in f64."""
    gen = torch.Generator().manual_seed(h * w)
    bn = TorchBatchNorm(8).double().train(training)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    y = torch.randn(2, 8, h, w, dtype=torch.float64, generator=gen, requires_grad=True)
    bias = torch.randn(8, dtype=torch.float64, generator=gen, requires_grad=True)

    def f(y, bias, weight, bn_bias):
        return d_tail._BiasLeakyBnPad.apply(y, bias, weight, bn_bias, bn.running_mean, bn.running_var,
                                            bn.num_batches_tracked, training, bn.momentum, bn.eps, SLOPE)

    assert torch.autograd.gradcheck(f, (y, bias, bn.weight, bn.bias), eps=1e-6, atol=1e-6)


def test_bias_leaky_pad_backward_gradcheck():
    gen = torch.Generator().manual_seed(5)
    y = torch.randn(2, 8, 3, 2, dtype=torch.float64, generator=gen, requires_grad=True)
    bias = torch.randn(8, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda y, b: d_tail.bias_leaky_pad(y, b, SLOPE), (y, bias), eps=1e-6, atol=1e-6)


def test_backward_makes_only_the_gradients_asked_for():
    """With the parameters frozen (the generator's step) only the input's gradient comes back."""
    (conv, bn), = _modules(64, 1, True, seed=3, copies=1)
    for p in (*conv.parameters(), *bn.parameters()):
        p.requires_grad_(False)
    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    d_tail.bias_leaky_bn_pad.launches = d_tail.bias_leaky_pad.launches = 0
    out = d_tail.bias_leaky_pad(d_tail.bias_leaky_bn_pad(_conv_without_bias(conv, x), conv.bias, bn, SLOPE),
                                torch.zeros(64), SLOPE)
    out.sum().backward()
    assert x.grad is not None and all(p.grad is None for p in (*conv.parameters(), *bn.parameters()))
    assert d_tail.bias_leaky_bn_pad.launches == 0 and d_tail.bias_leaky_pad.launches == 0


def test_bias_leaky_bn_pad_refuses_a_batchnorm_without_running_statistics():
    bn = nn.BatchNorm2d(8, track_running_stats=False)
    with pytest.raises(ValueError, match="running statistics"):
        d_tail.bias_leaky_bn_pad(torch.randn(1, 8, 3, 3), torch.zeros(8), bn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False])
def test_discriminator_fused_features_match_the_sequential(dtype, training):
    """D's walk through the ops (what a card runs) against its nn.Sequential:
    features, every parameter's gradient and the running statistics. D's CPU
    forward is the Sequential's."""
    gen = torch.Generator().manual_seed(7)
    ds = [Discriminator(in_channels=1, out_channels=8, num_conv_block=3, hr_size=48, generator=gen)]
    for _ in range(2):
        ds.append(Discriminator(in_channels=1, out_channels=8, num_conv_block=3, hr_size=48))
        ds[-1].load_state_dict(ds[0].state_dict())
    x = torch.randn(3, 1, 48, 48, generator=gen)
    g = torch.randn(3, 32, 2, 2, generator=gen)

    def run(d, features, t):
        d.train(training)
        out = features(d)(t)
        stats = [v.clone() for k, v in d.state_dict().items() if k.endswith(("running_mean", "running_var"))]
        return [out, *torch.autograd.grad(out, list(d.feature_extraction.parameters()), g.to(out.dtype))] + stats

    ref = run(ds[0], lambda d: d.feature_extraction, x.to(dtype))
    got = run(ds[1], lambda d: d.fused_features, x.to(dtype))
    truth = None if dtype == torch.float32 else run(ds[2], lambda d: d.feature_extraction, x)
    names = ["features"] + [k for k, _ in ds[0].feature_extraction.named_parameters()] + ["stats"] * 6
    if truth is not None:
        # through three blocks at this size the bf16 chain's own gradients stray
        # 10-120% from the f32 chain's, and the two bf16 paths' distances scatter
        # 0.3-3.5x about each other over ten seeds, so in bf16 the wiring's
        # gradients are the f32 case's to hold; the features and statistics
        # (0.6-1.5x) are held within 4x
        got, ref, truth, names = ([v[0]] + v[-6:] for v in (got, ref, truth, names))
    _assert_held(names, got, ref, truth, each=4.0)
    for d in ds[:len(ds) if truth else 2]:
        assert d.feature_extraction[3].num_batches_tracked.item() == int(training)
    with torch.no_grad():
        torch.testing.assert_close(ds[0](x), ds[0].classification(ds[0].feature_extraction(x).flatten(1)),
                                   rtol=0, atol=0)


def test_discriminator_state_dict_keys_are_the_references():
    d = Discriminator()
    keys = [k for k in d.state_dict() if not k.endswith("num_batches_tracked")]
    want = []
    for i in range(4):
        want += [f"feature_extraction.{7 * i + 1}.weight", f"feature_extraction.{7 * i + 1}.bias"]
        want += [f"feature_extraction.{7 * i + 3}.{k}" for k in ("weight", "bias", "running_mean", "running_var")]
        want += [f"feature_extraction.{7 * i + 5}.weight", f"feature_extraction.{7 * i + 5}.bias"]
    want += [f"feature_extraction.{k}.{p}" for k in (28, 30) for p in ("weight", "bias")]
    want += [f"classification.{k}.{p}" for k in (0, 1) for p in ("weight", "bias")]
    assert keys == want


# ---------------------------------------------------------------------------
# On a card: the kernels against the plain versions at D's shapes


BN_SHAPES = ((192, 64, 128, 128), (192, 128, 64, 64), (192, 256, 32, 32), (192, 512, 16, 16))
PAD_SHAPES = ((192, 64, 64, 64), (192, 128, 32, 32), (192, 256, 16, 16))
# kernel against plain: f32 is the order of sums over up to 3.1 M pixels (the
# bias gradient read 1.4e-5); bf16 is a rounding of the normalised value where
# the two f32 statistics differ in their last bits (2^-8 relative)
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the d_tail kernels have no CPU mode (chip_smoke.py covers them)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(shape, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    y = torch.randn(shape, generator=gen).to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)
    gp = torch.randn(n, c, h + 2, w + 2, generator=gen).to(device=device, dtype=dtype)
    gp = gp.contiguous(memory_format=torch.channels_last)
    bias = (torch.rand(c, generator=gen) - 0.5).to(device)
    bn = TorchBatchNorm(c).to(device)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    return y, gp, bias, bn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_cuda_bias_leaky_bn_pad_matches_plain(cuda_device, dtype, shape):
    y, gp, bias, bn = _card_case(shape, dtype, cuda_device, seed=shape[1])
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    y.requires_grad_(True)
    bias.requires_grad_(True)
    d_tail.bias_leaky_bn_pad.launches = d_tail.bias_leaky_bn_pad.backward_launches = 0
    out = d_tail.bias_leaky_bn_pad(y, bias, bn, SLOPE)
    dy, db, dw, dbb = torch.autograd.grad(out, (y, bias, bn.weight, bn.bias), gp)
    assert d_tail.bias_leaky_bn_pad.launches == 1 and d_tail.bias_leaky_bn_pad.backward_launches == 1
    with torch.no_grad():
        mean, var = d_tail.bn_stats_reference(y, bias, SLOPE)
        count = y.numel() // y.shape[1]
        assert rel(bn.running_mean, 0.1 * mean + 0.9 * rm) <= 1e-5
        assert rel(bn.running_var, 0.1 * var * count / (count - 1) + 0.9 * rv) <= 1e-5
        assert bn.num_batches_tracked.item() == 1
        ref = d_tail.bias_leaky_bn_pad_reference(y, bias, bn.weight, bn.bias, mean, var, bn.eps, SLOPE)
        assert rel(out, ref) <= CARD_TOL[dtype]
        want = d_tail.bias_leaky_bn_pad_backward_reference(gp, y, bias, bn.weight, mean, var, bn.eps, SLOPE, True)
        for name, got, w in zip(("dy", "dbias", "dweight", "dbn_bias"), (dy, db, dw, dbb), want):
            assert rel(got, w) <= CARD_TOL[dtype], name
        bn.eval()
        out_eval = d_tail.bias_leaky_bn_pad(y, bias, bn, SLOPE)
        ref_eval = d_tail.bias_leaky_bn_pad_reference(y, bias, bn.weight, bn.bias, bn.running_mean,
                                                      bn.running_var, bn.eps, SLOPE)
        assert rel(out_eval, ref_eval) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PAD_SHAPES)
def test_cuda_bias_leaky_pad_matches_plain(cuda_device, dtype, shape):
    y, gp, bias, _ = _card_case(shape, dtype, cuda_device, seed=shape[1] + 1)
    y.requires_grad_(True)
    bias.requires_grad_(True)
    d_tail.bias_leaky_pad.launches = d_tail.bias_leaky_pad.backward_launches = 0
    out = d_tail.bias_leaky_pad(y, bias, SLOPE)
    dy, db = torch.autograd.grad(out, (y, bias), gp)
    assert d_tail.bias_leaky_pad.launches == 1 and d_tail.bias_leaky_pad.backward_launches == 1
    with torch.no_grad():
        assert torch.equal(out, d_tail.bias_leaky_pad_reference(y, bias, SLOPE))
        want = d_tail.bias_leaky_pad_backward_reference(gp, out, SLOPE)
        assert rel(dy, want[0]) <= CARD_TOL[dtype]
        assert rel(db, want[1].float()) <= CARD_TOL[dtype]


@pytest.mark.cuda
def test_cuda_d_tail_is_bitwise_repeatable(cuda_device):
    """Two calls on the same inputs: the same statistics, outputs and gradients, bit for bit."""
    y, gp, bias, bn = _card_case(BN_SHAPES[0], torch.bfloat16, cuda_device, seed=9)
    y.requires_grad_(True)
    bias.requires_grad_(True)

    def run():
        bn.running_mean.zero_()
        bn.running_var.fill_(1)
        out = d_tail.bias_leaky_bn_pad(y, bias, bn, SLOPE)
        grads = torch.autograd.grad(out, (y, bias, bn.weight, bn.bias), gp)
        return (out, bn.running_mean.clone(), bn.running_var.clone(), *grads)

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
    small = y.detach()[:, :, :64, :64].contiguous(memory_format=torch.channels_last).requires_grad_(True)
    pad = [torch.autograd.grad(d_tail.bias_leaky_pad(small, bias, SLOPE), (small, bias), gp[:, :, :66, :66])
           for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*pad))


def _f64_logits(d: Discriminator, x: torch.Tensor) -> torch.Tensor:
    """D's logits in f64: its modules' functions on f64 copies of its f32
    parameters (BatchNorm on the batch's statistics), differentiable in them."""
    h = x.double()
    for m in [*d.feature_extraction, "flatten", *d.classification]:
        if m == "flatten":
            h = h.flatten(1)
        elif isinstance(m, TorchBatchNorm):
            h = F.batch_norm(h, None, None, m.weight.double(), m.bias.double(), True, 0.0, m.eps)
        elif isinstance(m, TorchConv):
            h = F.conv2d(h, m.weight.double(), m.bias.double(), m.stride, m.padding)
        elif isinstance(m, nn.Linear):
            h = F.linear(h, m.weight.double(), m.bias.double())
        else:
            h = m(h)
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_discriminator_runs_the_kernels(cuda_device, dtype):
    """D at its full widths on a card, batch 16: 7 calls a forward through the
    kernels (4 blocks) and 7 a backward. In f32 (TF32 off) its logits and
    gradients are held against D's in f64 as near as the Sequential's: the
    backward through four BatchNorms amplifies either path's f32 roundings to
    1e-4 - 6e-3 of a block leaf's largest value, leaf by leaf in either
    direction (8.7x each way over 32 leaves), so the worst leaf is held within
    twice the Sequential's worst (the head and classifier read ~1e-6). In bf16
    the logits (a gradient differs by the bf16 roundings' scatter, the CPU
    test's finding, which the f32 case leaves to the wiring)."""
    gen = torch.Generator().manual_seed(11)
    ds = [Discriminator(generator=gen)] + [Discriminator() for _ in range(2)]
    for d in ds:
        d.load_state_dict(ds[0].state_dict())
        d.to(cuda_device, memory_format=torch.channels_last)
    x = torch.randn(16, 1, 128, 128, generator=gen).to(cuda_device, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    for f in (d_tail.bias_leaky_bn_pad, d_tail.bias_leaky_pad):
        f.launches = f.backward_launches = 0
    outs = [ds[0](x), ds[1].classification(ds[1].feature_extraction(x).flatten(1)), _f64_logits(ds[2], x)]
    got_g, ref_g, truth_g = (torch.autograd.grad(o.sum(), list(d.parameters())) for o, d in zip(outs, ds))
    assert (d_tail.bias_leaky_bn_pad.launches, d_tail.bias_leaky_pad.launches) == (4, 3)
    assert (d_tail.bias_leaky_bn_pad.backward_launches, d_tail.bias_leaky_pad.backward_launches) == (4, 3)
    if dtype == torch.bfloat16:
        assert rel(outs[0], outs[1]) <= 5e-2
        return
    names = ["logits"] + [k for k, _ in ds[0].named_parameters()]
    errs = [(rel(g, t), rel(r, t), name) for name, g, r, t in zip(names, [outs[0], *got_g], [outs[1], *ref_g],
                                                                   [outs[2], *truth_g])]
    assert errs[0][0] <= 2 * errs[0][1] + 1e-6, errs[0]
    worst, worst_ref = max(e for e, _, _ in errs[1:]), max(r for _, r, _ in errs[1:])
    assert worst <= 2 * worst_ref, " ".join(f"{n}:{e:.2e}/{r:.2e}" for e, r, n in errs)
