"""Faults planted under the timed path, each a context manager that patches the port.

- ``frozen_state``: the optimizer's step leaves the parameters as they were;
- ``half_batch``: each step keeps the first half of its batch, the means taken over it;
- ``frozen_d_state``: in a GAN step the discriminator's optimizer leaves D as it was;
- ``no_perceptual``, ``no_adversarial``: the GAN step's generator loss lacks that term;
- ``altered_answer``: every 97th value of a month's land vector is moved by
  a quarter of the normalized range where the tiler produces it;
- ``dropped_month``: every other month's GeoTIFF is never written.
"""
import contextlib


@contextlib.contextmanager
def _patched(owner, attr, value):
    old = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, old)


def frozen_state():
    from climsr_tpu_torch.training.optimizers import ScheduledOptimizer

    return _patched(ScheduledOptimizer, "step", lambda self: None)


def half_batch():
    """Each step's prepared batch keeps its first half of rows: every mean is over the rest."""
    from climsr_tpu_torch.training.tasks import gan, pretrain

    prepare = pretrain.prepare_batch

    def halved(*args, **kwargs):
        batch = prepare(*args, **kwargs)
        n = next(iter(batch.values())).shape[0] // 2
        return {k: v[:n] for k, v in batch.items()}

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(pretrain, "prepare_batch", halved))
    stack.enter_context(_patched(gan, "prepare_batch", halved))
    return stack


def _gan_step(**changed):
    """The Trainer's GAN step built with ``changed`` in place of its arguments."""
    from climsr_tpu_torch.training import loop

    make = loop.make_gan_step
    return _patched(loop, "make_gan_step", lambda *a, **k: make(*a, **{**k, **changed}))


def frozen_d_state():
    from climsr_tpu_torch.training import loop

    make = loop.make_gan_step

    def made(*args, **kwargs):
        step = make(*args, **kwargs)

        def frozen(state, batch):
            state.d_optimizer.step = lambda: None
            return step(state, batch)

        return frozen

    return _patched(loop, "make_gan_step", made)


def no_perceptual():
    return _gan_step(perceptual_fn=None)


def no_adversarial():
    return _gan_step(adversarial_weight=0.0)


def altered_answer():
    from climsr_tpu_torch.inference import tiled

    pack = tiled.pack12_fn

    def altered(x):
        x = x.clone()
        x[..., ::97] += 0.25
        return pack(x)

    return _patched(tiled, "pack12_fn", altered)


def dropped_month():
    from climsr_tpu_torch.inference import run

    write = run.write_geotiff
    calls = []

    def every_other(path, array, profile=None):
        calls.append(path)
        if len(calls) % 2:
            write(path, array, profile)

    return _patched(run, "write_geotiff", every_other)
