# -*- coding: utf-8 -*-
"""Training of the port: schedules, optimizers, train states, the tasks
(pixel-loss pre-training, the relativistic GAN fine-tune), the Trainer, its
checkpoints and callbacks."""
