# -*- coding: utf-8 -*-
"""Optimizer/scheduler dict keys. Parity: reference ``climsr/consts/training.py``."""
experiment_name_gan_training = "gan-training"
experiment_name_gen_pre_training = "gen-pre-training"
experiment_name_gen_fine_tuning = "gen-fine-tuning"

generator_optimizer_key = "generator_optimizer"
generator_scheduler_key = "generator_scheduler"

discriminator_optimizer_key = "discriminator_optimizer"
discriminator_scheduler_key = "discriminator_scheduler"
