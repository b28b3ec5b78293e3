# -*- coding: utf-8 -*-
"""Training tasks: pixel-loss pre-training and the relativistic GAN fine-tune."""
