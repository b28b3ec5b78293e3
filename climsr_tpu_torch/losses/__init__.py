# -*- coding: utf-8 -*-
"""Losses of the GAN fine-tune: relativistic adversarial and VGG19 perceptual."""
