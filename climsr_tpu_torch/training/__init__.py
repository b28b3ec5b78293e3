# -*- coding: utf-8 -*-
"""Training of the port: schedules, optimizers, train state and the pixel-loss pre-training task."""
