# -*- coding: utf-8 -*-
"""Training tasks (this slice: pixel-loss pre-training)."""
