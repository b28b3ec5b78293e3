# -*- coding: utf-8 -*-
"""Keys of the per-sample dict produced by datasets.

Parity: reference ``climsr/consts/batch_items.py``.
"""
lr = "lr"
hr = "hr"
elevation = "elevation"
mask = "mask"
error = "error"
elevation_lr = "elevation_lr"
nearest = "nearest"
cubic = "cubic"
original_data = "original_data"
mask_np = "mask_np"
min = "min"
max = "max"
filename = "filename"
normalized = "normalized"
standardized = "standardized"
