# -*- coding: utf-8 -*-
"""Run stages. Parity: reference ``climsr/consts/stages.py``."""
train = "train"
val = "val"
test = "test"

stages = [train, val, test]
