# -*- coding: utf-8 -*-
"""Model-zoo names. Parity: reference ``climsr/consts/models.py``."""
srcnn = "srcnn"
esrgan = "esrgan"
rfb_esrgan = "rfb_esrgan"
rcan = "rcan"
drln = "drln"

all_generators = [srcnn, esrgan, rfb_esrgan, rcan, drln]
