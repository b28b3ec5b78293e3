# -*- coding: utf-8 -*-
"""Multi-rank training and inference: the process mesh, ZeRO partitioning and the H-sharded halo exchange."""
