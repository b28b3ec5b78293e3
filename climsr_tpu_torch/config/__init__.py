# -*- coding: utf-8 -*-
"""Config schemas of the port (the rest of ``climsr_tpu.config`` comes with the CLI slice)."""
