# -*- coding: utf-8 -*-
"""Command-line entry points of the port: training and inference."""
