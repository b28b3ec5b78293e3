# -*- coding: utf-8 -*-
"""Runtime utilities of the port: run helpers and the metric logger."""
