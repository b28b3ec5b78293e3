# -*- coding: utf-8 -*-
"""Config of the port: the composer over ``conf/`` (read without PyYAML), the
schemas and the instantiator."""
