# -*- coding: utf-8 -*-
