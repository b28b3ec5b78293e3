# -*- coding: utf-8 -*-
"""Data-preparation entry point: the port of the repository's root
``data_preparation.py`` (reference parity: ``data_preparation.py``).

Chains dataset download and preprocessing behind flags whose defaults come
from ``conf/data_preparation.yaml``; every other argument goes to both
CLIs as an override. The flags' values are read with the composer's scalar
rules (``config/yaml_subset.py``), as the root script reads them with
``yaml.safe_load``:

    python -m climsr_tpu_torch.cli.data_preparation run_download=false run_preprocessing=true [key=value ...]
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple

FLAGS = ("run_download", "run_preprocessing")


def parse_flags(argv: List[str]) -> Tuple[Dict[str, Any], List[str]]:
    """``argv`` -> (the two flags given, the overrides passed through)."""
    from climsr_tpu_torch.config.yaml_subset import load_yaml

    flags, passthrough = {}, []
    for item in argv:
        key, _, raw = item.partition("=")
        if key in FLAGS:
            flags[key] = load_yaml(raw, f"flag {item!r}")
        else:
            passthrough.append(item)
    return flags, passthrough


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, float]]:
    """Run what the flags select; returns the preprocessing steps' seconds
    (None when preprocessing does not run)."""
    from climsr_tpu_torch.config.compose import compose, default_config_dir

    flags, passthrough = parse_flags(list(argv if argv is not None else sys.argv[1:]))
    # flag defaults come from conf/data_preparation.yaml; CLI overrides win
    cfg = compose(default_config_dir(), "data_preparation", [])
    run_download = flags.get("run_download", cfg.get("run_download", True))
    run_preprocessing = flags.get("run_preprocessing", cfg.get("run_preprocessing", True))

    if run_download:
        from climsr_tpu_torch.cli.data_download import main as download_main

        download_main(passthrough)
    if run_preprocessing:
        from climsr_tpu_torch.cli.preprocess import main as preprocess_main

        return preprocess_main(passthrough)
    return None


if __name__ == "__main__":
    main()
