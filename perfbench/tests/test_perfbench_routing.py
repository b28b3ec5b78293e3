"""The sweep keeps exactly the checked months as files; every other month's
output goes to /dev/null through a link the port writes through."""
import os

import torch

from perfbench import data
from perfbench.entries import sweep
from perfbench.reference import esrgan

GEN = dict(name="esrgan", nf=8, nb=1, gc=8, in_channels=3, out_channels=1, scaling_factor=4)


def test_checked_months_are_the_only_files(tmp_path):
    from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images
    from climsr_tpu_torch.models import create_generator

    world = data.make_globe(tmp_path, 5, 40, 56, seed=2 ** 31 + 9)
    names = sweep.month_names(world["time"])
    keep = sweep.checked_months(2 ** 31 + 9, 0, 5, 2)
    assert len(keep) == 2 and keep == sweep.checked_months(2 ** 31 + 9, 0, 5, 2)
    out = tmp_path / "out"
    sweep.route_outputs(out, names, keep)
    model = create_generator("esrgan", dtype=torch.bfloat16, device="cpu", in_channels=3, out_channels=1,
                             nf=8, nb=1, gc=8)
    model.load_state_dict(esrgan.seeded_params(GEN, 1, torch.device("cpu")))
    ds = CRUTSInferenceDataset(str(tmp_path / sweep.NETCDF), str(tmp_path / "elevation.tif"),
                               str(tmp_path / "land_mask.tif"), "esrgan")
    paths = inference_on_full_images(model, ds, str(out), "esrgan", batch_size=8, tile_size=32, tile_overlap=4,
                                     device="cpu")
    assert sorted(os.path.basename(p) for p in paths) == sorted(names)
    files = sorted(p.name for p in out.iterdir() if p.is_file() and not p.is_symlink())
    links = sorted(p.name for p in out.iterdir() if p.is_symlink())
    assert files == sorted(names[m] for m in keep)
    assert links == sorted(n for i, n in enumerate(names) if i not in keep)
    assert all(os.readlink(out / n) == os.devnull for n in links)
    assert all((out / n).stat().st_size > 40 * 56 * 16 * 4 for n in files)
