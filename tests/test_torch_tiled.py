"""Port vs reference: the out-of-core tiled film
(``mitsuba_im_tpu_torch/film/tiled.py``, ``render/job.py::render_band``,
the ``tiledhdrfilm`` factory and the command line's tiled branch).

As ``tests/test_tiled.py`` holds the reference, the tiled EXR (full
precision) equals the full-frame ``render_film`` image of the same scene
within atol 2e-5, for the box filter and for the Gaussian of radius 2,
whose taps cross the bands' margins; band by band through the command
line (at its default band height) a ``tiledhdrfilm`` scene file gives the reference's tiled image under
parity_check.py's image gate, with ``direct`` too.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import parity_gate
from test_render import CORNELL_XML

from mitsuba_im_tpu.film.tiled import render_tiled as jrender_tiled
from mitsuba_im_tpu.io.exr import read_exr as jread_exr
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.film.film import F_BOX, F_GAUSSIAN, develop
from mitsuba_im_tpu_torch.film.tiled import render_tiled
from mitsuba_im_tpu_torch.io.exr import read_exr
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scenes import tiny_cornell

torch.set_num_threads(2)


@pytest.mark.parametrize("rfilter", [F_BOX, F_GAUSSIAN])
def test_tiled_matches_full_frame(rfilter, tmp_path):
    scene, settings = tiny_cornell("cpu")
    settings.width, settings.height, settings.spp = 32, 28, 3
    settings.rfilter = rfilter
    full = develop(render_film(scene, settings)).numpy()
    out = str(tmp_path / "tiled.exr")
    render_tiled(scene, settings, out, band_rows=8, half=False)
    tiled, _ = read_exr(out)
    np.testing.assert_allclose(tiled, full, atol=2e-5)
    assert full.mean() > 0.05


@pytest.mark.parametrize("integrator", ["path", "direct"])
def test_cli_tiled_matches_reference(integrator, tmp_path):
    xml = CORNELL_XML.format(max_depth=3, spp=2, res=16).replace(
        'film type="hdrfilm"', 'film type="tiledhdrfilm"').replace(
        '<integrator type="path">', f'<integrator type="{integrator}">')
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(xml)
    out = str(tmp_path / "out.exr")
    # 72 rows: a full band of 64 and a partial one
    assert main([path, "-o", out, "-q", "--device", "cpu",
                 "--height", "72"]) == 0
    img, meta = read_exr(out)
    assert meta["renderer"] == "mitsuba_im_tpu_torch"
    assert img.shape == (72, 16, 3)
    scene, settings = jload(path)
    assert settings.tiled
    settings.height = 72
    ref_out = str(tmp_path / "ref.exr")
    jrender_tiled(scene, settings, ref_out)
    ref, _ = jread_exr(ref_out)
    st = parity_gate(img, ref)
    assert st["ok"], st
