"""Port vs reference: the command line (``mitsuba_im_tpu_torch/cli/main.py``),
checkpoint and resume (``interactive/checkpoint.py``) and the output path.

The Cornell box of ``tests/test_render.py`` goes through the port's
command line on the CPU at 16² and depth 3 and is held to the JAX
package's ``render_film`` of the same file under parity_check.py's image
gate.  A checkpointed render resumed is the uninterrupted render bit for
bit; checkpoints cross between the packages; the PNG the command writes
is byte for byte the JAX package's develop chain's from the same film.
"""
import os

import numpy as np
import pytest
import torch

from test_torch_helpers import parity_gate
from test_render import CORNELL_XML

from mitsuba_im_tpu.film.film import Film as JFilm, develop as jdevelop
from mitsuba_im_tpu.interactive import checkpoint as jck
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.interactive import checkpoint as tck
from mitsuba_im_tpu_torch.io.exr import read_exr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "cornell.xml")
    with open(path, "w") as f:
        f.write(CORNELL_XML.format(max_depth="$depth", spp=4, res=16))
    return d, path


def _cli(*args):
    assert main([*map(str, args), "-q", "--device", "cpu"]) == 0


def _film(ckpt):
    return np.load(ckpt)["film"]


def test_cli_render_matches_reference(cornell):
    """-o .exr at 16², depth 3, 4 spp against the reference's render_film
    of the same file."""
    d, path = cornell
    out = str(d / "out.exr")
    _cli(path, "-D", "depth=3", "-o", out, "-c", d / "full")
    img, meta = read_exr(out)
    assert meta["renderer"] == "mitsuba_im_tpu_torch"
    scene, settings = jload(path, {"depth": "3"})
    ref = np.asarray(jdevelop(jjob.render_film(scene, settings)))
    port = tck.load_checkpoint(str(d / "full"), "cpu")[0]
    from mitsuba_im_tpu_torch.film.film import develop

    st = parity_gate(develop(port).numpy(), ref)
    assert st["ok"], st
    # the file holds that image in half precision
    np.testing.assert_array_equal(
        img, develop(port).numpy().astype(np.float16).astype(np.float32))
    assert img[:, :5, 0].mean() > img[:, :5, 1].mean()  # red on the left
    assert img[:, -5:, 1].mean() > img[:, -5:, 0].mean()  # green right


def test_checkpoint_resume_bit_exact(cornell):
    """-s 2 -c, then -z to 4 spp: the film is the uninterrupted render's,
    bit for bit (the stateless sampler continues at sample index 2)."""
    d, path = cornell
    full = d / "full.npz"
    if not full.exists():
        _cli(path, "-D", "depth=3", "-o", d / "out.exr", "-c", d / "full")
    _cli(path, "-D", "depth=3", "-s", 2, "-o", d / "half.exr", "-c",
         d / "part")
    assert int(np.load(d / "part.npz")["spp_done"]) == 2
    _cli(path, "-D", "depth=3", "-o", d / "resumed.exr", "-z", d / "part",
         "-c", d / "resumed")
    assert int(np.load(d / "resumed.npz")["spp_done"]) == 4
    np.testing.assert_array_equal(_film(d / "resumed.npz"), _film(full))


def test_checkpoints_cross_packages(cornell):
    d, _ = cornell
    film = torch.from_numpy(np.random.default_rng(3).random(
        (5, 7, 4)).astype(np.float32))
    from mitsuba_im_tpu.scene.build import RenderSettings as JSettings
    from mitsuba_im_tpu_torch.film.film import Film
    from mitsuba_im_tpu_torch.render.job import RenderSettings

    kw = dict(width=7, height=5, spp=8, sampler="ldsampler", seed=3,
              integrator_props=dict(max_depth=4), rfilter=1,
              rfilter_radius=1.0)
    tck.save_checkpoint(str(d / "t"), Film(film, 7, 5, 1, 1.0), 3,
                        RenderSettings(**kw))
    jck.save_checkpoint(str(d / "j"), JFilm(data=film.numpy(), width=7,
                                            height=5, ftype=1, radius=1.0),
                        3, JSettings(**kw))
    for name in ("t", "j"):
        jf, jn, js = jck.load_checkpoint(str(d / name))
        tf, tn, ts = tck.load_checkpoint(str(d / name), "cpu")
        np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
        np.testing.assert_array_equal(tf.data.numpy(), film.numpy())
        assert (tf.width, tf.height, tf.ftype, tf.radius, tn) == (
            jf.width, jf.height, jf.ftype, jf.radius, jn) == (7, 5, 1, 1.0, 3)
        for k, v in kw.items():
            assert getattr(ts, k) == getattr(js, k) == v, k


def test_png_output_and_skip_existing(cornell):
    """-o .png is the reference develop chain's PNG of the same film; -x
    leaves an existing output alone."""
    d, path = cornell
    png = str(d / "out.png")
    _cli(path, "-D", "depth=2", "-s", 1, "-o", png, "-c", d / "png")
    film = _film(d / "png.npz")
    _, settings = jload(path, {"depth": "2"})
    ref = str(d / "ref.png")
    jjob.save_render(ref, np.asarray(jdevelop(JFilm(
        data=film, width=16, height=16))), settings)
    with open(png, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    before = os.path.getmtime(png)
    os.utime(png, (before - 100, before - 100))
    _cli(path, "-D", "depth=2", "-s", 1, "-o", png, "-x")
    assert os.path.getmtime(png) == before - 100


def test_cli_device_and_unported_flags(cornell, monkeypatch, capsys):
    """The card is the default device (also under -m); -m (a world of one
    without torchrun's variables) and --nodes (a node that dies at once,
    its units rendered here) render the command line's image; -i is
    rejected, as the reference's argparse rejects it."""
    d, path = cornell
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if not torch.cuda.is_available():  # the card is the default device
        for extra in ([], ["-m"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                main([path, "-D", "depth=2", "-o", str(d / "x.exr"), *extra])
    _cli(path, "-D", "depth=2", "-s", 1, "-o", d / "plain.npy")
    plain = np.load(d / "plain.npy")
    _cli(path, "-D", "depth=2", "-s", 1, "-m", "-o", d / "m.npy")
    np.testing.assert_array_equal(np.load(d / "m.npy"), plain)
    _cli(path, "-D", "depth=2", "-s", 1, "--nodes", "exec:false", "-o",
         d / "nodes.npy")
    np.testing.assert_array_equal(np.load(d / "nodes.npy"), plain)
    assert "[cluster] exec:false: ConnectionError" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        _cli(path, "-i")
    with pytest.raises(KeyError, match=r"\$depth"):
        _cli(path, "-o", d / "y.exr")


def test_pipelined_scene_loads(cornell):
    """-j 2 loads the second scene on a host thread; each scene file gets
    its own output, named after it, and with -S 1 a numbered image a
    sample."""
    d, path = cornell
    text = open(path).read()
    paths = [str(d / f"{k}.xml") for k in "ab"]
    for p in paths:
        with open(p, "w") as f:
            f.write(text)
    _cli(*paths, "-j", 2, "-s", 1, "-D", "depth=2", "-S", 1)
    a, _ = read_exr(str(d / "a.exr"))
    np.testing.assert_array_equal(read_exr(str(d / "a_00001.exr"))[0], a)
    b, _ = read_exr(str(d / "b.exr"))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (16, 16, 3) and a.mean() > 0
