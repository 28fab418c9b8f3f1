"""Port vs reference: the scene loader (``mitsuba_im_tpu_torch/scene/xml.py``),
the plugin registry and every registered plugin, the mesh files
(``scene/mesh.py``) and the host colour functions (``core/spectrum.py``).

Each case is a small scene file (with the mesh and image files it names,
written here from seeded data) loaded by both packages' ``load_scene``; the
port's scene, built on the CPU, equals the bridged reference scene leaf
for leaf, bit for bit, and its render settings equal the reference's.  The
reference's ``warn_substitution`` takes an argument its callers do not
pass (ROADMAP C11), so the cases whose plugins substitute run it with a
version that takes what they pass.
"""
import dataclasses
import struct
import warnings

import numpy as np
import pytest
import torch

from test_torch_helpers import assert_same_scene, bridged

from mitsuba_im_tpu.core import registry as jreg
from mitsuba_im_tpu.core import spectrum as jspec
from mitsuba_im_tpu.scene import mesh as jmesh
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.core import registry as treg
from mitsuba_im_tpu_torch.core import spectrum as tspec
from mitsuba_im_tpu_torch.scene import mesh as tmesh
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload

torch.set_num_threads(2)

SETTINGS = ("width", "height", "spp", "sampler", "seed", "integrator",
            "integrator_props", "rfilter", "rfilter_radius", "film_format",
            "banner", "gamma", "tonemap", "exposure", "key", "tiled")

HEAD = """<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="4"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld">
      <lookat origin="0.3, 1.2, 4" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="2"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="12"/>
      <integer name="height" value="10"/><rfilter type="box"/></film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="90"/>
      <scale value="0.3"/><translate y="2"/></transform>
    <emitter type="area"><rgb name="radiance" value="8 7 6"/></emitter>
  </shape>
"""


def _rng(seed):
    return np.random.default_rng(seed)


def _grid_mesh(n=3, seed=0):
    """An n x n vertex grid in z = noise, as (positions, triangles)."""
    r = _rng(seed)
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    pos = np.stack([xs, ys, 0.1 * r.normal(size=xs.shape)], -1).reshape(-1,
                                                                        3)
    q = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None]).ravel()
    tris = np.concatenate([np.stack([q, q + 1, q + n + 1], 1),
                           np.stack([q, q + n + 1, q + n], 1)])
    return pos, tris


def write_obj(path):
    pos, tris = _grid_mesh(4, 1)
    uv = (pos[:, :2] + 1) / 2
    lines = ["# grid", "o grid"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vt {u:.5f} {v:.5f}" for u, v in uv]
    lines += ["vn 0 0 1", "vn 0.1 0 0.99"]
    n = len(pos)
    for k, (a, b, c) in enumerate(tris):
        if k % 3 == 0:  # negative (relative) indices
            a, b, c = a - n, b - n, c - n
            lines.append(f"f {a}/{a}/-1 {b}/{b}/-2 {c}/{c}/-1")
        else:
            lines.append(f"f {a + 1}/{a + 1}/1 {b + 1}/{b + 1}/2 "
                         f"{c + 1}/{c + 1}/1")
    lines.append("f 1/1/1 2/2/1 6/6/2 5/5/2")  # a quad, fan-split
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_ply(path, binary, endian="<", normals=True, colors=True,
              quad=False):
    pos, tris = _grid_mesh(5, 2)
    r = _rng(3)
    nrm = pos / np.linalg.norm(pos + [0, 0, 2], axis=1, keepdims=True)
    uv = r.random((len(pos), 2))
    col = r.integers(0, 256, (len(pos), 3))
    faces = [list(t) for t in tris] + ([[0, 1, 6, 5]] if quad else [])
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals else []) + [
        "u", "v"]
    hdr = ["ply", "format " + ("ascii 1.0" if not binary else
                               {"<": "binary_little_endian 1.0",
                                ">": "binary_big_endian 1.0"}[endian]),
           "comment written from seeded data",
           f"element vertex {len(pos)}"]
    hdr += [f"property float {p}" for p in props]
    if colors:
        hdr += [f"property uchar {c}" for c in ("red", "green", "blue")]
    hdr += [f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    cols = [pos] + ([nrm] if normals else []) + [uv]
    vf = np.concatenate(cols, 1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        if not binary:
            for k in range(len(pos)):
                row = " ".join(f"{v:.6f}" for v in vf[k])
                if colors:
                    row += " " + " ".join(str(c) for c in col[k])
                f.write((row + "\n").encode())
            for fc in faces:
                f.write((f"{len(fc)} " + " ".join(map(str, fc))
                         + "\n").encode())
            return
        dt = [(p, endian + "f4") for p in props]
        if colors:
            dt += [(c, "u1") for c in ("red", "green", "blue")]
        rec = np.zeros(len(pos), dt)
        for j, p in enumerate(props):
            rec[p] = vf[:, j]
        if colors:
            for j, c in enumerate(("red", "green", "blue")):
                rec[c] = col[:, j]
        f.write(rec.tobytes())
        for fc in faces:
            f.write(struct.pack("B", len(fc))
                    + np.asarray(fc, endian + "i4").tobytes())


def serialized_meshes(mod):
    out = []
    for k, seed in enumerate((4, 5)):
        pos, tris = _grid_mesh(3 + k, seed)
        m = mod.TriMesh(pos + [0, 0.5 * k, 0], tris.astype(np.int64),
                        name=f"part{k}")
        if k == 1:
            m.uvs = _rng(seed).random((len(pos), 2))
        out.append(m)
    return out


def frame_meshes(mod):
    """Three keyframes of one grid (a deformable's first and last)."""
    pos, tris = _grid_mesh(4, 11)
    return [mod.TriMesh(pos + [0.2 * k, 0.1 * k, 0], tris.astype(np.int64),
                        name=f"frame{k}") for k in range(3)]


def write_png(path, shape=(6, 8), seed=6):
    from mitsuba_im_tpu_torch.io.png import write_png as w

    w(path, _rng(seed).random(shape + (3,)).astype(np.float32))


def write_exr(path, shape=(8, 16), seed=7):
    from mitsuba_im_tpu_torch.io.exr import write_exr as w

    w(path, _rng(seed).uniform(0, 3, shape + (3,)).astype(np.float32))


def write_hair(path, binary):
    r = _rng(8)
    strands = [np.cumsum(r.normal(0, 0.1, (n, 3)), 0) + [0, 0.5, 0]
               for n in (4, 6, 5)]
    with open(path, "wb") as f:
        if binary:
            f.write(b"BINARY_HAIR" + struct.pack("<I", sum(map(len,
                                                                strands))))
            for k, s in enumerate(strands):
                if k:
                    f.write(np.float32(np.inf).tobytes())
                f.write(s.astype("<f4").tobytes())
        else:
            f.write("\n\n".join("\n".join(" ".join(f"{v:.5f}" for v in p)
                                          for p in s)
                                for s in strands).encode())


FILES = {
    "m.obj": write_obj,
    "a.ply": lambda p: write_ply(p, False, normals=False, colors=False),
    "b.ply": lambda p: write_ply(p, True),
    "c.ply": lambda p: write_ply(p, True, ">", colors=False, quad=True),
    "m.serialized": lambda p: tmesh.save_serialized(
        p, serialized_meshes(tmesh)),
    "t.png": write_png,
    "h.png": lambda p: write_png(p, (20, 20), 9),
    "t.exr": write_exr,
    "env.exr": lambda p: write_exr(p, (16, 32), 10),
    "frames.serialized": lambda p: tmesh.save_serialized(
        p, frame_meshes(tmesh)),
    "hair.txt": lambda p: write_hair(p, False),
    "hair.bin": lambda p: write_hair(p, True),
}

BSDFS = [
    '<bsdf type="diffuse"><srgb name="reflectance" value="#a04020"/></bsdf>',
    '<bsdf type="roughdiffuse"><float name="alpha" value="0.3"/></bsdf>',
    '<bsdf type="conductor"><string name="material" value="Au"/></bsdf>',
    '<bsdf type="roughconductor"><float name="alpha" value="0.2"/>'
    '<string name="distribution" value="ggx"/>'
    '<spectrum name="eta" value="0.2, 0.9, 1.1"/></bsdf>',
    '<bsdf type="dielectric"><float name="intIOR" value="1.33"/></bsdf>',
    '<bsdf type="thindielectric"/>',
    '<bsdf type="roughdielectric"><float name="alphaU" value="0.1"/>'
    '<float name="alphaV" value="0.3"/></bsdf>',
    '<bsdf type="plastic"><rgb name="diffuseReflectance" value="0.2"/>'
    '</bsdf>',
    '<bsdf type="roughplastic"><string name="intIORMaterial" '
    'value="polypropylene"/></bsdf>',
    '<bsdf type="coating"><bsdf type="diffuse"/></bsdf>',
    '<bsdf type="coating"><bsdf type="roughdiffuse"/></bsdf>',
    '<bsdf type="coating"><bsdf type="conductor"/></bsdf>',
    '<bsdf type="roughcoating"><float name="thickness" value="2"/>'
    '<rgb name="sigmaA" value="0.1 0.2 0.3"/></bsdf>',
    '<bsdf type="phong"><float name="exponent" value="12"/></bsdf>',
    '<bsdf type="ward"><float name="alphaU" value="0.2"/></bsdf>',
    '<bsdf type="null"/>',
    '<bsdf type="difftrans"><spectrum name="transmittance" '
    'value="400:0.2 500:0.6 600:0.4 700:0.9"/></bsdf>',
    '<bsdf type="twosided"><bsdf type="plastic"/></bsdf>',
    '<bsdf type="mask"><texture name="opacity" type="checkerboard"/>'
    '<bsdf type="diffuse"/></bsdf>',
    '<bsdf type="blendbsdf"><float name="weight" value="0.3"/>'
    '<bsdf type="diffuse"/><bsdf type="conductor"/></bsdf>',
    '<bsdf type="mixturebsdf"><string name="weights" value="0.2, 0.3, 0.1"/>'
    '<bsdf type="diffuse"/><bsdf type="phong"/><bsdf type="ward"/></bsdf>',
    '<bsdf type="hk"><spectrum name="sigmaT" value="3"/>'
    '<phase type="hg"><float name="g" value="0.4"/></phase></bsdf>',
]


def _quads(bsdfs):
    """One rectangle per BSDF snippet, in a row."""
    return "".join(
        f'<shape type="rectangle"><transform name="toWorld">'
        f'<scale value="0.2"/><translate x="{-2 + 0.45 * k:.2f}"/>'
        f'</transform>{b}</shape>\n' for k, b in enumerate(bsdfs))


def _tex_bsdf(tex):
    return f'<bsdf type="diffuse">{tex}</bsdf>'


TEXTURES = [
    '<texture name="reflectance" type="bitmap"><string name="filename" '
    'value="t.png"/><float name="uscale" value="2"/></texture>',
    '<texture name="reflectance" type="bitmap"><string name="filename" '
    'value="t.png"/><float name="gamma" value="1"/>'
    '<string name="wrapMode" value="mirror"/></texture>',
    '<texture name="reflectance" type="bitmap"><string name="filename" '
    'value="t.exr"/><float name="voffset" value="0.25"/></texture>',
    '<texture name="reflectance" type="checkerboard"><rgb name="color0" '
    'value="0.8 0.1 0.1"/><float name="uscale" value="4"/></texture>',
    '<texture name="reflectance" type="gridtexture"><float name="lineWidth" '
    'value="0.05"/></texture>',
    '<texture name="reflectance" type="scale"><float name="scale" '
    'value="0.5"/><texture type="checkerboard"/></texture>',
    '<texture name="reflectance" type="scale"><rgb name="scale" '
    'value="0.4 0.5 0.6"/><float name="value" value="0.5"/></texture>',
    '<texture name="reflectance" type="wireframe"/>',
    '<texture name="reflectance" type="curvature"/>',
]

CASES = {
    "obj": """<shape type="obj"><string name="filename" value="m.obj"/>
      <boolean name="flipTexCoords" value="false"/></shape>
      <shape type="obj"><string name="filename" value="m.obj"/>
      <boolean name="faceNormals" value="true"/>
      <transform name="toWorld"><scale x="-1" y="1" z="1"/></transform>
      </shape>""",
    "ply": """<shape type="ply"><string name="filename" value="a.ply"/>
      </shape>
      <shape type="ply"><string name="filename" value="b.ply"/>
      <bsdf type="diffuse"><texture name="reflectance" type="vertexcolors"/>
      </bsdf><transform name="toWorld"><translate y="1"/></transform></shape>
      <shape type="ply"><string name="filename" value="c.ply"/>
      <boolean name="flipNormals" value="true"/></shape>""",
    "serialized": """<shape type="serialized">
      <string name="filename" value="m.serialized"/>
      <integer name="shapeIndex" value="1"/>
      <emitter type="area"><blackbody name="radiance" temperature="3200"
      scale="0.5"/></emitter></shape>""",
    "analytic": """<shape type="cube"><transform name="toWorld">
      <scale value="0.3"/><rotate y="1" angle="30"/></transform>
      <bsdf type="plastic"/></shape>
      <shape type="cylinder"><point name="p0" x="0.5" y="0" z="0"/>
      <point name="p1" x="0.5" y="1" z="0.2"/>
      <float name="radius" value="0.2"/>
      <emitter type="area"><spectrum name="radiance" value="2"/></emitter>
      </shape>
      <shape type="sphere"><point name="center" x="-0.5" y="0.4" z="0"/>
      <float name="radius" value="0.3"/><bsdf type="dielectric"/></shape>
      <shape type="disk"><transform name="toWorld"><scale value="0.4"/>
      <rotate x="1" angle="-90"/></transform>
      <boolean name="flipNormals" value="true"/></shape>
      <shape type="rectangle"><boolean name="flipNormals" value="true"/>
      </shape>""",
    "heightfield": """<shape type="heightfield">
      <string name="filename" value="h.png"/>
      <float name="scale" value="0.2"/></shape>""",
    "hair": """<shape type="hair"><string name="filename" value="hair.txt"/>
      <float name="radius" value="0.02"/></shape>
      <shape type="hair"><string name="filename" value="hair.bin"/>
      <float name="reduction" value="0.4"/></shape>""",
    "bsdfs": _quads(BSDFS),
    "textures": _quads([_tex_bsdf(t) for t in TEXTURES]) + """
      <shape type="rectangle"><bsdf type="bumpmap"><texture type="bitmap">
      <string name="filename" value="t.png"/></texture>
      <float name="scale" value="0.5"/><bsdf type="roughplastic"/></bsdf>
      </shape>
      <shape type="rectangle"><bsdf type="normalmap"><texture type="bitmap"
      name="normals"><string name="filename" value="t.exr"/></texture>
      <bsdf type="diffuse"/></bsdf></shape>""",
    "envmap": """<emitter type="envmap"><string name="filename"
      value="env.exr"/><float name="scale" value="1.5"/>
      <transform name="toWorld"><rotate y="1" angle="40"/></transform>
      </emitter><shape type="sphere"><bsdf type="roughconductor"/></shape>""",
    "irawan": _quads([
        '<bsdf type="irawan"><float name="repeatU" value="4"/></bsdf>',
        '<bsdf type="irawan"/>',
        '<bsdf type="twosided"><bsdf type="irawan"><float name="repeatV" '
        'value="3"/></bsdf></bsdf>']),
    "instancing": """<shape type="shapegroup" id="grp">
      <shape type="obj"><string name="filename" value="m.obj"/></shape>
      <shape type="sphere"><float name="radius" value="0.2"/></shape>
      <shape type="disk"><transform name="toWorld"><scale value="0.3"/>
      </transform></shape></shape>
      <shape type="instance"><ref id="grp"/><transform name="toWorld">
      <scale value="0.5"/><translate x="-0.5"/></transform></shape>
      <shape type="instance"><ref id="grp"/><transform name="toWorld">
      <rotate y="1" angle="40"/><scale value="0.7"/><translate x="0.6"/>
      </transform></shape>
      <shape type="cube"><transform name="toWorld"><scale value="0.2"/>
      </transform></shape>""",
    "deformable": """<shape type="deformable">
      <string name="filename" value="frames.serialized"/>
      <bsdf type="roughplastic"/></shape>
      <shape type="rectangle"/>""",
    "integrators": """<integrator type="direct">
      <integer name="shadingSamples" value="3"/>
      <integer name="bsdfSamples" value="2"/></integrator>
      <integrator type="ao"><float name="rayLength" value="0.5"/>
      </integrator>
      <integrator type="field"><string name="field" value="shNormal"/>
      </integrator>
      <integrator type="motion"/>
      <shape type="sphere"/>""",
    "tiledhdrfilm": """<sensor type="perspective"><float name="fov"
      value="30"/><film type="tiledhdrfilm"><integer name="width"
      value="20"/><integer name="height" value="6"/></film></sensor>
      <integrator type="direct"/>
      <shape type="sphere"/>""",
    # the Preetham sky: the Hosek bake's last bits differ from the
    # reference's (emitter/hosek.py), held to a tolerance in test_torch_envmap
    "sunsky": """<emitter type="sunsky"><integer name="resolution" value="16"/>
      <string name="skyModel" value="preetham"/>
      <float name="hour" value="10"/></emitter>
      <emitter type="point"><point name="position" x="0" y="1" z="1"/>
      <rgb name="intensity" value="#ffe0c0"/></emitter>
      <shape type="sphere"/>""",
}


def _load_both(tmp_path, body, head=HEAD):
    for name, write in FILES.items():
        p = tmp_path / name
        if not p.exists():
            write(str(p))
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(head + body + "\n</scene>\n")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port, pset = tload(path, device="cpu")
    return (port, pset), jload(path), caught


@pytest.mark.parametrize("case", list(CASES))
def test_tables_match_reference(case, tmp_path, monkeypatch):
    """The port's scene and settings from the file equal the reference's,
    bit for bit; plugins that substitute warn."""
    monkeypatch.setattr(jreg, "warn_substitution", lambda *a, **k: None)
    (port, pset), (ref, rset), caught = _load_both(tmp_path, CASES[case])
    ref = bridged(ref)
    if port.bsdfs.weaves:
        # IRAWAN's normalization sums 10,000 float32 samples in another
        # order (rel 1e-5); every other field of each pattern (repeatU/V
        # read from the file, the yarns, the tiling) is the reference's
        assert len(port.bsdfs.weaves) == len(ref.bsdfs.weaves) == 3
        for a, b in zip(port.bsdfs.weaves, ref.bsdfs.weaves):
            fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
            na, nb = fa.pop("normalization"), fb.pop("normalization")
            assert fa == fb
            assert abs(na - nb) <= 1e-5 * nb
        assert [(w.repeatU, w.repeatV) for w in port.bsdfs.weaves] == [
            (4.0, 1.0), (1.0, 1.0), (1.0, 3.0)]
        port = dataclasses.replace(port, bsdfs=dataclasses.replace(
            port.bsdfs, weaves=ref.bsdfs.weaves))
    assert_same_scene(port, ref)
    for k in SETTINGS:
        assert getattr(pset, k) == getattr(rset, k), k
    subs = [str(w.message) for w in caught
            if "plugin substitution" in str(w.message)]
    assert len(subs) == (3 if case == "bsdfs" else 0), subs


def test_meshes_match_reference_loaders(tmp_path, monkeypatch):
    """The loaders give the reference's meshes; the native OBJ tokenizer's
    floats are the float32 nearest the reference's pure-Python parse, its
    topology the same; ``save_serialized`` writes the reference's bytes."""
    for name in ("m.obj", "a.ply", "b.ply", "c.ply"):
        FILES[name](str(tmp_path / name))
    import mitsuba_im_tpu.accel.native as jnative

    obj = str(tmp_path / "m.obj")
    native = tmesh.load_obj(obj, flip_tex_coords=False)
    ref_native = jmesh.load_obj(obj, flip_tex_coords=False)
    # without its native library the reference parses in Python
    monkeypatch.setattr(jnative, "parse_obj_native", lambda path: None)
    py = jmesh.load_obj(obj, flip_tex_coords=False)
    assert native.n_triangles == py.n_triangles == 2 * 9 + 2
    np.testing.assert_array_equal(native.indices, py.indices)
    for k in ("positions", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(native, k),
                                      getattr(py, k).astype(np.float32))
    for k in ("positions", "indices", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(native, k),
                                      getattr(ref_native, k))
    for name in ("a.ply", "b.ply", "c.ply"):
        a, b = tmesh.load_ply(str(tmp_path / name)), jmesh.load_ply(
            str(tmp_path / name))
        for k in ("positions", "indices", "normals", "uvs", "colors"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), (name, k)
            if x is not None:
                assert x.dtype == y.dtype, (name, k)
                np.testing.assert_array_equal(x, y, err_msg=f"{name} {k}")
    tp, jp = str(tmp_path / "t.serialized"), str(tmp_path / "j.serialized")
    tmesh.save_serialized(tp, serialized_meshes(tmesh))
    jmesh.save_serialized(jp, serialized_meshes(jmesh))
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    assert tmesh.serialized_shape_count(tp) == 2
    for k in range(2):
        a, b = tmesh.load_serialized(jp, k), jmesh.load_serialized(tp, k)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.name == b.name == f"part{k}"


def test_loader_features(tmp_path):
    """-D and <default> substitution, <include>, <alias>, <ref>; a missing
    $var raises KeyError naming it, in both packages."""
    inc = tmp_path / "walls.xml"
    inc.write_text("""<scene version="0.6.0">
      <bsdf type="diffuse" id="red"><rgb name="reflectance" value="$red"/>
      </bsdf><alias id="red" as="crimson"/>
      <shape type="rectangle"><ref id="crimson"/>
      <transform name="toWorld"><translate z="-$dist"/></transform></shape>
      </scene>""")
    body = """<default name="red" value="0.7, 0.1, 0.1"/>
      <default name="dist" value="1"/>
      <include filename="walls.xml"/>
      <shape type="rectangle"><ref id="red"/></shape>"""
    head = HEAD.replace('value="4"/></integrator>',
                        'value="$depth"/></integrator>')
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(head + body + "\n</scene>\n")
    for params in ({"depth": "3"}, {"depth": "7", "dist": "2.5",
                                    "red": "0.2"}):
        port, pset = tload(path, params, device="cpu")
        ref, rset = jload(path, params)
        assert_same_scene(port, bridged(ref))
        assert pset.integrator_props == rset.integrator_props
        assert pset.integrator_props["max_depth"] == int(params["depth"])
    for load in (lambda: tload(path, device="cpu"), lambda: jload(path)):
        with pytest.raises(KeyError, match=r"\$depth"):
            load()


UNPORTED = {
    "ptracer": '<integrator type="ptracer"/>',
    "adaptive": '<integrator type="adaptive"/>',
    "bdpt": '<integrator type="bdpt"/>',
    "vpl": '<integrator type="vpl"/>',
    "sppm": '<integrator type="sppm"/>',
    "pssmlt": '<integrator type="pssmlt"/>',
    "erpt": '<integrator type="erpt"/>',
    "singlescatter": '<subsurface type="singlescatter"/>',
    "subsurface": '<shape type="sphere"><subsurface type="dipole"/>'
                  '</shape>',
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_plugins_raise(case, tmp_path):
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(f'<scene version="0.6.0">{UNPORTED[case]}</scene>')
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item"):
        tload(path, device="cpu")


def test_available_plugins_match_reference():
    """Every category lists the reference's names (its ``utility``
    category, the mtsutil tools, is not ported)."""
    cats = [c for c in jreg.CATEGORIES if c != "utility"]
    assert tuple(cats) == treg.CATEGORIES
    for c in cats:
        assert treg.available_plugins(c) == jreg.available_plugins(c), c


def test_scale_texture_constant_is_value_times_scale(tmp_path):
    """Without a nested texture, ``scale`` is the constant value * scale,
    and a missing ``scale`` falls back to ``value``, so the constant is
    ``value`` squared in both packages (ROADMAP C12); where both are given
    they agree too (``test_tables_match_reference``)."""
    body = ('<shape type="rectangle"><bsdf type="diffuse"><texture '
            'name="reflectance" type="scale"><float name="value" '
            'value="0.5"/></texture></bsdf></shape>')
    (port, _), (ref, _), _ = _load_both(tmp_path, body)
    row = int(port.bsdfs.refl_tex[-1])
    np.testing.assert_array_equal(np.asarray(ref.textures.value0[row]),
                                  np.full(3, 0.25, np.float32))
    np.testing.assert_array_equal(port.textures.value0[row].numpy(),
                                  np.asarray(ref.textures.value0[row]))


def test_host_spectra_match_reference():
    for t in (1500.0, 3200.0, 6504.0, 12000.0):
        np.testing.assert_array_equal(tspec.blackbody_rgb(t),
                                      jspec.blackbody_rgb(t))
    r = _rng(11)
    for n in (0, 1, 2, 9):
        wl, v = np.sort(r.uniform(380, 780, n)), r.random(n)
        np.testing.assert_array_equal(tspec.interpolated_rgb(wl, v),
                                      jspec.interpolated_rgb(wl, v))
    c = r.uniform(0.0, 1.2, 64).astype(np.float32)
    np.testing.assert_allclose(tspec.srgb_to_linear(c),
                               np.asarray(jspec.srgb_to_linear(c)),
                               rtol=1e-6)
    np.testing.assert_allclose(tspec.linear_to_srgb(c),
                               np.asarray(jspec.linear_to_srgb(c)),
                               rtol=1e-6)
