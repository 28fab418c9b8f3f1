"""Port vs reference: the image codecs (``mitsuba_im_tpu_torch/io``), the
resampler (``film/resample.py``) and the LDR develop chain
(``render/job.py::tonemap_ldr``, ``save_render``).

Every writer gives byte for byte the JAX package's file from the same
seeded image, and each package reads the other's file to the same array.
The EXR reader is also held on RLE, ZIPS and uncompressed files that a
small writer here packs (the JAX package writes ZIP only), and PIZ's
Huffman and wavelet decoders on seeded streams (a canonical Huffman
encoder here makes them); the whole PIZ read waits for a PIZ file in the
repository.  Every comparison is exact but the resampler's with the
Gaussian and Lanczos filters (rel 1e-6, atol 1e-6: XLA's and PyTorch's float32 exp
and sin differ in the last bit).
"""
import heapq
import struct
import zlib

import numpy as np
import pytest
import torch

from mitsuba_im_tpu.film import resample as jrs
from mitsuba_im_tpu.io import bitmap as jbmp
from mitsuba_im_tpu.io import exr as jexr
from mitsuba_im_tpu.io import piz as jpiz
from mitsuba_im_tpu.io import png as jpng
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.build import RenderSettings as JSettings
from mitsuba_im_tpu_torch.film import resample as trs
from mitsuba_im_tpu_torch.io import bitmap as tbmp
from mitsuba_im_tpu_torch.io import exr as texr
from mitsuba_im_tpu_torch.io import piz as tpiz
from mitsuba_im_tpu_torch.io import png as tpng
from mitsuba_im_tpu_torch.render import job as tjob

torch.set_num_threads(2)


def _image(seed, shape, hi=4.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(
        np.float32)


def _exr(path, mod, img, **kw):
    mod.write_exr(path, img, **kw)


def _exr_stream(path, mod, img, **kw):
    H, W, C = img.shape
    mod.write_exr_stream(path, lambda y0, n: img[y0:y0 + n], H, W, C, **kw)


# (name, writer(path, package's module, image), file name, image, reader)
# a writer of ``None`` is ``bitmap.save``
WRITERS = [
    ("exr-half", lambda p, m, i: _exr(p, m[1], i), "a.exr",
     _image(1, (21, 19, 3)), "exr"),
    ("exr-float", lambda p, m, i: _exr(p, m[1], i, half=False), "a.exr",
     _image(2, (17, 9, 3)), "exr"),
    ("exr-gray", lambda p, m, i: _exr(p, m[1], i, half=False), "a.exr",
     _image(3, (5, 7, 1)), "exr"),
    ("exr-rgba-meta", lambda p, m, i: _exr(p, m[1], i,
                                           metadata={"spp": "64"}),
     "a.exr", _image(4, (33, 6, 4)), "exr"),
    ("exr-named", lambda p, m, i: _exr(
        p, m[1], i, half=False,
        channel_names=["normal.R", "albedo.G", "depth.Z"]),
     "a.exr", _image(5, (19, 3, 3)), "exr-all"),
    ("exr-stream", lambda p, m, i: _exr_stream(p, m[1], i, half=True),
     "a.exr", _image(6, (40, 11, 3)), "exr"),
    ("png8", lambda p, m, i: m[2].write_png(p, i), "a.png",
     _image(7, (13, 17, 3), 1.0), "png"),
    ("png16-rgba", lambda p, m, i: m[2].write_png(p, i, depth=16), "a.png",
     _image(8, (9, 11, 4), 1.0), "png"),
    ("png8-gray", lambda p, m, i: m[2].write_png(p, i), "a.png",
     _image(9, (6, 5, 1), 1.0), "png"),
    ("rgbe", None, "a.hdr", _image(10, (7, 12, 3), 30.0), "bitmap"),
    ("pfm", None, "a.pfm", _image(11, (8, 6, 3)), "bitmap"),
    ("ppm", None, "a.ppm", _image(12, (5, 9, 3), 1.2), "bitmap"),
    ("tga", None, "a.tga", _image(13, (6, 7, 3), 1.0), "bitmap"),
    ("bmp", None, "a.bmp", _image(14, (5, 6, 3), 1.0), "bitmap"),
    ("npy", None, "a.npy", _image(15, (4, 3, 3)), "bitmap"),
]
JMODS = (jbmp, jexr, jpng)
TMODS = (tbmp, texr, tpng)


def _read(kind, mods, path):
    bmp, exr, png = mods
    if kind == "exr":
        return exr.read_exr(path)
    if kind == "exr-all":
        return exr.read_exr(path, all_channels=True)
    if kind == "png":
        return png.read_png(path)
    return bmp.load(path), bmp.load(path, gamma_correct=False)


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a == b
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", WRITERS, ids=[c[0] for c in WRITERS])
def test_writer_bytes_and_cross_reads(case, tmp_path):
    """Byte-for-byte files, and each package reads both files to the same
    arrays (and metadata)."""
    _, write, name, img, kind = case
    paths = {}
    for tag, mods in (("jax", JMODS), ("port", TMODS)):
        p = str(tmp_path / f"{tag}_{name}")
        if write is None:
            mods[0].save(p, img)
        else:
            write(p, mods, img)
        paths[tag] = p
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    ref = _read(kind, JMODS, paths["jax"])
    for mods in (JMODS, TMODS):
        for tag in ("jax", "port"):
            _same(_read(kind, mods, paths[tag]), ref)


def _exr_lines(path, img, comp, half=True):
    """An EXR of one scanline per block with compression ``comp``
    (NONE, RLE or ZIPS), channels R, G, B."""
    H, W, _ = img.shape
    dt, ptype = ("<f2", 1) if half else ("<f4", 2)
    hdr = bytearray()

    def attr(name, typ, data):
        hdr.extend(name.encode() + b"\0" + typ.encode() + b"\0")
        hdr.extend(struct.pack("<I", len(data)) + data)

    chb = b"".join(n.encode() + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0,
                                                    0, 0, 1, 1)
                   for n in "BGR") + b"\0"
    attr("channels", "chlist", chb)
    attr("compression", "compression", bytes([comp]))
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\0")
    hdr.append(0)
    blocks = []
    for y in range(H):
        raw = b"".join(img[y, :, c].astype(dt).tobytes() for c in (2, 1, 0))
        pred = jexr._interleave_and_predict(np.frombuffer(raw, np.uint8))
        if comp == jexr.C_ZIPS:
            data = zlib.compress(pred)
        elif comp == jexr.C_RLE:
            data = _rle_encode(pred)
        else:
            data = raw
        if len(data) >= len(raw):  # stored raw, as OpenEXR writers do
            data = raw
        blocks.append(struct.pack("<ii", y, len(data)) + data)
    offs, pos = [], 8 + len(hdr) + 8 * H
    for b in blocks:
        offs.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(struct.pack("<iI", jexr.MAGIC, 2) + bytes(hdr))
        f.write(struct.pack(f"<{H}Q", *offs) + b"".join(blocks))


def _rle_encode(b: bytes) -> bytes:
    """OpenEXR RLE: runs of >= 3 equal bytes as (count - 1, byte), the
    rest as literal packets (-count, bytes)."""
    out, i, n = bytearray(), 0, len(b)
    while i < n:
        j = i
        while j < n and j - i < 127 and b[j] == b[i]:
            j += 1
        if j - i >= 3:
            out += struct.pack("b", j - i - 1) + b[i:i + 1]
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and b[j] == b[j + 1] == b[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += struct.pack("b", -(j - i)) + b[i:j]
        i = j
    return bytes(out)


@pytest.mark.parametrize("comp", ["rle", "zips", "none"])
def test_exr_read_line_compressions(comp, tmp_path):
    """RLE (with real runs), ZIPS and uncompressed scanlines read to the
    same arrays in both packages, equal to the image's half values."""
    img = _image(20, (9, 37, 3))
    img[2:5] = 1.5  # constant rows give RLE runs
    code = {"rle": jexr.C_RLE, "zips": jexr.C_ZIPS, "none": jexr.C_NONE}
    p = str(tmp_path / "l.exr")
    _exr_lines(p, img, code[comp])
    ref, _ = jexr.read_exr(p)
    out, _ = texr.read_exr(p)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, img.astype(np.float16)
                                  .astype(np.float32))


def _huf_encode(sym: np.ndarray, run_at: int = -1, run: int = 0) -> bytes:
    """A PIZ Huffman stream of the uint16 symbols ``sym``; with
    ``run_at`` >= 0 the symbol there is followed by an RLE escape repeating
    it ``run`` times.  Canonical codes as the decoder assigns them."""
    rlc = int(sym.max()) + 1
    stream = [int(s) for s in sym]
    if run_at >= 0:
        stream = stream[:run_at + 1] + [rlc] + stream[run_at + 1:]
    freq = np.bincount(stream, minlength=rlc + 1)
    heap = [(int(f), k, (k,)) for k, f in enumerate(freq) if f]
    heapq.heapify(heap)
    lengths = np.zeros(rlc + 1, np.int64)
    tie = len(freq)
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        lengths[list(a + b)] += 1
        heapq.heappush(heap, (fa + fb, tie, a + b))
        tie += 1
    counts = np.bincount(lengths[lengths > 0], minlength=59)
    base, c = np.zeros(59, np.int64), 0
    for ln in range(58, 0, -1):
        base[ln], c = c, (c + counts[ln]) >> 1
    code, nxt = {}, base.copy()
    for s in np.nonzero(lengths)[0]:
        code[int(s)] = (int(nxt[lengths[s]]), int(lengths[s]))
        nxt[lengths[s]] += 1
    bits = []

    def put(v, n):
        bits.extend((v >> (n - 1 - k)) & 1 for k in range(n))

    for s in range(0, rlc + 1):
        put(int(lengths[s]), 6)
    bits.extend([0] * (-len(bits) % 8))
    for k, s in enumerate(stream):
        put(*code[s])
        if s == rlc:
            put(run, 8)
    bits.extend([0] * (-len(bits) % 8))
    payload = np.packbits(np.asarray(bits, np.uint8)).tobytes()
    return struct.pack("<IIIII", 0, rlc, 0, len(bits), 0) + payload


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_piz_huffman_decode(seed):
    rng = np.random.default_rng(seed)
    n = 600
    sym = np.minimum(rng.geometric(0.15, n) - 1, 40 + 20 * seed).astype(
        np.uint16)
    data = _huf_encode(sym, run_at=100, run=17)
    expect = np.concatenate([sym[:101], np.full(17, sym[100]), sym[101:]])
    ref = jpiz._huf_decode(data, len(expect))
    np.testing.assert_array_equal(ref, expect)
    np.testing.assert_array_equal(tpiz._huf_decode(data, len(expect)), ref)


@pytest.mark.parametrize("nx,ny,mx", [(16, 8, 1000), (13, 7, 1 << 14),
                                      (32, 5, 60000), (3, 9, 100)])
def test_piz_wavelet_decode(nx, ny, mx):
    rng = np.random.default_rng(nx * ny)
    buf = rng.integers(0, min(mx + 1, 1 << 16), nx * ny).astype(np.uint16)
    ref, out = buf.copy(), buf.copy()
    jpiz._wav2_decode(ref, nx, 1, ny, nx, mx)
    tpiz._wav2_decode(out, nx, 1, ny, nx, mx)
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(ref, buf)


# the Gaussian's exp and Lanczos' sin: XLA's and PyTorch's float32
# transcendentals differ in the last bit, which moves a weight by an ulp
TRANSCENDENTAL = (2, 5)


@pytest.mark.parametrize("ftype", range(6))
def test_resample_bit_exact(ftype):
    """Bit for bit for the polynomial filters; within rel 1e-6 for the
    Gaussian and Lanczos, atol 1e-6 on images of scale 4 (an ulp of a
    float32 weight, see above)."""
    def same(out, ref):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        if ftype in TRANSCENDENTAL:
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(out, ref)

    img = _image(30 + ftype, (19, 23, 3))
    for size, bc in (((11, 7), jrs.BC_CLAMP), ((40, 31), jrs.BC_REPEAT),
                     ((23, 19), jrs.BC_MIRROR), ((9, 30), jrs.BC_ZERO)):
        same(trs.resample(img, size, ftype, bc=bc),
             jrs.resample(img, size, ftype, bc=bc))
    same(trs.resample(img[..., 0], (7, 5), ftype, clamp_negative=True),
         jrs.resample(img[..., 0], (7, 5), ftype, clamp_negative=True))


TONEMAPS = [dict(), dict(gamma=2.2), dict(tonemap="reinhard"),
            dict(tonemap="reinhard", key=0.3, exposure=-1.0),
            dict(exposure=1.5, gamma=1.8)]


@pytest.mark.parametrize("kw", TONEMAPS, ids=range(len(TONEMAPS)))
def test_tonemap_and_png_output_bit_exact(kw, tmp_path):
    """tonemap_ldr and save_render's PNG, PPM and EXR bytes."""
    img = _image(40, (12, 14, 3), 3.0)
    js, ts = JSettings(**kw), tjob.RenderSettings(**kw)
    ref = jjob.tonemap_ldr(img, js)
    out = tjob.tonemap_ldr(img, ts)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    for ext in (".png", ".ppm", ".exr"):
        jp, tp = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
        jjob.save_render(jp, img, js, metadata={"spp": "4"})
        tjob.save_render(tp, torch.from_numpy(img), ts,
                         metadata={"spp": "4"})
        with open(jp, "rb") as f, open(tp, "rb") as g:
            assert f.read() == g.read(), ext
