"""The port's native (C++) loader against the JAX package's and the PIL path.

``comet_tpu_torch.native`` is built from the port's own copy of cometio.cpp
into ``comet_tpu_torch/_build/``; ``comet_tpu.native`` from the JAX
package's. Both link the same system libjpeg and libpng, so every function
is held bit for bit against the JAX package's (JPEG too: lossy decode is
exact only against the same libjpeg, not against PIL's bundled one), and on
PNG against PIL, at 1 and 4 threads. ``NativeLoaderDataset`` and
``DevicePreprocessDataset(decode="native")`` are held sample for sample
to the port's PIL path on the AMD and DCA fixtures. Every comparison is
exact: no tolerances.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from comet_tpu import native as jnative
from comet_tpu_torch import native
from comet_tpu_torch.data import AMDDataset, DCADataset, fixtures
from comet_tpu_torch.data.device_pipeline import DevicePreprocessDataset
from comet_tpu_torch.data.native_loader import NativeLoaderDataset

THREADS = (1, 4)
FIELDS = ("images", "first_mask", "t_xyz", "q_wxyz", "t_uvz", "r_matrix")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """RGB and gray PNGs and an RGB JPEG from a seed: (kind, path, pixels)."""
    root = tmp_path_factory.mktemp("native_images")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (31, 29), dtype=np.uint8)
    out = []
    for kind, arr, name, kw in (("png rgb", rgb, "a.png", {}), ("png gray", gray, "g.png", {}),
                                ("jpeg", rgb, "a.jpg", {"quality": 85})):
        path = str(root / name)
        Image.fromarray(arr).save(path, **kw)
        out.append((kind, path, arr))
    return out


@pytest.fixture(scope="module")
def amd_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("amd_native"))
    fixtures.generate_amd_fixture(root, n_models=1, n_seqs=2, n_frames=12, img_hw=(120, 160))
    return root


def test_the_port_builds_its_own_library():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.version() == jnative.version()
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == "_build"
    assert lib.name.startswith("libcometio-")


@pytest.mark.parametrize("fn", ["decode_rgb", "decode_gray"])
def test_decode_equals_jax_and_pil(images, fn):
    for kind, path, _ in images:
        got = getattr(native, fn)(path)
        np.testing.assert_array_equal(got, getattr(jnative, fn)(path), err_msg=kind)
        assert got.dtype == np.uint8
        if kind != "jpeg":
            pil = Image.open(path).convert("RGB" if fn == "decode_rgb" else "L")
            np.testing.assert_array_equal(got, np.asarray(pil), err_msg=kind)


BOXES = [(-50, -30, 130, 150), (10, 5, 100, 95), (0, 0, 160, 120), (30, 20, 34, 24),
         (150, 110, 250, 210)]


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("out_size", [64, 37, 200])
def test_crop_resize_lanczos_equals_pil_and_jax(channels, out_size):
    rng = np.random.default_rng(out_size + channels)
    shape = (120, 160, 3) if channels == 3 else (120, 160)
    src = rng.integers(0, 256, shape, dtype=np.uint8)
    for box in BOXES:
        got = native.crop_resize_lanczos(src, box, out_size)
        want = Image.fromarray(src).crop(box).resize((out_size, out_size),
                                                     Image.Resampling.LANCZOS)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(box))
        np.testing.assert_array_equal(got, jnative.crop_resize_lanczos(src, box, out_size))


def test_crop_resize_lanczos_random_boxes():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (90, 110, 3), dtype=np.uint8)
    for _ in range(25):
        x0, y0 = (int(v) for v in rng.integers(-40, 80, 2))
        w, h = (int(v) for v in rng.integers(4, 160, 2))
        box, out_size = (x0, y0, x0 + w, y0 + h), int(rng.integers(8, 128))
        want = Image.fromarray(src).crop(box).resize((out_size, out_size),
                                                     Image.Resampling.LANCZOS)
        np.testing.assert_array_equal(native.crop_resize_lanczos(src, box, out_size),
                                      np.asarray(want), err_msg=str(box))


@pytest.mark.parametrize("threads", THREADS)
def test_load_masks_equals_jax_and_mask_bbox(tmp_path, threads):
    from comet_tpu_torch.data import mask_bbox

    rng = np.random.default_rng(4)
    paths, masks = [], []
    for i in range(5):
        mask = np.zeros((50, 60), np.uint8)
        if i != 2:  # an empty mask: the whole-image box
            y, x = rng.integers(5, 30, 2)
            mask[y:y + 12, x:x + 15] = 255
        paths.append(str(tmp_path / f"m{i}.png"))
        Image.fromarray(mask).save(paths[-1])
        masks.append(mask)
    bboxes, mask0 = native.load_masks(paths, threads)
    jb, jm = jnative.load_masks(paths, threads)
    np.testing.assert_array_equal(bboxes, jb)
    np.testing.assert_array_equal(mask0, jm)
    np.testing.assert_array_equal(mask0, masks[0])
    assert bboxes.dtype == np.float64
    assert [list(b) for b in bboxes] == [mask_bbox(m) for m in masks]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_decode_frames_and_load_sequence_equal_jax(tmp_path, threads, ext):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 40, 56, 3), dtype=np.uint8)
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.{ext}"))
        Image.fromarray(f).save(paths[-1])
    got = native.decode_frames(paths, threads)
    np.testing.assert_array_equal(got, jnative.decode_frames(paths, threads))
    np.testing.assert_array_equal(got, native.decode_frames(paths, 1))
    if ext == "png":
        np.testing.assert_array_equal(got, frames)
    box = (-6, 3, 50, 59)
    seq = native.load_sequence(paths, box, 32, n_threads=threads)
    assert seq.dtype == np.float32 and seq.shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(seq, jnative.load_sequence(paths, box, 32, n_threads=threads))
    np.testing.assert_array_equal(seq, native.load_sequence(paths, box, 32, n_threads=1))


def _equal_samples(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.ratio, a.seq_name, a.image_names) == (b.ratio, b.seq_name, b.image_names)


@pytest.mark.parametrize("threads", THREADS)
def test_native_loader_dataset_equals_the_pil_path_amd(amd_root, threads):
    base = AMDDataset(amd_root, crop_size=64, seq_len=8)
    nds = NativeLoaderDataset(base, n_threads=threads)
    assert len(nds) == len(base) == 2
    for i in range(len(base)):
        _equal_samples(nds[i], base[i])


def test_native_loader_dataset_equals_the_pil_path_dca(tmp_path):
    root = fixtures.generate_dca_fixture(str(tmp_path), n_seqs=1, n_frames=10, img_hw=(96, 96))
    base = DCADataset(root, crop_size=48, seq_len=8)
    _equal_samples(NativeLoaderDataset(base)[0], base[0])


def test_native_loader_draws_the_pil_paths_frames(amd_root):
    """Training's random frame selection: two datasets of one seed, one
    read through each path, draw the same frames in the same order."""
    pil = AMDDataset(amd_root, crop_size=32, seq_len=4, use_augs=True, seed=3)
    nds = NativeLoaderDataset(AMDDataset(amd_root, crop_size=32, seq_len=4, use_augs=True, seed=3))
    for i in (0, 1, 0):
        _equal_samples(nds[i], pil[i])


@pytest.mark.parametrize("resample", ["bilinear", "lanczos"])
def test_device_preprocess_native_equals_pil(amd_root, resample):
    base = AMDDataset(amd_root, crop_size=48, seq_len=8)
    pil = DevicePreprocessDataset(base, resample=resample, device="cpu")
    nat = DevicePreprocessDataset(base, resample=resample, decode="native", device="cpu")
    kept = DevicePreprocessDataset(base, resample=resample, decode="native", keep_on_device=True,
                                   device="cpu")
    for i in range(len(base)):
        a, b, c = nat[i], pil[i], kept[i]
        _equal_samples(a, b)
        np.testing.assert_array_equal(a.frame0_u8, b.frame0_u8)
        assert isinstance(c.images, torch.Tensor) and torch.equal(c.images,
                                                                  torch.from_numpy(a.images))


def test_an_unavailable_library_raises_its_build_error(monkeypatch, tmp_path, amd_root):
    """A compiler that is not there: available() is False, build_error()
    says why, and every function and dataset raises with that reason."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        assert not native.available()
        err = native.build_error()
        assert "no-such-g++" in err and "invocation failed" in err
        base = AMDDataset(amd_root, crop_size=32, seq_len=4)
        for make in (lambda: NativeLoaderDataset(base),
                     lambda: DevicePreprocessDataset(base, decode="native", device="cpu"),
                     native.version, lambda: native.decode_rgb("x.png")):
            with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
                make()
        assert not os.listdir(tmp_path / "build")
    finally:
        native._load.cache_clear()


def test_a_failed_compile_leaves_no_library(monkeypatch, tmp_path):
    """A source the compiler refuses: its error is the build error, and
    neither the library nor the per-process temporary file is left."""
    bad = tmp_path / "cometio.cpp"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        assert not native.available()
        assert "no_such_header.h" in native.build_error()
        assert not os.listdir(tmp_path / "build")
    finally:
        native._load.cache_clear()


def test_a_library_that_does_not_load_is_built_again(monkeypatch, tmp_path):
    """A file under the library's name that is no library (one built on
    another machine, against codec libraries this one lacks, fails the same
    way) is compiled over, and the new library loads."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.BUILD_DIR.mkdir()
    native.library_path().write_bytes(b"not a shared object")
    native._load.cache_clear()
    try:
        assert native.available(), native.build_error()
        assert native.version() == jnative.version()
    finally:
        native._load.cache_clear()
