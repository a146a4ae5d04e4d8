"""The port's host utilities and geometry against the JAX package's:
quaternions, DLT triangulation and projection, the demo's JSON export, the
GLB and HTML scene exports, the COLMAP text model and the training plots.

Same seeded numpy inputs on both sides. Tolerances: 1e-6 for the
quaternion and matrix functions (a few f32 operations; 1e-5 for the angles
near 0 and pi, where arccos and atan2 amplify one rounding), 1e-4 relative
for triangulated points (a 4-column SVD in f32 solved by two LAPACK
builds), 1e-5 relative for projections (plus 1e-3 px: pixels near 100
from products of ~300); the numpy exports equal JAX's byte for byte
where both compute in numpy, and within the rounding of the f32 rotation
where the HTML viewer converts its quaternions.
"""

import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.geometry import quaternions as jquat
from comet_tpu.geometry.cameras import make_camera_set as jax_camera_set
from comet_tpu.training import stats as jstats
from comet_tpu.twoview import triangulation as jtri
from comet_tpu.utils import colmap_io as jcolmap
from comet_tpu.utils import export as jexport
from comet_tpu.utils import scene_export as jscene
from comet_tpu_torch.geometry import make_camera_set
from comet_tpu_torch.geometry import quaternions as tquat
from comet_tpu_torch.training import stats as tstats
from comet_tpu_torch.twoview import triangulation as ttri
from comet_tpu_torch.utils import colmap_io as tcolmap
from comet_tpu_torch.utils import export as texport
from comet_tpu_torch.utils import scene_export as tscene


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------- quaternions


@pytest.mark.parametrize("name", ["quat_normalize", "quat_to_matrix", "quat_standardize",
                                  "quat_conjugate", "quat_invert"])
def test_quaternion_functions_match_jax(name):
    q = np.random.default_rng(1).normal(size=(3, 5, 4)).astype(np.float32)
    want = getattr(jquat, name)(jnp.asarray(q))
    got = getattr(tquat, name)(_t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_matrix_to_quat_matches_jax():
    rng = np.random.default_rng(2)
    q = _quats(rng, 64)
    # each pivot of the branchless candidates: rotations near pi about x, y, z too
    near_pi = np.float32([[0.01, 1, 0, 0], [0.02, 0, 1, 0.01], [0.0, 0.1, 0, 1]])
    q = np.concatenate([q, near_pi / np.linalg.norm(near_pi, axis=-1, keepdims=True)])
    m = np.asarray(jquat.quat_to_matrix(jnp.asarray(q)))
    want = np.asarray(jquat.matrix_to_quat(jnp.asarray(m)))
    got = tquat.matrix_to_quat(_t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.abs((got * q).sum(-1)), 1.0, atol=1e-5)  # the same rotation


def test_rotation_angles_and_euler_match_jax():
    rng = np.random.default_rng(3)
    q1, q2 = _quats(rng, 32), _quats(rng, 32)
    q2[:2] = q1[:2]  # angle 0
    r1, r2 = (np.asarray(jquat.quat_to_matrix(jnp.asarray(q))) for q in (q1, q2))
    for name, args in (("geodesic_angle_from_matrices", (r1, r2)),
                       ("rotation_angle_from_quats", (q1, q2)),
                       ("euler_xyz_from_matrix", (r1,))):
        want = getattr(jquat, name)(*map(jnp.asarray, args))
        got = getattr(tquat, name)(*map(_t, args))
        atol = 1e-3 if name == "rotation_angle_from_quats" else 1e-5  # degrees near 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=name)
    singular = np.float32([[[0, 0, -1], [0, 1, 0], [1, 0, 0]]])  # sy = 0
    np.testing.assert_allclose(tquat.euler_xyz_from_matrix(_t(singular)).numpy(),
                               np.asarray(jquat.euler_xyz_from_matrix(jnp.asarray(singular))),
                               atol=1e-6)


def test_se3_row_convention_matches_jax():
    rng = np.random.default_rng(4)
    r = np.asarray(jquat.quat_to_matrix(jnp.asarray(_quats(rng, 6))))
    t = rng.normal(size=(6, 3)).astype(np.float32)
    want = jquat.se3_matrix_row_convention(jnp.asarray(r), jnp.asarray(t))
    got = tquat.se3_matrix_row_convention(_t(r), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0)
    inv_w = jquat.se3_inverse_row_convention(want)
    inv_g = tquat.se3_inverse_row_convention(got)
    np.testing.assert_allclose(inv_g.numpy(), np.asarray(inv_w), atol=1e-6)
    np.testing.assert_allclose((got @ inv_g).numpy(), np.broadcast_to(np.eye(4), (6, 4, 4)),
                               atol=1e-5)


def test_random_quaternions_are_unit():
    q = tquat.random_quaternions((5, 3), generator=torch.Generator().manual_seed(0))
    assert q.shape == (5, 3, 4)
    torch.testing.assert_close(q.norm(dim=-1), torch.ones(5, 3))


# --------------------------------------------------------- triangulation


def _scene(seed, s=6, n=40):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * [1, 1, 0.5] + [0, 0, 6]).astype(np.float32)
    q = _quats(rng, s) * 0.1 + np.float32([1, 0, 0, 0])
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    t = (rng.normal(size=(s, 3)) * 0.2).astype(np.float32)
    k = np.float32([[300, 0, 64], [0, 300, 64], [0, 0, 1]])
    mask = (rng.random((s, n)) > 0.2).astype(np.float32)
    mask[:2] = 1.0
    return pts, q, t, k, mask


def test_projection_and_triangulation_match_jax():
    pts, q, t, k, mask = _scene(5)
    proj_w = jtri.projection_matrices(jnp.asarray(q), jnp.asarray(t), jnp.asarray(k))
    proj_g = ttri.projection_matrices(_t(q), _t(t), _t(k))
    np.testing.assert_allclose(proj_g.numpy(), np.asarray(proj_w), rtol=1e-6, atol=1e-4)
    pix_w = jtri.project_points(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t), jnp.asarray(k))
    pix_g = ttri.project_points(_t(pts), _t(q), _t(t), _t(k))
    np.testing.assert_allclose(pix_g.numpy(), np.asarray(pix_w), atol=1e-3, rtol=1e-5)
    pix = np.asarray(pix_w) + np.random.default_rng(6).normal(size=pix_g.shape) * 0.05
    pix = pix.astype(np.float32)
    want = np.asarray(jtri.triangulate_tracks(proj_w, jnp.asarray(pix), jnp.asarray(mask)))
    got = ttri.triangulate_tracks(proj_g, _t(pix), _t(mask)).numpy()
    assert got.shape == (pts.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    one = ttri.triangulate_multiview(proj_g, _t(pix[:, 3]), _t(mask[:, 3]))
    np.testing.assert_allclose(one.numpy(), got[3], atol=1e-5)
    np.testing.assert_allclose(got, pts, atol=0.1)  # the noisy views still find the points


# ----------------------------------------------------------------- exports


def _demo_outputs(seed, s=4, n=12):
    rng = np.random.default_rng(seed)
    pts, q, t, k, mask = _scene(seed, s, n)
    cams = dict(q=_quats(rng, s), t_xyz=rng.normal(size=(s, 3)).astype(np.float32))
    out = dict(pred_q=q[None], pred_t=t[None])
    metrics = {k_: float(v) for k_, v in zip(
        ["R_avg", "T_avg", "X_err", "Y_err", "Z_err", "acc@5deg_x", "Auc_30", "Racc_him_5"],
        rng.random(8))}
    return pts, q, t, k, mask, cams, out, metrics


def test_export_sequence_json_matches_jax(tmp_path):
    *_, cams, out, metrics = _demo_outputs(7)
    want = jexport.export_sequence_json(str(tmp_path / "jax"), "scene/seq_0", out,
                                        jax_camera_set(**cams), metrics)
    got = texport.export_sequence_json(
        str(tmp_path / "port"), "scene/seq_0", {k: _t(v) for k, v in out.items()},
        make_camera_set(**cams), metrics)
    assert got.endswith(os.path.join("scene", "seq_0", "metrics", "results.json"))
    with open(want) as f, open(got) as g:
        assert json.load(g) == json.load(f)


def test_glb_scene_matches_jax_and_reads_back(tmp_path):
    pts, q, t, k, mask, *_ = _demo_outputs(8)
    r = np.swapaxes(np.asarray(jquat.quat_to_matrix(jnp.asarray(q))), -1, -2)
    cols = np.random.default_rng(9).random((len(pts), 3))
    paths = [mod.export_glb_scene(str(tmp_path / f"{name}.glb"), pts, cols, list(r), list(t))
             for name, mod in (("jax", jscene), ("port", tscene))]
    (gj, bj), (gp, bp) = (tscene.parse_glb(p) for p in paths)
    assert bp == bj
    assert gp["asset"]["generator"] == "comet_tpu_torch"
    gj["asset"], gp["asset"] = {}, {}
    assert gp == gj
    assert [m["name"] for m in gp["meshes"]] == ["points"] + [f"camera_{i:03d}" for i in range(4)]
    xyz = np.frombuffer(bp, np.float32, count=3 * len(pts)).reshape(-1, 3)
    np.testing.assert_array_equal(xyz, pts)
    np.testing.assert_allclose(tscene.camera_frustum_lines(r[0], t[0]),
                               jscene.camera_frustum_lines(r[0], t[0]), atol=0)


def test_scene_html_matches_jax(tmp_path):
    pts, q, t, *_ = _demo_outputs(10)
    cols = (np.random.default_rng(11).random((len(pts), 3)) * 255).astype(np.uint8)
    texts = []
    for name, mod in (("jax", jscene), ("port", tscene)):
        with open(mod.export_scene_html(str(tmp_path / f"{name}.html"), pts, cols, q, t)) as f:
            texts.append(f.read())
    assert texts[1].split("const CAMS=")[0] == texts[0].split("const CAMS=")[0]

    def cams(text):
        return np.asarray(json.loads(text.split("const CAMS=")[1].split(";")[0]))

    np.testing.assert_allclose(cams(texts[1]), cams(texts[0]), atol=1e-6)


def test_colmap_model_matches_jax_and_reads_back(tmp_path):
    pts, q, t, k, mask, *_ = _demo_outputs(12, s=5, n=30)
    s = len(q)
    r = np.swapaxes(np.asarray(jquat.quat_to_matrix(jnp.asarray(q))), -1, -2)
    ext = np.concatenate([r, t[..., None]], axis=-1)
    tracks = np.asarray(jtri.project_points(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t),
                                            jnp.asarray(k)))
    rgb = (np.random.default_rng(13).random((len(pts), 3)) * 255).astype(np.uint8)
    args = (pts, ext, np.broadcast_to(k, (s, 3, 3)), tracks, mask > 0.5, (128, 128))
    dirs = []
    for name, mod in (("jax", jcolmap), ("port", tcolmap)):
        model = mod.batch_to_colmap(*args, shared_camera=True, rgb=rgb)
        dirs.append(str(tmp_path / name))
        mod.write_model_text(model, dirs[-1])
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(dirs[0], f)) as a, open(os.path.join(dirs[1], f)) as b:
            assert b.read() == a.read(), f
    back = tcolmap.read_model_text(dirs[1])
    assert len(back.images) == s and len(back.cameras) == 1
    pts_b, ext_b, intr_b, extra = tcolmap.colmap_to_batch(back)
    np.testing.assert_allclose(ext_b, ext, atol=1e-6)
    np.testing.assert_allclose(intr_b, np.broadcast_to(k, (s, 3, 3)))
    assert extra is None
    for pid, pt in back.points3d.items():
        assert len(pt.track) >= 2
        np.testing.assert_array_equal(pts_b[pid - 1], pt.xyz)


def test_colmap_reads_back_an_image_without_observations(tmp_path):
    """An image that observes no point has an empty second line in
    images.txt. ``comet_tpu``'s reader drops empty lines and pairs the next
    image's header with this one's; the port's keeps the line."""
    pts, q, t, k, mask, *_ = _demo_outputs(16, s=3, n=10)
    mask[1] = 0.0  # frame 1 observes nothing
    r = np.swapaxes(np.asarray(jquat.quat_to_matrix(jnp.asarray(q))), -1, -2)
    ext = np.concatenate([r, t[..., None]], axis=-1)
    tracks = np.random.default_rng(17).random((3, len(pts), 2)) * 128
    model = tcolmap.batch_to_colmap(pts, ext, np.broadcast_to(k, (3, 3, 3)), tracks, mask > 0.5,
                                    (128, 128))
    tcolmap.write_model_text(model, str(tmp_path))
    back = tcolmap.read_model_text(str(tmp_path))
    assert sorted(back.images) == [0, 1, 2] and len(back.images[1].xys) == 0
    for i in (0, 2):
        np.testing.assert_array_equal(back.images[i].point3d_ids, model.images[i].point3d_ids)
    with pytest.raises(ValueError):
        jcolmap.read_model_text(str(tmp_path))


def test_scene_to_colmap_matches_jax():
    pts, q, t, k, mask, *_ = _demo_outputs(14, s=4, n=20)

    class Recon:  # the fields of scene_ba's SceneReconstruction that it reads
        inlier_mask = mask > 0.5
        valid_tracks = np.arange(len(pts)) % 3 > 0

        class state:
            points = pts

    tracks = np.random.default_rng(15).random((4, len(pts), 2)) * 128
    want = jcolmap.scene_to_colmap(q, t, k, tracks, Recon, (128, 128))
    got = tcolmap.scene_to_colmap(q, t, k, tracks, Recon, (128, 128))
    assert set(got.points3d) == set(want.points3d)
    for i in want.images:
        np.testing.assert_allclose(got.images[i].qvec, want.images[i].qvec, atol=1e-6)
        np.testing.assert_array_equal(got.images[i].point3d_ids, want.images[i].point3d_ids)


# ------------------------------------------------------------------ plots


def test_plots_match_jax(tmp_path):
    rows = [(e, {"loss": 3.0 - e, "R_avg": 2.5 / (e + 1), "Auc_30": 0.1 * e}) for e in range(3)]
    paths = {}
    for name, mod in (("jax", jstats), ("port", tstats)):
        logger = mod.CsvLogger(str(tmp_path / name / "train_results.csv"),
                               fieldnames=("loss", "R_avg", "Auc_30"))
        for epoch, metrics in rows:
            logger.log(epoch, metrics)
        paths[name] = (mod.write_live_dashboard(logger.path), mod.plot_metrics_png(logger.path))
    with open(paths["jax"][0]) as a, open(paths["port"][0]) as b:
        assert b.read() == a.read().replace("comet_tpu training", "comet_tpu_torch training")
    png = paths["port"][1]
    assert png.endswith("train_results.png")
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(tmp_path / "port" / "train_results.csv") as f:
        assert len(list(csv.DictReader(f))) == 3
