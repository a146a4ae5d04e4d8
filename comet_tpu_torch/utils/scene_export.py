"""Dependency-free GLB scene export: point cloud + camera frusta.

Counterpart of ``comet_tpu/utils/scene_export.py``. Parity target:
comet/utils/gradio.py:50-231 (vggsfm_predictions_to_glb /
integrate_camera_into_scene), which builds a trimesh.Scene with a colored
point cloud and one cone mesh per camera and exports it as GLB for the
gradio viewer. trimesh is not available in this environment, so this
writes the GLB container directly (glTF 2.0: a 12-byte header, a JSON
chunk and one binary buffer chunk) — the format is simple enough that no
library is needed, and the output loads in any glTF viewer.

Scene contents:
- one POINTS primitive with per-vertex RGB colors (the reconstruction);
- one LINES primitive per camera drawing a pyramid frustum from the
  camera center through the four image corners (computed from the
  world-to-camera R, T the same way the reference orients its cones).

Host-side only (numpy); nothing here touches the device.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Sequence

import numpy as np

_FLOAT = 5126  # glTF componentType FLOAT
_USHORT = 5123
_UINT = 5125
_ARRAY_BUFFER = 34962
_ELEMENT_ARRAY_BUFFER = 34963
_MODE_POINTS = 0
_MODE_LINES = 1


def _align4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * ((4 - len(b) % 4) % 4)


def camera_frustum_lines(
    r_w2c: np.ndarray,
    t_w2c: np.ndarray,
    scale: float = 0.1,
    aspect: float = 1.0,
) -> np.ndarray:
    """Line-segment endpoints [16, 3] for one camera frustum in world space.

    r_w2c [3,3], t_w2c [3]: world-to-camera (x_cam = R x_world + T, the
    reference's convention). The apex is the camera center C = -R^T T; the
    base corners sit at depth `scale` along the optical axis.
    """
    r = np.asarray(r_w2c, np.float64)
    t = np.asarray(t_w2c, np.float64)
    center = -r.T @ t
    # camera-frame corners of the image plane at depth `scale`
    w = scale * 0.6 * aspect
    h = scale * 0.6
    corners_cam = np.array(
        [[-w, -h, scale], [w, -h, scale], [w, h, scale], [-w, h, scale]]
    )
    corners = (r.T @ corners_cam.T).T + center  # to world
    segs = []
    for c in corners:  # apex -> each corner
        segs += [center, c]
    for i in range(4):  # base rectangle
        segs += [corners[i], corners[(i + 1) % 4]]
    return np.asarray(segs, np.float32)


def export_glb_scene(
    path: str,
    points3d: np.ndarray,
    colors: Optional[np.ndarray] = None,
    rotations_w2c: Optional[Sequence[np.ndarray]] = None,
    translations_w2c: Optional[Sequence[np.ndarray]] = None,
    frustum_scale: float = 0.1,
) -> str:
    """Write a GLB file with the scene; returns `path`.

    points3d [N, 3] float; colors [N, 3] float in [0, 1] or uint8
    (optional); rotations/translations: per-camera world-to-camera R [3,3]
    and T [3] (optional).
    """
    pts = np.ascontiguousarray(np.asarray(points3d, np.float32).reshape(-1, 3))
    n = pts.shape[0]
    if colors is not None:
        col = np.asarray(colors)
        if col.dtype != np.float32 and col.dtype != np.float64:
            col = col.astype(np.float32) / 255.0
        col = np.ascontiguousarray(np.clip(col, 0, 1).astype(np.float32))
        if col.shape != (n, 3):
            raise ValueError(f"colors shape {col.shape} != ({n}, 3)")

    frusta = []
    if rotations_w2c is not None and translations_w2c is not None:
        # consistent frustum size: scale by the scene extent like the
        # reference's 5th-percentile-based camera sizing (gradio.py:87-99)
        extent = float(np.linalg.norm(pts.max(0) - pts.min(0))) if n else 1.0
        s = frustum_scale * max(extent, 1e-6)
        for r, t in zip(rotations_w2c, translations_w2c):
            frusta.append(camera_frustum_lines(r, t, scale=s))

    # ---- build the single binary buffer ----
    blob = b""
    buffer_views = []
    accessors = []

    def add_view(data: np.ndarray, target: int) -> int:
        nonlocal blob
        raw = _align4(data.tobytes())
        buffer_views.append(
            {
                "buffer": 0,
                "byteOffset": len(blob),
                "byteLength": data.nbytes,
                "target": target,
            }
        )
        blob += raw
        return len(buffer_views) - 1

    def add_accessor(view: int, count: int, ctype: int, atype: str, data=None):
        acc = {
            "bufferView": view,
            "componentType": ctype,
            "count": count,
            "type": atype,
        }
        if data is not None and atype == "VEC3":
            acc["min"] = [float(v) for v in data.min(axis=0)]
            acc["max"] = [float(v) for v in data.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    meshes = []
    nodes = []

    # point cloud
    if n:
        pv = add_view(pts, _ARRAY_BUFFER)
        pa = add_accessor(pv, n, _FLOAT, "VEC3", pts)
        attrs = {"POSITION": pa}
        if colors is not None:
            cv = add_view(col, _ARRAY_BUFFER)
            attrs["COLOR_0"] = add_accessor(cv, n, _FLOAT, "VEC3")
        meshes.append(
            {
                "name": "points",
                "primitives": [{"attributes": attrs, "mode": _MODE_POINTS}],
            }
        )
        nodes.append({"mesh": len(meshes) - 1, "name": "points"})

    # camera frusta (one LINES mesh each)
    for i, segs in enumerate(frusta):
        fv = add_view(segs, _ARRAY_BUFFER)
        fa = add_accessor(fv, segs.shape[0], _FLOAT, "VEC3", segs)
        meshes.append(
            {
                "name": f"camera_{i:03d}",
                "primitives": [
                    {"attributes": {"POSITION": fa}, "mode": _MODE_LINES}
                ],
            }
        )
        nodes.append({"mesh": len(meshes) - 1, "name": f"camera_{i:03d}"})

    gltf = {
        "asset": {"version": "2.0", "generator": "comet_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(blob)}],
    }

    json_chunk = _align4(json.dumps(gltf).encode("utf-8"), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))  # 'glTF', v2
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))  # 'JSON'
        f.write(json_chunk)
        f.write(struct.pack("<II", len(blob), 0x004E4942))  # 'BIN'
        f.write(blob)
    return path


def parse_glb(path: str):
    """Minimal GLB reader (for tests/round-trips): returns (gltf_dict,
    binary_blob)."""
    with open(path, "rb") as f:
        magic, version, _total = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67 or version != 2:
            raise ValueError("not a GLB v2 file")
        jlen, jtype = struct.unpack("<II", f.read(8))
        if jtype != 0x4E4F534A:
            raise ValueError("first chunk is not JSON")
        gltf = json.loads(f.read(jlen).decode("utf-8"))
        rest = f.read()
    blob = b""
    if len(rest) >= 8:
        blen, btype = struct.unpack("<II", rest[:8])
        if btype == 0x004E4942:
            blob = rest[8 : 8 + blen]
    return gltf, blob


_VIEWER_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>COMET scene</title>
<style>body{margin:0;background:#101014;overflow:hidden}canvas{display:block}
#hud{position:fixed;top:8px;left:10px;color:#9aa;font:12px monospace}</style>
</head><body><div id="hud">drag: orbit &middot; wheel: zoom</div>
<canvas id="c"></canvas><script>
const PTS=__POINTS__;const COL=__COLORS__;const CAMS=__CAMERAS__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=0.6,pitch=-0.4,dist=__DIST__,cx=__CX__,cy=__CY__,cz=__CZ__;
function resize(){cv.width=innerWidth;cv.height=innerHeight}
addEventListener('resize',resize);resize();
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-lx)*0.008;
pitch+=(e.clientY-ly)*0.008;lx=e.clientX;ly=e.clientY;draw()};
cv.onwheel=e=>{dist*=e.deltaY>0?1.1:0.9;draw();e.preventDefault()};
function draw(){ctx.fillStyle='#101014';ctx.fillRect(0,0,cv.width,cv.height);
const cyaw=Math.cos(yaw),syaw=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
const f=0.9*Math.min(cv.width,cv.height);
function proj(p){let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
let x1=cyaw*x+syaw*z,z1=-syaw*x+cyaw*z;
let y2=cp*y+sp*z1,z2=-sp*y+cp*z1+dist;
if(z2<0.05)return null;
return [cv.width/2+f*x1/z2,cv.height/2+f*y2/z2,z2]}
for(let i=0;i<PTS.length;i++){const q=proj(PTS[i]);if(!q)continue;
const r=Math.max(1,3.5/q[2]*dist*0.35);
ctx.fillStyle=COL[i];ctx.beginPath();
ctx.arc(q[0],q[1],r,0,6.283);ctx.fill()}
ctx.strokeStyle='#6cf';ctx.lineWidth=1;
for(const cam of CAMS){ctx.beginPath();let first=true;
for(const p of cam){const q=proj(p);if(!q){first=true;continue}
if(first){ctx.moveTo(q[0],q[1]);first=false}else ctx.lineTo(q[0],q[1])}
ctx.stroke()}}
draw();</script></body></html>
"""


def export_scene_html(
    path: str,
    points: np.ndarray,  # [N, 3]
    colors: np.ndarray = None,  # [N, 3] u8 or float
    q: np.ndarray = None,  # [S, 4] wxyz camera rotations (row convention)
    t: np.ndarray = None,  # [S, 3]
    scale: float = 0.25,
) -> str:
    """Self-contained interactive HTML point-cloud/camera viewer — the
    offline equivalent of the reference's gradio/trimesh scene app
    (comet/utils/gradio.py:50): orbit + zoom over the reconstruction with
    camera frusta, zero external assets (a ~2 KB canvas renderer, no
    three.js download). Complements the GLB export for tooling that
    expects a mesh file."""
    import json
    import os

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if colors is None:
        cols = ["#4fc3f7"] * len(pts)
    else:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        cols = ["#%02x%02x%02x" % tuple(int(v) for v in row) for row in c]

    cams = []
    if q is not None and t is not None:
        import torch

        from ..geometry.quaternions import quat_to_matrix

        r = quat_to_matrix(torch.as_tensor(np.asarray(q), dtype=torch.float32)).numpy()
        for i in range(len(r)):
            # repo quats are row-convention (x_cam = x @ R + T);
            # camera_frustum_lines wants the column form -> transpose
            lines = camera_frustum_lines(r[i].T, np.asarray(t)[i], scale)
            cams.append(np.asarray(lines).reshape(-1, 3).tolist())

    center = pts.mean(axis=0) if len(pts) else np.zeros(3)
    spread = float(np.abs(pts - center).max()) if len(pts) else 1.0
    html = (
        _VIEWER_TEMPLATE
        .replace("__POINTS__", json.dumps(np.round(pts, 4).tolist()))
        .replace("__COLORS__", json.dumps(cols))
        .replace("__CAMERAS__", json.dumps(cams))
        .replace("__DIST__", str(round(spread * 3 + 1e-3, 4)))
        .replace("__CX__", str(round(float(center[0]), 4)))
        .replace("__CY__", str(round(float(center[1]), 4)))
        .replace("__CZ__", str(round(float(center[2]), 4)))
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
