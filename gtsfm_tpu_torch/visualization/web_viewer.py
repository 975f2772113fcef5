"""Self-contained interactive 3D web viewer for reconstruction results.

Functional equivalent of the reference's React-Three-Fiber dashboard
(reference rtf_vis_tool/src — a web app rendering results/ point clouds,
camera frusta and result_metrics/ panels). Zero-egress-friendly: emits ONE
static HTML file with an embedded WebGL renderer (orbit/zoom/pan controls),
the point cloud, camera frusta and a metrics sidebar — no npm, no CDN, no
server. Open in any browser. Port of gtsfm_tpu/visualization/web_viewer.py
(the same payload and page for the same COLMAP model).
"""

from __future__ import annotations

import json
import os

import numpy as np

from gtsfm_tpu_torch.io import colmap_io


def _frustum_segments(wRi: np.ndarray, wti: np.ndarray, size: float) -> list:
    """8-line frustum wireframe (apex + image plane corners) in world coords."""
    # Camera looks down +z in camera frame; corners of a virtual image plane.
    d = size
    corners_c = np.asarray(
        [[-d, -d, 1.6 * d], [d, -d, 1.6 * d], [d, d, 1.6 * d], [-d, d, 1.6 * d]],
        np.float32,
    )
    corners_w = corners_c @ wRi.T + wti
    apex = wti
    segs = []
    for k in range(4):
        segs.append((apex, corners_w[k]))
        segs.append((corners_w[k], corners_w[(k + 1) % 4]))
    return segs


def scene_payload_from_colmap(model_dir: str, max_points: int = 400_000) -> dict:
    """Read a COLMAP text model dir into the viewer's JSON payload."""
    pts, cols, _ = colmap_io.read_points3d_txt(os.path.join(model_dir, "points3D.txt"))
    images = colmap_io.read_images_txt(os.path.join(model_dir, "images.txt"))
    if pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    centers = np.stack([w for (_, w, _, _) in images.values()]) if images else np.zeros((0, 3))
    scale = 1.0
    if len(centers) >= 2:
        scale = float(np.median(np.linalg.norm(centers - centers.mean(0), axis=-1)))
    fr_size = 0.08 * max(scale, 1e-3)
    segs = []
    for img_id in sorted(images):
        wRi, wti, _, _ = images[img_id]
        for a, b in _frustum_segments(wRi, wti, fr_size):
            segs.append([round(float(v), 4) for v in a] + [round(float(v), 4) for v in b])
    return {
        "points": np.round(pts, 4).tolist(),
        "colors": cols.tolist(),
        "frusta": segs,
        "num_cameras": len(images),
    }


_VIEWER_JS = r"""
'use strict';
const payload = JSON.parse(document.getElementById('scene-data').textContent);
const canvas = document.getElementById('gl');
const gl = canvas.getContext('webgl');
function resize() {
  canvas.width = canvas.clientWidth; canvas.height = canvas.clientHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
}
window.addEventListener('resize', resize);

function compile(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) throw gl.getShaderInfoLog(s);
  return s;
}
const vs = compile(gl.VERTEX_SHADER, `
  attribute vec3 pos; attribute vec3 col; uniform mat4 mvp; uniform float psize;
  varying vec3 vcol;
  void main() { gl_Position = mvp * vec4(pos, 1.0); gl_PointSize = psize; vcol = col; }`);
const fs = compile(gl.FRAGMENT_SHADER, `
  precision mediump float; varying vec3 vcol;
  void main() { gl_FragColor = vec4(vcol, 1.0); }`);
const prog = gl.createProgram();
gl.attachShader(prog, vs); gl.attachShader(prog, fs); gl.linkProgram(prog);
gl.useProgram(prog);
const locPos = gl.getAttribLocation(prog, 'pos');
const locCol = gl.getAttribLocation(prog, 'col');
const locMvp = gl.getUniformLocation(prog, 'mvp');
const locPsize = gl.getUniformLocation(prog, 'psize');

// --- buffers -------------------------------------------------------------
const n = payload.points.length;
const pbuf = new Float32Array(n * 3), cbuf = new Float32Array(n * 3);
const centroid = [0, 0, 0];
for (let i = 0; i < n; i++) {
  for (let k = 0; k < 3; k++) {
    pbuf[3*i+k] = payload.points[i][k]; centroid[k] += payload.points[i][k] / n;
    cbuf[3*i+k] = payload.colors[i][k] / 255.0;
  }
}
let radius = 1e-6;
for (let i = 0; i < n; i++) {
  const dx = pbuf[3*i]-centroid[0], dy = pbuf[3*i+1]-centroid[1], dz = pbuf[3*i+2]-centroid[2];
  radius = Math.max(radius, Math.sqrt(dx*dx+dy*dy+dz*dz));
}
radius = Math.min(radius, 10 * (payload.frusta.length ? frustaRadius() : radius));
function frustaRadius() {
  let r = 1e-6;
  for (const s of payload.frusta) {
    const dx = s[0]-centroid[0], dy = s[1]-centroid[1], dz = s[2]-centroid[2];
    r = Math.max(r, Math.sqrt(dx*dx+dy*dy+dz*dz));
  }
  return r;
}
const m = payload.frusta.length;
const fbuf = new Float32Array(m * 6), fcol = new Float32Array(m * 6);
for (let i = 0; i < m; i++) {
  for (let k = 0; k < 6; k++) fbuf[6*i+k] = payload.frusta[i][k];
  for (let k = 0; k < 2; k++) { fcol[6*i+3*k] = 1.0; fcol[6*i+3*k+1] = 0.45; fcol[6*i+3*k+2] = 0.1; }
}
function makeBuf(data) {
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); return b;
}
const bp = makeBuf(pbuf), bc = makeBuf(cbuf), bf = makeBuf(fbuf), bfc = makeBuf(fcol);

// --- camera --------------------------------------------------------------
let yaw = 0.6, pitch = 0.4, dist = radius * 2.5;
let target = centroid.slice();
function mat4mul(a, b) {
  const o = new Float32Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++) {
    let s = 0; for (let k = 0; k < 4; k++) s += a[k*4+j] * b[i*4+k];
    o[i*4+j] = s;
  }
  return o;
}
function perspective(fovy, aspect, near, far) {
  const f = 1 / Math.tan(fovy / 2);
  return new Float32Array([f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0]);
}
function lookAt(eye, c, up) {
  const z = norm3(sub3(eye, c)), x = norm3(cross3(up, z)), y = cross3(z, x);
  return new Float32Array([
    x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
    -dot3(x,eye),-dot3(y,eye),-dot3(z,eye),1]);
}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(a){const l=Math.sqrt(dot3(a,a))||1;return [a[0]/l,a[1]/l,a[2]/l];}

function draw() {
  resize();
  gl.clearColor(0.07, 0.08, 0.1, 1); gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const eye = [
    target[0] + dist * Math.cos(pitch) * Math.sin(yaw),
    target[1] + dist * Math.sin(pitch),
    target[2] + dist * Math.cos(pitch) * Math.cos(yaw)];
  const mvp = mat4mul(perspective(0.9, canvas.width / canvas.height, dist*1e-3, dist*1e3),
                      lookAt(eye, target, [0, -1, 0]));
  gl.uniformMatrix4fv(locMvp, false, mvp);
  gl.uniform1f(locPsize, 2.0);
  gl.bindBuffer(gl.ARRAY_BUFFER, bp); gl.enableVertexAttribArray(locPos);
  gl.vertexAttribPointer(locPos, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, bc); gl.enableVertexAttribArray(locCol);
  gl.vertexAttribPointer(locCol, 3, gl.FLOAT, false, 0, 0);
  gl.drawArrays(gl.POINTS, 0, n);
  if (m > 0) {
    gl.bindBuffer(gl.ARRAY_BUFFER, bf);
    gl.vertexAttribPointer(locPos, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, bfc);
    gl.vertexAttribPointer(locCol, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.LINES, 0, m * 2);
  }
  requestAnimationFrame(draw);
}
let dragging = false, panning = false, lx = 0, ly = 0;
canvas.addEventListener('mousedown', e => {
  dragging = true; panning = e.button === 2 || e.shiftKey; lx = e.clientX; ly = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
canvas.addEventListener('contextmenu', e => e.preventDefault());
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly; lx = e.clientX; ly = e.clientY;
  if (panning) {
    const s = dist * 0.0015;
    const right = [Math.cos(yaw), 0, -Math.sin(yaw)];
    target[0] -= right[0] * dx * s; target[2] -= right[2] * dx * s; target[1] -= dy * s;
  } else {
    yaw -= dx * 0.005; pitch = Math.max(-1.5, Math.min(1.5, pitch + dy * 0.005));
  }
});
canvas.addEventListener('wheel', e => {
  e.preventDefault(); dist *= Math.exp(e.deltaY * 0.001); }, {passive: false});
document.getElementById('stats').textContent =
  `${n.toLocaleString()} points · ${payload.num_cameras} cameras`;
draw();
"""


def _metrics_sidebar_html(metrics_dir: str | None) -> str:
    if not metrics_dir:
        return ""
    summary_path = os.path.join(metrics_dir, "summary.json")
    if not os.path.isfile(summary_path):
        return ""
    with open(summary_path) as f:
        summary = json.load(f)
    rows = []
    for group, metrics in summary.items():
        rows.append(f"<h3>{group}</h3><table>")
        for k, v in metrics.items():
            if isinstance(v, dict):
                v = v.get("median")
            if isinstance(v, float):
                v = f"{v:.4g}"
            rows.append(f"<tr><td>{k}</td><td>{v}</td></tr>")
        rows.append("</table>")
    return "".join(rows)


def export_web_viewer(
    model_dir: str,
    save_path: str,
    metrics_dir: str | None = None,
    max_points: int = 400_000,
) -> str:
    """Write the standalone HTML viewer for a COLMAP text model directory.

    Args:
      model_dir: directory with cameras.txt/images.txt/points3D.txt.
      save_path: output .html path.
      metrics_dir: optional result_metrics/ dir for the metrics sidebar.
    """
    payload = scene_payload_from_colmap(model_dir, max_points=max_points)
    sidebar = _metrics_sidebar_html(metrics_dir)
    html_text = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>GTSfM-TPU 3D viewer</title>
<style>
body {{ margin:0; display:flex; height:100vh; font-family:sans-serif; background:#111; color:#ddd }}
#gl {{ flex:1; min-width:0 }}
#side {{ width:300px; overflow-y:auto; padding:10px; background:#1b1d22; font-size:12px }}
#side table {{ width:100%; border-collapse:collapse }}
#side td {{ border-bottom:1px solid #333; padding:2px 4px }}
#side h3 {{ margin:10px 0 4px; color:#7ab3ff }}
#stats {{ position:fixed; left:10px; top:8px; font-size:12px; color:#9ad }}
</style></head><body>
<canvas id="gl"></canvas>
<div id="side"><h2>GTSfM-TPU</h2><div id="stats"></div>
<p>drag = orbit · shift-drag/right-drag = pan · wheel = zoom</p>{sidebar}</div>
<script type="application/json" id="scene-data">{json.dumps(payload)}</script>
<script>{_VIEWER_JS}</script>
</body></html>"""
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "w") as f:
        f.write(html_text)
    return save_path
