"""Interactive sequence viewer exported as one self-contained HTML file
(port of oakink2_tamf_tpu/viz/html_viewer.py; the same bytes for the same
tracks).

The reference's interactive stack (dev_fn/viz/control.py:1-288 `VizControl`
on Open3D: orbit camera, frame scrubbing, GT-vs-prediction overlays used by
script/debug/debug_refine_sample.py:207-299) needs a display server. This
module exports the sequence ONCE to a single .html file (no external
assets, no network, vanilla canvas JS) to open in any browser.

Interactions match the VizControl use cases:
- drag = orbit, wheel = zoom, shift-drag = pan
- space / slider = play / scrub through frames
- per-track checkboxes toggle overlays (GT vs sample vs refined)

Data layout: every track is [L, N, 3] (a numpy array or a CPU tensor) (L = frames; N = points). Positions are
quantized to int16 over the global bbox (~0.1 mm resolution on a 1 m scene,
4x smaller than f32) and embedded base64. A 160-frame hand-vert track
(778 pts) is ~1.5 MB; object clouds are subsampled to `max_points`.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional, Sequence

import numpy as np

from .render import HAND_LINKS, as_numpy

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif; overflow:hidden; }}
 #c {{ display:block; }}
 #hud {{ position:fixed; left:10px; top:10px; background:rgba(20,20,20,.85);
        padding:10px 12px; border-radius:6px; user-select:none; }}
 #hud label {{ display:block; margin:2px 0; cursor:pointer; }}
 #bar {{ position:fixed; left:10px; right:10px; bottom:10px; display:flex;
         gap:10px; align-items:center; background:rgba(20,20,20,.85);
         padding:8px 12px; border-radius:6px; }}
 #frame {{ flex:1; }}
 .sw {{ display:inline-block; width:10px; height:10px; border-radius:2px;
        margin-right:6px; vertical-align:middle; }}
 button {{ background:#333; color:#ddd; border:1px solid #555; border-radius:4px;
           padding:2px 10px; cursor:pointer; }}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>{title}</b><div id="tracks"></div>
 <div style="margin-top:6px;color:#888">drag orbit &middot; wheel zoom &middot;
 shift-drag pan &middot; space play</div></div>
<div id="bar"><button id="play">&#9654;</button>
 <input type="range" id="frame" min="0" value="0" step="1">
 <span id="fno"></span></div>
<script>
const DATA = {data_json};
function decode(t) {{
  const raw = atob(t.b64), n = raw.length / 2, q = new Int16Array(n);
  for (let i = 0; i < n; i++) q[i] = (raw.charCodeAt(2*i) | (raw.charCodeAt(2*i+1) << 8)) << 16 >> 16;
  const s = t.scale, o = t.offset, out = new Float32Array(n);
  for (let i = 0; i < n; i++) out[i] = q[i] * s[i % 3] + o[i % 3];
  return out;  // [L*N*3]
}}
for (const t of DATA.tracks) {{ t.pos = decode(t); t.on = true; }}
const L = DATA.n_frames, links = DATA.hand_links;
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
let yaw = 0.6, pitch = 0.4, dist = 2.4, panX = 0, panY = 0, frame = 0, playing = false;
const center = DATA.center, radius = DATA.radius;
function resize() {{ canvas.width = innerWidth; canvas.height = innerHeight; draw(); }}
addEventListener('resize', resize);
function project(x, y, z) {{
  x -= center[0]; y -= center[1]; z -= center[2];
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy*x + sy*z, z1 = -sy*x + cy*z;
  const y1 = cp*y - sp*z1, z2 = sp*y + cp*z1;
  const f = Math.min(canvas.width, canvas.height) / (radius * dist);
  return [canvas.width/2 + (x1 + panX) * f, canvas.height/2 - (y1 + panY) * f, z2];
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  for (const t of DATA.tracks) {{
    if (!t.on) continue;
    const N = t.n_points, base = frame * N * 3, P = t.pos;
    ctx.fillStyle = t.color; ctx.strokeStyle = t.color;
    if (t.kind === 'skeleton' && links) {{
      ctx.lineWidth = 2; ctx.globalAlpha = t.alpha;
      for (const [a, b] of links) {{
        const p = project(P[base+3*a], P[base+3*a+1], P[base+3*a+2]);
        const q = project(P[base+3*b], P[base+3*b+1], P[base+3*b+2]);
        ctx.beginPath(); ctx.moveTo(p[0], p[1]); ctx.lineTo(q[0], q[1]); ctx.stroke();
      }}
    }} else {{
      ctx.globalAlpha = t.alpha;
      const s = t.kind === 'cloud' ? 1.5 : 2.5;
      for (let i = 0; i < N; i++) {{
        const p = project(P[base+3*i], P[base+3*i+1], P[base+3*i+2]);
        ctx.fillRect(p[0]-s/2, p[1]-s/2, s, s);
      }}
    }}
    ctx.globalAlpha = 1;
  }}
  document.getElementById('fno').textContent = frame + ' / ' + (L-1);
  document.getElementById('frame').value = frame;
}}
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ const f = radius * dist / Math.min(canvas.width, canvas.height);
    panX += dx * f; panY -= dy * f; }}
  else {{ yaw += dx * 0.008; pitch = Math.max(-1.5, Math.min(1.5, pitch + dy * 0.008)); }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}});
canvas.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); draw(); }};
const slider = document.getElementById('frame'); slider.max = L - 1;
slider.oninput = () => {{ frame = +slider.value; draw(); }};
const playBtn = document.getElementById('play');
playBtn.onclick = () => {{ playing = !playing; playBtn.innerHTML = playing ? '&#10074;&#10074;' : '&#9654;'; }};
addEventListener('keydown', e => {{ if (e.code === 'Space') {{ playBtn.onclick(); e.preventDefault(); }} }});
setInterval(() => {{ if (playing) {{ frame = (frame + 1) % L; draw(); }} }}, 1000 / {fps});
const trackDiv = document.getElementById('tracks');
for (const t of DATA.tracks) {{
  const lab = document.createElement('label');
  lab.innerHTML = '<input type="checkbox" checked> <span class="sw" style="background:'
    + t.color + '"></span>' + t.name;
  lab.querySelector('input').onchange = e => {{ t.on = e.target.checked; draw(); }};
  trackDiv.appendChild(lab);
}}
resize();
</script></body></html>
"""


def _quantize(pos: np.ndarray) -> dict:
    """[L, N, 3] f32 -> int16 base64 + per-axis dequant scale/offset."""
    lo = pos.reshape(-1, 3).min(axis=0)
    hi = pos.reshape(-1, 3).max(axis=0)
    scale = np.maximum(hi - lo, 1e-6) / 65000.0
    q = np.clip(np.round((pos - lo) / scale - 32500.0), -32768, 32767).astype("<i2")
    return {
        "b64": base64.b64encode(q.tobytes()).decode(),
        "scale": scale.astype(float).tolist(),
        "offset": (lo + 32500.0 * scale).astype(float).tolist(),
    }


def export_html_viewer(
    out_path: str,
    tracks: Sequence[dict],
    *,
    title: str = "oakink2_tamf_tpu sequence",
    fps: int = 10,
    max_points: int = 1024,
    hand_links: Optional[Sequence[tuple]] = None,
) -> str:
    """Write a single self-contained interactive HTML viewer.

    Each track dict: {"name": str, "pos": [L, N, 3] array,
    "kind": "skeleton" | "points" | "cloud", "color": css color,
    "alpha": float}. All tracks must share L. "skeleton" draws HAND_LINKS
    over 21 joints; "cloud" tracks are subsampled to `max_points`.
    Returns out_path.
    """
    if not tracks:
        raise ValueError("no tracks")
    n_frames = None
    enc_tracks = []
    all_pts = []
    for t in tracks:
        pos = np.asarray(as_numpy(t["pos"]), np.float32)
        if pos.ndim != 3 or pos.shape[-1] != 3:
            raise ValueError(f"track {t.get('name')}: pos must be [L, N, 3], got {pos.shape}")
        if n_frames is None:
            n_frames = pos.shape[0]
        elif pos.shape[0] != n_frames:
            raise ValueError("all tracks must share the frame count")
        kind = t.get("kind", "points")
        if kind == "cloud" and pos.shape[1] > max_points:
            pos = pos[:, :: -(-pos.shape[1] // max_points)]
        all_pts.append(pos.reshape(-1, 3))
        enc = _quantize(pos)
        enc.update(
            name=str(t["name"]), kind=kind, n_points=int(pos.shape[1]),
            color=t.get("color", "#1f77b4"), alpha=float(t.get("alpha", 1.0)),
        )
        enc_tracks.append(enc)
    pts = np.concatenate(all_pts, axis=0)
    center = pts.mean(axis=0)
    radius = max(float(np.abs(pts - center).max()), 1e-3)
    data = {
        "n_frames": int(n_frames),
        "center": center.astype(float).tolist(),
        "radius": radius,
        "hand_links": [list(ab) for ab in (hand_links or HAND_LINKS)],
        "tracks": enc_tracks,
    }
    html = _HTML.format(title=title, data_json=json.dumps(data), fps=int(fps))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
