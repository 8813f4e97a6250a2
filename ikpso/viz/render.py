"""Offline visualization: the arm, targets, colliders, swarm cloud.

Capability parity with the reference's OpenGL view (SURVEY.md §2.2
C19-C21: joint gizmo cubes, oriented link boxes, target markers,
collider boxes) as an offline renderer: matplotlib 3D when available,
plus a dependency-free standalone HTML export (three.js-style inline
WebGL is overkill — a rotatable SVG-ish canvas with precomputed
geometry serves the "see the arm and targets" capability).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ikpso.models.chain import ChainSpec, IKProblem, Obstacles
from ikpso.ops import fk as fk_ops


def chain_segments(spec: ChainSpec, pose, origin) -> np.ndarray:
    """(L, 2, 3) world-space line segments, one per link."""
    pos = np.asarray(fk_ops.fk_points(spec, pose, origin))
    segs = []
    for k in range(1, spec.num_nodes):
        segs.append([pos[spec.parent[k]], pos[k]])
    return np.asarray(segs)


def scene_dict(
    spec: ChainSpec,
    problem: IKProblem,
    obstacles: Optional[Obstacles] = None,
    swarm_positions: Optional[np.ndarray] = None,
) -> dict:
    """JSON-serializable scene description (nodes, links, targets...)."""
    pos = np.asarray(fk_ops.fk_points(spec, problem.pose, problem.origin))
    scene = {
        "nodes": pos.tolist(),
        "parents": list(spec.parent),
        "effectors": list(spec.effector_idx),
        "targets": np.asarray(problem.targets).tolist(),
    }
    if obstacles is not None and obstacles.count:
        scene["obstacles"] = {
            "centers": np.asarray(obstacles.center).tolist(),
            "half_extents": np.asarray(obstacles.half_extent).tolist(),
            "rotations": np.asarray(obstacles.rot).tolist(),
        }
    if swarm_positions is not None:
        scene["swarm"] = np.asarray(swarm_positions).tolist()
    return scene


def plot_scene(
    spec: ChainSpec,
    problem: IKProblem,
    obstacles: Optional[Obstacles] = None,
    path: Optional[str] = None,
    title: str = "",
):
    """Matplotlib 3D render; saves to ``path`` if given. Returns the
    figure, or None when matplotlib is unavailable (headless parity is
    served by export_html)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib missing
        return None

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    segs = chain_segments(spec, problem.pose, problem.origin)
    for seg in segs:
        ax.plot(*np.asarray(seg).T, color="tab:orange", linewidth=3)
    pos = np.asarray(fk_ops.fk_points(spec, problem.pose, problem.origin))
    ax.scatter(*pos.T, color="tab:green", s=40, label="joints")
    eff = pos[list(spec.effector_idx)]
    ax.scatter(*eff.T, color="gold", s=70, marker="s", label="effectors")
    tgt = np.asarray(problem.targets)
    ax.scatter(*tgt.T, color="red", s=70, marker="x", label="targets")
    if obstacles is not None and obstacles.count:
        for c, h, r in zip(
            np.asarray(obstacles.center),
            np.asarray(obstacles.half_extent),
            np.asarray(obstacles.rot),
        ):
            corners = np.array(
                [
                    [sx * h[0], sy * h[1], sz * h[2]]
                    for sx in (-1, 1)
                    for sy in (-1, 1)
                    for sz in (-1, 1)
                ]
            )
            world = corners @ r.T + c
            ax.scatter(*world.T, color="saddlebrown", s=10)
    ax.set_title(title)
    ax.legend()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ikpso scene</title>
<style>body{margin:0;background:#23272b;color:#ddd;font-family:monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">drag to orbit &middot; wheel to zoom</div>
<canvas id="c"></canvas>
<script>
const SCENE = __SCENE_JSON__;
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let yaw = 0.7, pitch = 0.4, zoom = 90, drag = null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize', resize);
cv.addEventListener('mousedown', e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup', ()=>drag=null);
addEventListener('mousemove', e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.01; pitch+=(e.clientY-drag[1])*0.01;
  drag=[e.clientX,e.clientY]; draw();});
cv.addEventListener('wheel', e=>{zoom*=Math.exp(-e.deltaY*0.001);draw();});
function proj(p){
  const [x,y,z]=p;
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const x1=cy*x+sy*z, z1=-sy*x+cy*z;
  const y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  return [cv.width/2+zoom*x1, cv.height/2-zoom*y2, z2];
}
function line(a,b,color,w){const pa=proj(a),pb=proj(b);
  ctx.strokeStyle=color;ctx.lineWidth=w;ctx.beginPath();
  ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.stroke();}
function dot(p,color,r){const q=proj(p);ctx.fillStyle=color;
  ctx.beginPath();ctx.arc(q[0],q[1],r,0,6.3);ctx.fill();}
function draw(){
  ctx.fillStyle='#23272b';ctx.fillRect(0,0,cv.width,cv.height);
  line([0,0,0],[1,0,0],'#a33',1);line([0,0,0],[0,1,0],'#3a3',1);
  line([0,0,0],[0,0,1],'#33a',1);
  const nodes=SCENE.nodes, parents=SCENE.parents;
  for(let k=1;k<nodes.length;k++) line(nodes[parents[k]],nodes[k],'#e8833a',4);
  if(SCENE.obstacles){
    const {centers,half_extents,rotations}=SCENE.obstacles;
    for(let i=0;i<centers.length;i++){
      const c=centers[i],h=half_extents[i],R=rotations[i];
      const corners=[];
      for(const sx of[-1,1])for(const sy of[-1,1])for(const sz of[-1,1]){
        const l=[sx*h[0],sy*h[1],sz*h[2]];
        corners.push([c[0]+R[0][0]*l[0]+R[0][1]*l[1]+R[0][2]*l[2],
                      c[1]+R[1][0]*l[0]+R[1][1]*l[1]+R[1][2]*l[2],
                      c[2]+R[2][0]*l[0]+R[2][1]*l[1]+R[2][2]*l[2]]);}
      const E=[[0,1],[0,2],[1,3],[2,3],[4,5],[4,6],[5,7],[6,7],[0,4],[1,5],[2,6],[3,7]];
      for(const [a,b] of E) line(corners[a],corners[b],'#b66a2a',1.5);
    }
  }
  if(SCENE.swarm) for(const p of SCENE.swarm) dot(p,'rgba(120,160,255,0.35)',2);
  for(const p of nodes) dot(p,'#58c470',5);
  for(const e of SCENE.effectors) dot(nodes[e],'#f5d442',7);
  for(const t of SCENE.targets) dot(t,'#ff4444',7);
}
resize();
</script></body></html>
"""


def export_html(
    spec: ChainSpec,
    problem: IKProblem,
    path: str,
    obstacles: Optional[Obstacles] = None,
    swarm_positions: Optional[np.ndarray] = None,
) -> str:
    """Standalone interactive HTML view (no external dependencies)."""
    scene = scene_dict(spec, problem, obstacles, swarm_positions)
    html = _HTML_TEMPLATE.replace("__SCENE_JSON__", json.dumps(scene))
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
