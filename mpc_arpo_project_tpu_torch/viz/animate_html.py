"""Interactive trajectory animation — the LIVE counterpart of viz.animate.

Copy of ``mpc_arpo_project_tpu/viz/animate_html.py:1-213`` (below this
paragraph unchanged but for the port's config classes, the reference
project's paths, given from its root, and the word TPU), kept in the port
so that it imports nothing of the JAX package; the HTML it writes is the
original's, byte for byte.

The reference's VPython scene (`src/animateTrajectory.py:16-235`)
is interactive: camera follow, user rotate/zoom, and live control/disturbance
graphs drawn while the animation plays (`:151-235`). VPython needs a running
browser session wired to the Python process — impossible on a headless
host — so this module exports the SAME scene as one self-contained HTML file
(no external assets, no network): telemetry is embedded as JSON and a small
canvas renderer provides

  * play / pause / scrub / speed control;
  * camera follow modes (chaser / target / free) — `:151-155`;
  * mouse-drag pan, wheel zoom, and a view-rotate slider (the
    `scene.camera.rotate` affordance, `:156-162`);
  * the LVLH -> ECI rotation by (pi + theta_target) (`:200`), the
    gravity-propagated target orbit (`:109-114,186-188`), rotating LOS cone
    lines, debris box, chaser trail, controller-colored thrust arrows (50x,
    `:105,135`) and green disturbance arrows (`:144-145`);
  * live-updating control / disturbance strip charts (`:163-178`).

Open the file in any browser; nothing else is required.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

import numpy as np

from mpc_arpo_project_tpu_torch.config import SimConditions, Debris, SimRun

MU = 3.986e14
RE = 6371e3
ALT = 500e3


def export_html(
    sim_conditions: SimConditions,
    sim_run: SimRun,
    debris: Optional[Debris] = None,
    out_path: str = "RunFigs/animation.html",
    stride: int = 1,
    max_frames: int = 2000,
) -> str:
    """Write the interactive animation to ``out_path`` and return the path."""
    xk = np.asarray(sim_run.x_true_pcw, dtype=np.float64)
    ctrls = np.asarray(sim_run.ctrl_hist, dtype=np.float64)
    seq = np.asarray(sim_run.ctrlr_seq, dtype=np.float64)
    dist = sim_run.noise_hist
    has_dist = dist is not None and np.asarray(dist).size > 0
    dist = np.asarray(dist, dtype=np.float64) if has_dist else np.zeros((4, 1))

    n = float(sim_conditions.mean_mtn)
    dt_base = (
        sim_conditions.time_stp
        if math.isnan(sim_conditions.T_cont)
        else sim_conditions.T_cont
    )
    nanim = int(min(xk.shape[1], len(seq) + 1))
    idx = np.arange(1, nanim, stride)[:max_frames]
    dt = dt_base * stride

    # gravity-propagated target orbit at the frame cadence (`:109-114,186-188`)
    r0 = RE + ALT
    pos = np.array([r0, 0.0])
    vel = np.array([0.0, r0 * n])
    targ = np.zeros((len(idx), 2))
    for k in range(len(idx)):
        targ[k] = pos
        rmag = float(np.hypot(*pos))
        acc = -MU / rmag**2 * pos / rmag
        vel = vel + acc * dt
        pos = pos + vel * dt

    def col(a, i, width):
        return a[:width, i].tolist() if i < a.shape[1] else [0.0] * width

    data = {
        "dt": dt,
        "rp": float(sim_conditions.r_p),
        "gam": float(sim_conditions.los_ang),
        "phi": float(sim_conditions.hatch_ofst),
        "isDeltaV": bool(sim_conditions.isDeltaV),
        "debris": (np.asarray(debris.constructVertArr()).tolist()
                   if debris is not None else None),
        "targ": np.round(targ, 2).tolist(),
        "x": [col(xk, int(i), 2) for i in idx],
        "u": [col(ctrls, int(i), 2) for i in idx],
        "d": [col(dist, int(i), 2) if has_dist else [0.0, 0.0] for i in idx],
        "seq": [int(seq[int(i)]) if int(i) < len(seq) else 1 for i in idx],
        "hasDist": has_dist,
    }

    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write(html)
    return out_path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ARPO trajectory</title>
<style>
 body{margin:0;background:#0b0e14;color:#d8dee9;font:13px sans-serif;display:flex;flex-wrap:wrap}
 #scene{background:#05070c;cursor:grab}
 .side{display:flex;flex-direction:column;padding:6px}
 canvas.strip{background:#10141c;margin:4px 0;border:1px solid #222}
 .bar{width:100%;padding:6px;display:flex;gap:10px;align-items:center}
 button,select,input{background:#1c2230;color:#d8dee9;border:1px solid #333}
 #title{font-weight:bold}
</style></head><body>
<div class="bar">
 <button id="play">&#9654;</button>
 <input id="scrub" type="range" min="0" max="0" value="0" style="flex:1">
 <label>speed <select id="speed"><option>0.25</option><option>0.5</option><option selected>1</option><option>2</option><option>4</option></select>x</label>
 <label>camera <select id="cam"><option selected>chaser</option><option>target</option><option>free</option></select></label>
 <label>rotate <input id="rot" type="range" min="-180" max="180" value="0" style="width:90px"></label>
 <span id="title"></span>
</div>
<canvas id="scene" width="760" height="560"></canvas>
<div class="side">
 <div>Control Inputs (ECI)</div><canvas id="uchart" class="strip" width="380" height="220"></canvas>
 <div id="dlabel">Disturbances (ECI)</div><canvas id="dchart" class="strip" width="380" height="220"></canvas>
</div>
<script>
const D=__DATA__;
const N=D.x.length, scene=document.getElementById('scene'), ctx=scene.getContext('2d');
const CCOL={1:'#5e9dff',2:'#ff5e5e',3:'#ffd24d'};
const CNAME={1:'MPC',2:'LQR Failsafe',3:'Deadbeat Collision Avoidance'};
let frame=0, playing=false, zoom=6.0, rotU=0, panX=0, panY=0;
const scrub=document.getElementById('scrub'); scrub.max=N-1;
function rot(t){const c=Math.cos(t),s=Math.sin(t);return [c,-s,s,c];}
function mul(R,v){return [R[0]*v[0]+R[1]*v[1],R[2]*v[0]+R[3]*v[1]];}
function eci(k,v){  // LVLH -> ECI about the target (reference :200)
  const tp=D.targ[k], th=Math.atan2(tp[1],tp[0]);
  const R=rot(Math.PI+th), p=mul(R,v); return [tp[0]+p[0],tp[1]+p[1]];
}
function draw(){
  const k=frame, tp=D.targ[k], th=Math.atan2(tp[1],tp[1]?tp[0]:tp[0]);
  const ch=eci(k,D.x[k]);
  const look=document.getElementById('cam').value==='chaser'?ch:
             document.getElementById('cam').value==='target'?tp:[panX,panY];
  const Rv=rot(rotU*Math.PI/180);
  const W=scene.width,H=scene.height;
  ctx.setTransform(1,0,0,1,0,0); ctx.fillStyle='#05070c'; ctx.fillRect(0,0,W,H);
  function S(p){const q=mul(Rv,[p[0]-look[0],p[1]-look[1]]);
    return [W/2+q[0]*zoom, H/2-q[1]*zoom];}
  // target platform
  const c0=S(tp); ctx.fillStyle='#888'; ctx.beginPath();
  ctx.arc(c0[0],c0[1],D.rp*zoom,0,7); ctx.fill();
  // LOS cone (rotates with the platform)
  ctx.strokeStyle='#ffa571'; ctx.lineWidth=1.5;
  for(const sg of [1,-1]){const a=D.phi+sg*D.gam, e=eci(k,[120,120*Math.tan(a)]);
    const p1=S(tp), p2=S(e); ctx.beginPath(); ctx.moveTo(p1[0],p1[1]);
    ctx.lineTo(p2[0],p2[1]); ctx.stroke();}
  // debris box
  if(D.debris){ctx.beginPath();
    D.debris.forEach((v,i)=>{const p=S(eci(k,v)); i?ctx.lineTo(p[0],p[1]):ctx.moveTo(p[0],p[1]);});
    ctx.closePath(); ctx.stroke();}
  // trail
  ctx.strokeStyle='#b07ce8'; ctx.lineWidth=1; ctx.beginPath();
  for(let i=0;i<=k;i++){const p=S(eci(k,D.x[i])); i?ctx.lineTo(p[0],p[1]):ctx.moveTo(p[0],p[1]);}
  ctx.stroke();
  // chaser
  const pc=S(ch); ctx.fillStyle='#b07ce8'; ctx.beginPath();
  ctx.arc(pc[0],pc[1],Math.max(3,0.6*zoom),0,7); ctx.fill();
  // thrust arrow (50x, controller color) + disturbance arrow (green, at target)
  function arrow(from,vec,scale,color){const m=Math.hypot(vec[0],vec[1]);
    if(m<1e-9)return; const p1=S(from),
      p2=S([from[0]+vec[0]*scale, from[1]+vec[1]*scale]);
    ctx.strokeStyle=color; ctx.lineWidth=3; ctx.beginPath();
    ctx.moveTo(p1[0],p1[1]); ctx.lineTo(p2[0],p2[1]); ctx.stroke();}
  const tt=Math.atan2(tp[1],tp[0]), Re=rot(Math.PI+tt);
  arrow(ch, mul(Re,D.u[k]), 50, CCOL[D.seq[k]]||'#5e9dff');
  if(D.hasDist) arrow(tp, mul(Re,D.d[k]), 50, '#4dd24d');
  document.getElementById('title').textContent=
    't='+(k*D.dt).toFixed(1)+'s — Using controller: '+(CNAME[D.seq[k]]||'MPC');
  strip('uchart', D.u, ['#5e9dff','#ff5e5e'], ['Ux','Uy']);
  if(D.hasDist) strip('dchart', D.d, ['#ffa500','#00d2d2'], ['X Disturbance','Y Disturbance']);
  scrub.value=k;
}
function strip(id,a,cols,names){
  const cv=document.getElementById(id), g=cv.getContext('2d');
  g.setTransform(1,0,0,1,0,0); g.fillStyle='#10141c'; g.fillRect(0,0,cv.width,cv.height);
  let lo=1e9,hi=-1e9;
  for(let i=0;i<=frame;i++)for(const j of [0,1]){lo=Math.min(lo,a[i][j]);hi=Math.max(hi,a[i][j]);}
  if(hi-lo<1e-12){hi=lo+1;}
  const X=i=>i/(N-1)*(cv.width-10)+5, Y=v=>cv.height-8-(v-lo)/(hi-lo)*(cv.height-16);
  for(const j of [0,1]){g.strokeStyle=cols[j]; g.beginPath();
    for(let i=0;i<=frame;i++){const x=X(i),y=Y(a[i][j]); i?g.lineTo(x,y):g.moveTo(x,y);}
    g.stroke(); g.fillStyle=cols[j]; g.fillText(names[j],8,12+12*j);}
}
function tick(){if(playing){const sp=+document.getElementById('speed').value;
  frame=Math.min(N-1,frame+Math.max(1,Math.round(sp)));
  if(frame>=N-1)playing=false; draw();}
  requestAnimationFrame(tick);}
document.getElementById('play').onclick=()=>{playing=!playing;
  if(frame>=N-1)frame=0;};
scrub.oninput=e=>{frame=+e.target.value; draw();};
document.getElementById('rot').oninput=e=>{rotU=+e.target.value; draw();};
document.getElementById('cam').onchange=draw;
scene.onwheel=e=>{e.preventDefault(); zoom*=e.deltaY<0?1.15:1/1.15; draw();};
let drag=null;
scene.onmousedown=e=>{drag=[e.clientX,e.clientY]; document.getElementById('cam').value='free';};
window.onmousemove=e=>{if(!drag)return; panX-=(e.clientX-drag[0])/zoom;
  panY+=(e.clientY-drag[1])/zoom; drag=[e.clientX,e.clientY]; draw();};
window.onmouseup=()=>{drag=null;};
draw(); tick();
</script></body></html>
"""
