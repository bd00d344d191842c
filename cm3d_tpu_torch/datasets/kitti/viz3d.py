"""Interactive 3D LiDAR viewer: self-contained WebGL HTML export.
Mirrors `cm3d_tpu/datasets/kitti/viz3d.py` (numpy on the host).

A rebuild of the reference's mayavi point-cloud viewer suite
(src/kitti/kitti_object.py: show_lidar_with_depth:372, show_lidar_with_boxes,
draw_lidar / draw_gt_boxes3d in its viz_util import). mayavi needs a GL
display server; this writer instead emits ONE dependency-free HTML file
(vanilla WebGL, no CDN fetches — works fully offline) with the same
affordances: orbit / zoom / pan, height- or intensity-colored points, and
3D box wireframes with class labels.

Point payloads are embedded as base64 Float32 binary (xyzi), so a 100k-point
frame is ~2 MB of HTML — openable anywhere, archivable next to artifacts.
"""

from __future__ import annotations

import base64
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cm3d_tpu_torch.datasets.kitti.calib import Calibration, Object3d, compute_box_3d

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]

# class -> wireframe RGB (0-1), loosely the reference's mayavi palette
_CLASS_COLORS = {
    "Car": (0.2, 1.0, 0.4),
    "Pedestrian": (1.0, 0.85, 0.2),
    "Cyclist": (0.3, 0.6, 1.0),
    "Truck": (1.0, 0.4, 0.2),
    "Van": (0.6, 1.0, 0.6),
}
_DEFAULT_COLOR = (1.0, 0.3, 0.3)


def _b64_f32(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()).decode()


def boxes_to_segments(
    objects: Sequence[Object3d], calib: Optional[Calibration]
) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """3D label objects -> velodyne-frame wireframe segments.

    Returns (segments [S,2,3], seg_colors [S,3], label dicts for billboards).
    When calib is None the corners are assumed to already be in the display
    frame.
    """
    segs, cols, labels = [], [], []
    for obj in objects:
        corners = compute_box_3d(obj)  # [8,3] rect camera frame
        pts = calib.project_rect_to_velo(corners) if calib is not None else corners
        c = _CLASS_COLORS.get(obj.type, _DEFAULT_COLOR)
        for a, b in _BOX_EDGES:
            segs.append([pts[a], pts[b]])
            cols.append(c)
        top = pts[4:8].mean(axis=0)
        labels.append(
            {"p": [float(v) for v in top], "t": obj.type, "c": list(c)}
        )
    if not segs:
        return (
            np.zeros((0, 2, 3), np.float32),
            np.zeros((0, 3), np.float32),
            [],
        )
    return (
        np.asarray(segs, np.float32),
        np.asarray(cols, np.float32),
        labels,
    )


def export_scene_html(
    points: np.ndarray,
    path: str,
    objects: Sequence[Object3d] = (),
    calib: Optional[Calibration] = None,
    extra_segments: Optional[np.ndarray] = None,
    title: str = "cm3d-tpu LiDAR viewer",
    max_points: int = 400_000,
) -> str:
    """Write the interactive viewer HTML. points: [N,3] or [N,4] (xyz[i]).

    Returns the path written. Deterministically subsamples past max_points.
    """
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] not in (3, 4):
        raise ValueError(f"points must be [N,3] or [N,4], got {pts.shape}")
    if pts.shape[1] == 3:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[idx]

    segs, seg_cols, labels = boxes_to_segments(objects, calib)
    if extra_segments is not None and len(extra_segments):
        ex = np.asarray(extra_segments, np.float32).reshape(-1, 2, 3)
        segs = np.concatenate([segs, ex], axis=0) if len(segs) else ex
        seg_cols = np.concatenate(
            [seg_cols, np.tile([[0.7, 0.7, 0.7]], (len(ex), 1))], axis=0
        ) if len(seg_cols) else np.tile([[0.7, 0.7, 0.7]], (len(ex), 1))

    meta = {
        "n": int(len(pts)),
        "nseg": int(len(segs)),
        "zmin": float(pts[:, 2].min()) if len(pts) else 0.0,
        "zmax": float(pts[:, 2].max()) if len(pts) else 1.0,
        "labels": labels,
        "title": title,
    }
    # json.dumps leaves "</" verbatim — a title/label containing
    # "</script>" would terminate the script element mid-JSON and blank
    # the viewer; "<\/" is identical JSON but inert inside <script>
    html = _TEMPLATE.replace(
        "__META__", json.dumps(meta).replace("</", "<\\/")
    )
    html = html.replace("__PTS_B64__", _b64_f32(pts))
    html = html.replace("__SEG_B64__", _b64_f32(segs.reshape(-1, 3)))
    html = html.replace("__SEGC_B64__", _b64_f32(seg_cols))
    with open(path, "w") as f:
        f.write(html)
    return path


def show_lidar_with_boxes(
    root: str,
    index: int,
    out_path: str,
    pred_dir: Optional[str] = None,
) -> str:
    """Reference show_lidar_with_boxes (kitti_object.py:372-466) equivalent:
    one KITTI frame -> viewer HTML with GT (and optional predicted) boxes."""
    from cm3d_tpu_torch.datasets.kitti.calib import read_label
    from cm3d_tpu_torch.datasets.kitti.frontend import KittiDataset

    ds = KittiDataset(root)
    calib = ds.get_calibration(index)
    objects = list(ds.get_label_objects(index))
    if pred_dir:
        import os

        p = f"{pred_dir}/{index:06d}.txt"
        if os.path.exists(p):
            objects += read_label(p)
    return export_scene_html(
        ds.get_lidar(index), out_path, objects, calib,
        title=f"KITTI {index:06d}",
    )


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Interactive 3D LiDAR viewer (HTML export)"
    )
    p.add_argument("--dataroot", required=True)
    p.add_argument("--indices", required=True,
                   help="comma-separated KITTI frame indices")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--pred_dir", default=None)
    args = p.parse_args(argv)
    import os

    os.makedirs(args.out_dir, exist_ok=True)
    for i in (int(s) for s in args.indices.split(",")):
        out = show_lidar_with_boxes(
            args.dataroot, i, f"{args.out_dir}/{i:06d}.html", args.pred_dir
        )
        print(out)


_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>cm3d-tpu viewer</title>
<style>
 body{margin:0;background:#0b0e14;color:#cdd6f4;font:12px monospace;overflow:hidden}
 #hud{position:fixed;left:10px;top:8px;z-index:2;user-select:none}
 #hud b{color:#fff}
 canvas{display:block}
 .lab{position:fixed;z-index:1;pointer-events:none;font:bold 11px monospace;
      text-shadow:0 0 3px #000}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
const META = __META__;
function decode(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
const PTS=decode("__PTS_B64__");   // xyzi interleaved
const SEG=decode("__SEG_B64__");   // xyz per segment endpoint
const SEGC=decode("__SEGC_B64__"); // rgb per segment
const cv=document.getElementById("c");
const gl=cv.getContext("webgl");
const hud=document.getElementById("hud");
hud.innerHTML="<b>"+META.title+"</b> &mdash; "+META.n+" pts, "+META.nseg+
 " edges<br>drag: orbit &middot; wheel: zoom &middot; shift-drag: pan &middot; "+
 "<span id=mode>[c] color: height</span>";
const VS=`attribute vec3 p;attribute float w;uniform mat4 mvp;uniform float ps;
 varying float vw;void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vw=w;}`;
const FS=`precision mediump float;varying float vw;
 vec3 ramp(float t){t=clamp(t,0.,1.);
  return vec3(clamp(1.5-abs(4.*t-3.),0.,1.),clamp(1.5-abs(4.*t-2.),0.,1.),
              clamp(1.5-abs(4.*t-1.),0.,1.));}
 void main(){gl_FragColor=vec4(ramp(vw),1.);}`;
const VSL=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;varying vec3 vc;
 void main(){gl_Position=mvp*vec4(p,1.);vc=c;}`;
const FSL=`precision mediump float;varying vec3 vc;
 void main(){gl_FragColor=vec4(vc,1.);}`;
function prog(vs,fs){function sh(t,src){const s=gl.createShader(t);
  gl.shaderSource(s,src);gl.compileShader(s);return s;}
 const p=gl.createProgram();gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p;}
const P1=prog(VS,FS),P2=prog(VSL,FSL);
// buffers: points xyz + weight (height or intensity)
const n=META.n;
const xyz=new Float32Array(n*3),hw=new Float32Array(n),iw=new Float32Array(n);
let imax=1e-6;
for(let i=0;i<n;i++){xyz[3*i]=PTS[4*i];xyz[3*i+1]=PTS[4*i+1];xyz[3*i+2]=PTS[4*i+2];
 hw[i]=(PTS[4*i+2]-META.zmin)/Math.max(1e-6,META.zmax-META.zmin);
 iw[i]=PTS[4*i+3];if(iw[i]>imax)imax=iw[i];}
for(let i=0;i<n;i++)iw[i]/=imax;
function buf(data){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const bXYZ=buf(xyz),bH=buf(hw),bI=buf(iw),bSeg=buf(SEG);
const segColor=new Float32Array(SEG.length);
for(let s=0;s<META.nseg;s++)for(let e=0;e<2;e++)for(let k=0;k<3;k++)
 segColor[(2*s+e)*3+k]=SEGC[3*s+k];
const bSegC=buf(segColor);
// camera
let yaw=-0.8,pitch=0.45,dist=60,tgt=[15,0,0],colorMode=0;
function mat(){const a=cv.width/cv.height,f=1/Math.tan(0.4),zn=0.5,zf=2000;
 const pr=[f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1, 0,0,2*zf*zn/(zn-zf),0];
 const cp=Math.cos(pitch),sp=Math.sin(pitch),cy=Math.cos(yaw),sy=Math.sin(yaw);
 const eye=[tgt[0]+dist*cp*cy,tgt[1]+dist*cp*sy,tgt[2]+dist*sp];
 let zx=eye[0]-tgt[0],zy=eye[1]-tgt[1],zz=eye[2]-tgt[2];
 const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 let xx=-zy,xy=zx,xz=0;const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const tx=-(xx*eye[0]+xy*eye[1]+xz*eye[2]);
 const ty=-(yx*eye[0]+yy*eye[1]+yz*eye[2]);
 const tz=-(zx*eye[0]+zy*eye[1]+zz*eye[2]);
 const v=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0, tx,ty,tz,1];
 const m=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=pr[k*4+j]*v[i*4+k];m[i*4+j]=s;}
 return {m:m,v:v,pr:pr};}
function project(m,p){const x=m[0]*p[0]+m[4]*p[1]+m[8]*p[2]+m[12];
 const y=m[1]*p[0]+m[5]*p[1]+m[9]*p[2]+m[13];
 const w=m[3]*p[0]+m[7]*p[1]+m[11]*p[2]+m[15];
 if(w<=0)return null;return [(x/w*0.5+0.5)*cv.width,(0.5-y/w*0.5)*cv.height];}
const labEls=META.labels.map(L=>{const d=document.createElement("div");
 d.className="lab";d.textContent=L.t;
 d.style.color="rgb("+L.c.map(v=>Math.round(255*v)).join(",")+")";
 document.body.appendChild(d);return d;});
function draw(){cv.width=innerWidth;cv.height=innerHeight;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.043,0.055,0.078,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const M=mat();
 gl.useProgram(P1);
 gl.uniformMatrix4fv(gl.getUniformLocation(P1,"mvp"),false,M.m);
 gl.uniform1f(gl.getUniformLocation(P1,"ps"),Math.max(1.2,140/dist));
 const lp=gl.getAttribLocation(P1,"p");gl.enableVertexAttribArray(lp);
 gl.bindBuffer(gl.ARRAY_BUFFER,bXYZ);gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
 const lw=gl.getAttribLocation(P1,"w");gl.enableVertexAttribArray(lw);
 gl.bindBuffer(gl.ARRAY_BUFFER,colorMode?bI:bH);
 gl.vertexAttribPointer(lw,1,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.POINTS,0,n);
 if(META.nseg){gl.useProgram(P2);
  gl.uniformMatrix4fv(gl.getUniformLocation(P2,"mvp"),false,M.m);
  const sp=gl.getAttribLocation(P2,"p");gl.enableVertexAttribArray(sp);
  gl.bindBuffer(gl.ARRAY_BUFFER,bSeg);gl.vertexAttribPointer(sp,3,gl.FLOAT,false,0,0);
  const sc=gl.getAttribLocation(P2,"c");gl.enableVertexAttribArray(sc);
  gl.bindBuffer(gl.ARRAY_BUFFER,bSegC);gl.vertexAttribPointer(sc,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.LINES,0,META.nseg*2);}
 META.labels.forEach((L,i)=>{const q=project(M.m,L.p);
  if(q){labEls[i].style.left=q[0]+"px";labEls[i].style.top=q[1]+"px";
   labEls[i].style.display="block";}else labEls[i].style.display="none";});
}
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){const s=dist*0.0016,cy=Math.cos(yaw),sy=Math.sin(yaw);
  tgt[0]+=s*(dx*sy+dy*cy);tgt[1]+=s*(-dx*cy+dy*sy);}
 else{yaw-=dx*0.005;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.005));}
 drag=[e.clientX,e.clientY,drag[2]];draw();};
window.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);
 dist=Math.min(800,Math.max(2,dist));draw();};
window.onkeydown=e=>{if(e.key=="c"){colorMode^=1;
 document.getElementById("mode").textContent=
  "[c] color: "+(colorMode?"intensity":"height");draw();}};
window.onresize=draw;
draw();
</script></body></html>
"""


if __name__ == "__main__":
    main()
