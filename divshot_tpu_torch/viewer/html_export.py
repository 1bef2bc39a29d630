"""Self-contained HTML splat viewer (counterpart of
``divshot_tpu/viewer/html_export.py``, copied; the page is byte for byte
JAX's): parity with the reference editor's "export HTML view"
(``application/editor/source/html_view_template.hpp``): a WebGL2 viewer
(orbit controls, progressive depth sort) over the antimatter15 .splat
32-byte record layout.

Two data sources share the template:
- ``export_html``: one .html embedding the splat data (base64) — static;
- ``viewer/live.py``: the same page with a polling loader that refetches
  ``/splats`` while a TrainerSession trains (the reference's live training
  view, ``editor.cpp:1556-1575``).

``splat_bytes`` keeps numpy's ``argsort()[::-1]`` for the down-sampling,
so ties are ordered as in JAX. Parameters on any device are read back
through ``GaussianParams.compact_numpy``.
"""

from __future__ import annotations

import base64
import os

from divshot_tpu_torch.splat.gaussians import GaussianParams

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>divshot_tpu splat viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ddd;
   font-family:monospace}
 #info{position:absolute;left:8px;top:8px;z-index:2;font-size:12px;
   white-space:pre}
 canvas{width:100%;height:100%;display:block}
</style>
</head>
<body>
<div id="info">divshot_tpu — drag: orbit, wheel: zoom, right-drag: pan</div>
<canvas id="c"></canvas>
<script>
function b64ToBytes(b){const s=atob(b);const a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}

const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl2', {antialias:false});

const vsrc = `#version 300 es
precision highp float;
layout(location=0) in vec2 corner;       // quad corner in [-2,2]
layout(location=1) in vec3 center;
layout(location=2) in vec3 scale;
layout(location=3) in vec4 rgba;
layout(location=4) in vec4 quat;
uniform mat4 view, proj;
uniform vec2 focal, viewport;
out vec4 vColor; out vec2 vUv;
void main(){
  vec4 cam = view * vec4(center,1.0);
  if (cam.z >= -0.05){ gl_Position = vec4(0,0,2,1); return; }
  vec4 q = normalize(quat);
  float w=q.x,x=q.y,y=q.z,z=q.w;   // wxyz storage
  mat3 R = mat3(
    1.-2.*(y*y+z*z), 2.*(x*y+w*z), 2.*(x*z-w*y),
    2.*(x*y-w*z), 1.-2.*(x*x+z*z), 2.*(y*z+w*x),
    2.*(x*z+w*y), 2.*(y*z-w*x), 1.-2.*(x*x+y*y));
  mat3 S = mat3(scale.x,0,0, 0,scale.y,0, 0,0,scale.z);
  mat3 M = R*S;
  mat3 cov3 = M*transpose(M);
  mat3 W = mat3(view);
  float iz = 1.0/cam.z;
  mat3 J = mat3(focal.x*iz,0,0, 0,focal.y*iz,0,
                -focal.x*cam.x*iz*iz, -focal.y*cam.y*iz*iz, 0);
  mat3 T = J*W;
  mat3 cov2 = T*cov3*transpose(T);
  float a = cov2[0][0]+0.3, b = cov2[0][1], c = cov2[1][1]+0.3;
  float mid = 0.5*(a+c);
  float d = sqrt(max(mid*mid - (a*c-b*b), 0.0));
  float l1 = mid+d, l2 = max(mid-d, 0.0);
  vec2 e1 = normalize(vec2(b, l1-a));
  if (b==0.0) e1 = (a>=c)?vec2(1,0):vec2(0,1);
  vec2 v1 = e1*sqrt(2.0*l1), v2 = vec2(-e1.y,e1.x)*sqrt(2.0*l2);
  vec4 clip = proj*cam;
  vec2 ndc = clip.xy/clip.w;
  vec2 off = (corner.x*v1 + corner.y*v2) * 2.0 / viewport;
  gl_Position = vec4(ndc + off, clip.z/clip.w, 1.0);
  vColor = rgba; vUv = corner*2.0;
}`;
const fsrc = `#version 300 es
precision highp float;
in vec4 vColor; in vec2 vUv; out vec4 frag;
void main(){
  float r2 = dot(vUv,vUv);
  if (r2 > 4.0) discard;
  float alpha = vColor.a * exp(-0.5*r2*2.0);
  if (alpha < 0.0039) discard;
  frag = vec4(vColor.rgb*alpha, alpha);
}`;
function shader(ty,s){const sh=gl.createShader(ty);gl.shaderSource(sh,s);
  gl.compileShader(sh);
  if(!gl.getShaderParameter(sh,gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(sh);
  return sh;}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vsrc));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fsrc));
gl.linkProgram(prog); gl.useProgram(prog);

const quad=new Float32Array([-1,-1, 1,-1, -1,1, 1,1]);
function buf(loc,data,size,div){const b=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,data,gl.DYNAMIC_DRAW);
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribPointer(loc,size,gl.FLOAT,false,0,0);
  gl.vertexAttribDivisor(loc,div);return b;}
buf(0,quad,2,0);
let bc=null,bs=null,br=null,bq=null;

// splat state — rebuilt whenever new bytes arrive (live mode refetches)
let N=0, centers=null, scales=null, rgbas=null, quats=null, depths=null,
    order=null, cx=0, cy=0, cz=0, haveCenter=false;

function loadSplatBytes(bytes){
  const f32=new Float32Array(bytes.buffer,bytes.byteOffset,
                             bytes.byteLength>>2);
  const u8=bytes;
  N = bytes.byteLength/32|0;
  centers=new Float32Array(N*3); scales=new Float32Array(N*3);
  rgbas=new Float32Array(N*4); quats=new Float32Array(N*4);
  depths=new Float32Array(N); order=new Uint32Array(N);
  let sx=0,sy=0,sz=0;
  for(let i=0;i<N;i++){
    centers[i*3]=f32[i*8]; centers[i*3+1]=f32[i*8+1];
    centers[i*3+2]=f32[i*8+2];
    scales[i*3]=f32[i*8+3]; scales[i*3+1]=f32[i*8+4];
    scales[i*3+2]=f32[i*8+5];
    for(let k=0;k<4;k++) rgbas[i*4+k]=u8[i*32+24+k]/255;
    for(let k=0;k<4;k++) quats[i*4+k]=(u8[i*32+28+k]-128)/128;
    sx+=centers[i*3];sy+=centers[i*3+1];sz+=centers[i*3+2];
    order[i]=i;
  }
  if(!haveCenter && N>0){cx=sx/N;cy=sy/N;cz=sz/N;haveCenter=true;}
  function re(b,data,loc,size){if(b)gl.deleteBuffer(b);
    return buf(loc,data,size,1);}
  bc=re(bc,centers,1,3); bs=re(bs,scales,2,3);
  br=re(br,rgbas,3,4); bq=re(bq,quats,4,4);
  lastSort=-1e9;  // force immediate resort
}

let theta=0.6, phi=0.4, radius=4.0, panX=0, panY=0;
let dragging=0;
canvas.onmousedown=e=>{dragging=e.button===2?2:1;};
window.onmouseup=()=>dragging=0;
window.oncontextmenu=e=>e.preventDefault();
window.onmousemove=e=>{
  if(dragging===1){theta+=e.movementX*0.005;phi+=e.movementY*0.005;
    phi=Math.max(-1.5,Math.min(1.5,phi));}
  if(dragging===2){panX-=e.movementX*0.002*radius;
    panY+=e.movementY*0.002*radius;}};
window.onwheel=e=>{radius*=Math.exp(e.deltaY*0.001);};

function resort(view){
  for(let i=0;i<N;i++){
    depths[i]=view[2]*centers[i*3]+view[6]*centers[i*3+1]
             +view[10]*centers[i*3+2];}
  const idx=Array.from(order).sort((a,b)=>depths[a]-depths[b]);
  const rc=new Float32Array(N*3), rs=new Float32Array(N*3),
        rr=new Float32Array(N*4), rq=new Float32Array(N*4);
  for(let i=0;i<N;i++){const s=idx[i];
    rc.set(centers.subarray(s*3,s*3+3),i*3);
    rs.set(scales.subarray(s*3,s*3+3),i*3);
    rr.set(rgbas.subarray(s*4,s*4+4),i*4);
    rq.set(quats.subarray(s*4,s*4+4),i*4);}
  gl.bindBuffer(gl.ARRAY_BUFFER,bc);gl.bufferSubData(gl.ARRAY_BUFFER,0,rc);
  gl.bindBuffer(gl.ARRAY_BUFFER,bs);gl.bufferSubData(gl.ARRAY_BUFFER,0,rs);
  gl.bindBuffer(gl.ARRAY_BUFFER,br);gl.bufferSubData(gl.ARRAY_BUFFER,0,rr);
  gl.bindBuffer(gl.ARRAY_BUFFER,bq);gl.bufferSubData(gl.ARRAY_BUFFER,0,rq);
}

let lastSort=0;
function frame(t){
  canvas.width=innerWidth; canvas.height=innerHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  const ct=Math.cos(theta),st=Math.sin(theta),
        cp=Math.cos(phi),sp=Math.sin(phi);
  const eye=[cx+panX+radius*cp*st, cy+panY+radius*sp, cz+radius*cp*ct];
  const look=[cx+panX,cy+panY,cz];
  const f=norm3(sub3(look,eye)), r=norm3(cross3(f,[0,-1,0])),
        u=cross3(r,f);
  const view=new Float32Array([r[0],u[0],-f[0],0, r[1],u[1],-f[1],0,
    r[2],u[2],-f[2],0,
    -dot3(r,eye),-dot3(u,eye),dot3(f,eye),1]);
  const aspect=canvas.width/canvas.height, fy=1.732, fx=fy/aspect;
  const near=0.02,far=200.0;
  const proj=new Float32Array([fx,0,0,0, 0,fy,0,0,
    0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0]);
  if(N>0){
    if(t-lastSort>200){resort(view);lastSort=t;}
    gl.useProgram(prog);
    gl.uniformMatrix4fv(gl.getUniformLocation(prog,'view'),false,view);
    gl.uniformMatrix4fv(gl.getUniformLocation(prog,'proj'),false,proj);
    gl.uniform2f(gl.getUniformLocation(prog,'focal'),
      fx*canvas.width/2, fy*canvas.height/2);
    gl.uniform2f(gl.getUniformLocation(prog,'viewport'),
      canvas.width, canvas.height);
    gl.disable(gl.DEPTH_TEST);
    gl.enable(gl.BLEND);
    gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);
    gl.clearColor(0.05,0.05,0.08,1); gl.clear(gl.COLOR_BUFFER_BIT);
    gl.drawArraysInstanced(gl.TRIANGLE_STRIP,0,4,N);
  } else {
    gl.clearColor(0.05,0.05,0.08,1); gl.clear(gl.COLOR_BUFFER_BIT);
  }
  requestAnimationFrame(frame);
}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
  return [a[0]/l,a[1]/l,a[2]/l];}
requestAnimationFrame(frame);

__DATA_SOURCE__
</script>
</body>
</html>
"""

_STATIC_SOURCE = """
const SPLAT_B64 = "__SPLAT_DATA__";
loadSplatBytes(b64ToBytes(SPLAT_B64));
"""

_LIVE_SOURCE = """
const info = document.getElementById('info');
let generation = -1;
async function poll(){
  try{
    const st = await (await fetch('status')).json();
    info.textContent = `divshot_tpu LIVE  iter ${st.iteration}/` +
      `${st.max_iterations}  loss ${(st.loss??0).toFixed(4)}  ` +
      `splats ${st.num_splats}  [${st.phase}]`;
    if (st.generation !== generation){
      // send our stale generation: the server replies 304 if the snapshot
      // regressed to what we already hold (races), and ?max bounds the
      // payload via top-opacity decimation for very large sessions
      const r = await fetch(
        `splats?gen=${generation}&max=__MAX_SPLATS__`);
      if (r.ok && r.status !== 304){
        generation = parseInt(r.headers.get('X-Generation')
                              ?? st.generation);
        loadSplatBytes(new Uint8Array(await r.arrayBuffer()));
      }
    }
  }catch(e){ info.textContent = 'divshot_tpu LIVE — waiting for trainer'; }
  setTimeout(poll, __POLL_MS__);
}
poll();
"""


def render_template(data_source_js: str) -> str:
    return _TEMPLATE.replace("__DATA_SOURCE__", data_source_js)


def live_page(poll_ms: int = 1000, max_splats: int = 1_000_000) -> str:
    """The live-viewer page (used by ``viewer.live.LiveViewerServer``)."""
    src = _LIVE_SOURCE.replace("__POLL_MS__", str(poll_ms))
    src = src.replace("__MAX_SPLATS__", str(max_splats))
    return render_template(src)


def splat_bytes(params: GaussianParams, max_splats: int = 1_000_000
                ) -> bytes:
    """Pack params to antimatter15 .splat records (the wire format both
    viewer modes consume)."""
    from divshot_tpu_torch.gsio.ply import save_splat
    import tempfile

    d = params.compact_numpy()
    n = d["means"].shape[0]
    if n > max_splats:
        # keep the most opaque splats when downsampling for size
        idx = d["opacity"].argsort()[::-1][:max_splats]
        degree = {0: 0, 3: 1, 8: 2, 15: 3}[d["shN"].shape[1]]
        params = GaussianParams.create(
            d["means"][idx], scales=d["scales"][idx], quats=d["quats"][idx],
            opacity=d["opacity"][idx], sh0=d["sh0"][idx], shN=d["shN"][idx],
            sh_degree=degree, device="cpu")

    with tempfile.NamedTemporaryFile(suffix=".splat", delete=False) as f:
        tmp = f.name
    try:
        save_splat(tmp, params)
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        os.unlink(tmp)


def export_html(path: str, params: GaussianParams,
                max_splats: int = 1_000_000) -> str:
    """Write a single-file HTML splat viewer embedding ``params``."""
    raw = splat_bytes(params, max_splats)
    html = render_template(_STATIC_SOURCE).replace(
        "__SPLAT_DATA__", base64.b64encode(raw).decode())
    with open(path, "w") as f:
        f.write(html)
    return path
