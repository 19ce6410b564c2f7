"""Embedded single-page front-end (original implementation; mirrors the
reference's control surface -- src/app.rs panels and the index.html
controls -- without reusing its code)."""

INDEX_HTML = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>cfd-demo-jax</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 1rem; background: #111; color: #ddd; }
  h1 { font-size: 1.2rem; }
  .tabs button, .controls button { margin-right: .5rem; padding: .4rem .8rem; }
  .row { display: flex; gap: 1.5rem; align-items: center; flex-wrap: wrap; margin: .5rem 0; }
  .row label { font-size: .85rem; }
  canvas, img.frame { border: 1px solid #444; image-rendering: pixelated; }
  #log { width: 100%; height: 10rem; background: #000; color: #9f9;
         font-family: monospace; font-size: .75rem; overflow-y: scroll;
         white-space: pre; padding: .3rem; }
  select, input[type=number] { background: #222; color: #ddd; }
  .hidden { display: none; }
</style>
</head>
<body>
<h1>cfd-demo-jax &mdash; 2D incompressible Navier&ndash;Stokes</h1>
<div class="tabs">
  <button onclick="showTab('sim')">Simulation</button>
  <button onclick="showTab('mesh')">Mesh</button>
</div>

<div id="tab-sim">
  <div class="row controls">
    <button onclick="control('start')">Start / Resume</button>
    <button onclick="control('pause')">Pause</button>
    <button onclick="control('reset')">Reset</button>
    <span>view:</span>
    <button onclick="setMode('pressure')">Pressure</button>
    <button onclick="setMode('velocity')">Velocity</button>
    <button onclick="setMode('vorticity')">Vorticity</button>
    <label><input type="checkbox" id="tracers"> tracers</label>
  </div>
  <div class="row">
    <label>dt <input type="number" id="dt" value="0.005" step="0.001" min="0" max="1"></label>
    <label>viscosity <input type="number" id="viscosity" value="0.000001" step="0.000001" min="0" max="0.1"></label>
    <label>inlet <input type="number" id="inlet" value="1.0" step="0.1" min="0" max="5"></label>
    <label>scheme <select id="scheme">
      <option value="first">FirstOrder</option>
      <option value="second">SecondOrder</option>
      <option value="quick">QUICK</option></select></label>
    <label>profile <select id="profile">
      <option value="uniform">Uniform</option>
      <option value="parabolic">Parabolic</option>
      <option value="parabolic-upper">Parabolic (upper half)</option></select></label>
    <label>solver <select id="solver">
      <option value="jacobi">Jacobi</option>
      <option value="sor">SOR (red/black)</option>
      <option value="multigrid">Multigrid</option>
      <option value="mg-production">MG (production)</option>
      <option value="fdm">FDM (exact direct)</option></select></label>
    <label>case <select id="flow_case">
      <option value="channel">Channel + cylinder</option>
      <option value="cavity">Lid-driven cavity</option></select></label>
    <label>semantics <select id="semantics" onchange="semanticsChanged()">
      <option value="rust">Rust (fixed substeps)</option>
      <option value="js">JS (adaptive substeps)</option></select></label>
    <label id="rdslabel" style="display:none"><input type="checkbox"
      id="residual_dt_scaling"> residual dt scaling</label>
    <span id="substeps" style="font-size:.85rem"></span>
    <button onclick="sendParams()">Update</button>
  </div>
  <img id="frame" class="frame" src="/api/frame" width="800">
  <div class="row"><img id="legend" src="/api/legend" width="256" height="20">
    <span style="font-size:.8rem">min &rarr; max</span>
    <span id="forces" style="font-size:.85rem;margin-left:1.5rem"></span></div>
  <h3>Residuals</h3>
  <canvas id="resgraph" width="800" height="160"></canvas>
  <div id="log"></div>
</div>

<div id="tab-mesh" class="hidden">
  <div class="row">
    <label>feature size <input type="range" id="feature" min="0.01" max="0.5"
      step="0.01" value="0.2"> <span id="featureval">0.2</span></label>
    <label>max cell size <input type="range" id="max_cell" min="0.1" max="1.0"
      step="0.05" value="1.0"> <span id="maxval">1.0</span></label>
    <button onclick="tesselate()">Tesselate</button>
  </div>
  <div class="row">
    <span>sketch:</span>
    <button onclick="sketchMode('outer')">Draw outline</button>
    <button onclick="sketchMode('hole')">Draw hole</button>
    <button onclick="closeRing()">Close ring</button>
    <button onclick="clearSketch()">Clear</button>
    <button onclick="defaultSketch()">Default sketch</button>
    <span id="sketchmsg" style="font-size:.8rem;color:#fa5"></span>
  </div>
  <canvas id="sketch" width="900" height="300"
          style="border:1px solid #444;background:#181818;cursor:crosshair"></canvas>
  <img id="meshimg" class="frame" width="900">
</div>

<script>
let mode = 'velocity';
let streaming = false;
function showTab(t) {
  document.getElementById('tab-sim').classList.toggle('hidden', t !== 'sim');
  document.getElementById('tab-mesh').classList.toggle('hidden', t !== 'mesh');
}
// Interactive-rate frames: the server pushes PNG parts over
// multipart/x-mixed-replace (>= 10 fps while the sim steps); the
// 250 ms polling path below stays as the fallback if the stream dies.
function attachStream() {
  const tr = document.getElementById('tracers').checked ? 1 : 0;
  const img = document.getElementById('frame');
  img.onerror = () => { streaming = false; };
  streaming = true;
  img.src = `/api/stream?mode=${mode}&tracers=${tr}&t=${Date.now()}`;
}
function setMode(m) { mode = m; if (streaming) attachStream(); else refreshFrame(); }
async function control(action) {
  await fetch('/api/control', {method: 'POST', body: JSON.stringify({action})});
  if (action === 'start' && !streaming) attachStream();
}
async function sendParams() {
  const p = {};
  for (const k of ['dt', 'viscosity', 'inlet'])
    p[k] = parseFloat(document.getElementById(k).value);
  for (const k of ['scheme', 'profile', 'solver', 'flow_case', 'semantics'])
    p[k] = document.getElementById(k).value;
  p.residual_dt_scaling =
    document.getElementById('residual_dt_scaling').checked;
  await fetch('/api/params', {method: 'POST', body: JSON.stringify(p)});
}
function semanticsChanged() {
  // residual-based dt scaling is the JS twin's checkbox (index.html:75)
  const js = document.getElementById('semantics').value === 'js';
  document.getElementById('rdslabel').style.display = js ? '' : 'none';
}
function refreshFrame() {
  const tr = document.getElementById('tracers').checked ? 1 : 0;
  document.getElementById('frame').src =
    `/api/frame?mode=${mode}&tracers=${tr}&t=${Date.now()}`;
}
function drawGraph(hist) {
  const c = document.getElementById('resgraph');
  const ctx = c.getContext('2d');
  ctx.fillStyle = '#000'; ctx.fillRect(0, 0, c.width, c.height);
  const series = [['u', '#f55'], ['v', '#5f5'], ['p', '#59f']];
  const n = hist.step.length;
  if (n < 2) return;
  let maxv = 0.01;
  for (const [k] of series)
    for (const v of hist[k]) if (v > maxv) maxv = v;
  for (const [k, color] of series) {
    ctx.strokeStyle = color; ctx.beginPath();
    for (let i = 0; i < n; i++) {
      const x = i / (n - 1) * (c.width - 10) + 5;
      const y = c.height - 5 - (hist[k][i] / maxv) * (c.height - 10);
      if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
    }
    ctx.stroke();
  }
  ctx.fillStyle = '#ddd';
  ctx.fillText(`max ${maxv.toExponential(2)}  (red=U green=V blue=P)`, 8, 12);
}
async function poll() {
  try {
    const r = await fetch('/api/state');
    const s = await r.json();
    document.getElementById('log').textContent =
      (s.error ? 'SIM THREAD ERROR (auto-paused): ' + s.error + '\n' : '')
      + s.log.join('\n');
    // Multi-obstacle scenes deliberately send cd/cl = null (the
    // normalization scale is ambiguous) with finite raw fx/fy; only a
    // non-finite raw force means the run actually diverged.
    document.getElementById('forces').textContent =
      (s.forces && Number.isFinite(s.forces.cd) && Number.isFinite(s.forces.cl))
      ? `C_d ${s.forces.cd.toFixed(2)}  C_l ${s.forces.cl >= 0 ? '+' : ''}${s.forces.cl.toFixed(2)}`
      : (s.forces && Number.isFinite(s.forces.fx) && Number.isFinite(s.forces.fy))
      ? `Fx ${s.forces.fx.toExponential(2)}  Fy ${s.forces.fy.toExponential(2)}`
      : (s.forces ? 'forces: diverged' : '');
    const el = document.getElementById('log');
    el.scrollTop = el.scrollHeight;
    document.getElementById('substeps').textContent =
      (s.substeps != null && s.params.semantics === 'js')
      ? `substeps: ${s.substeps}` : '';
    drawGraph(s.history);
    if (s.running && !streaming) refreshFrame();
  } catch (e) {}
  setTimeout(poll, 250);
}
// ----- sketch editor (world: 30x10, y up; canvas 900x300) -----
const W = 30, H = 10, CW = 900, CH = 300;
let sketch = {outer: [], holes: [], current: [], mode: 'outer'};
function defaultSketch() {
  sketch.outer = [[0,0],[30,0],[30,10],[0,10]];
  const c = [7.5, 5], r = 1.5;  // rotated square hole (mesh_view.rs:140)
  sketch.holes = [[[c[0]+r,c[1]],[c[0],c[1]+r],[c[0]-r,c[1]],[c[0],c[1]-r]]];
  sketch.current = []; drawSketch(); msg('');
}
function sketchMode(m) { sketch.mode = m; sketch.current = []; drawSketch(); }
function clearSketch() { sketch = {outer: [], holes: [], current: [], mode: 'outer'}; drawSketch(); msg(''); }
function closeRing() {
  if (sketch.current.length < 3) { msg('need at least 3 vertices'); return; }
  if (sketch.mode === 'outer') sketch.outer = sketch.current;
  else sketch.holes.push(sketch.current);
  sketch.current = []; drawSketch(); msg('');
}
function msg(t) { document.getElementById('sketchmsg').textContent = t; }
function toPx(p) { return [p[0]/W*(CW-1), (1 - p[1]/H)*(CH-1)]; }
function drawSketch() {
  const c = document.getElementById('sketch'), ctx = c.getContext('2d');
  ctx.fillStyle = '#181818'; ctx.fillRect(0, 0, CW, CH);
  const rings = [[sketch.outer, '#7af'], ...sketch.holes.map(h => [h, '#f77']),
                 [sketch.current, sketch.mode === 'outer' ? '#7af' : '#f77']];
  for (const [ring, color] of rings) {
    if (!ring.length) continue;
    ctx.strokeStyle = color; ctx.fillStyle = color;
    ctx.beginPath();
    ring.forEach((p, i) => {
      const [x, y] = toPx(p);
      if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
      ctx.fillRect(x - 2, y - 2, 4, 4);
    });
    if (ring !== sketch.current) ctx.closePath();
    ctx.stroke();
  }
}
document.getElementById('sketch').onclick = e => {
  const r = e.target.getBoundingClientRect();
  const x = (e.clientX - r.left) / r.width * W;
  const y = (1 - (e.clientY - r.top) / r.height) * H;
  sketch.current.push([Math.round(x * 100) / 100, Math.round(y * 100) / 100]);
  drawSketch();
};
async function tesselate() {
  const f = document.getElementById('feature').value;
  const m = document.getElementById('max_cell').value;
  document.getElementById('featureval').textContent = f;
  document.getElementById('maxval').textContent = m;
  if (sketch.outer.length >= 3) {
    const r = await fetch('/api/mesh', {method: 'POST', body: JSON.stringify(
      {feature: parseFloat(f), max_cell: parseFloat(m),
       outer: sketch.outer, holes: sketch.holes})});
    if (!r.ok) { try { msg((await r.json()).error); } catch (e) { msg('invalid polygon'); } return; }
    msg('');
    const img = document.getElementById('meshimg');
    if (img.src.startsWith('blob:')) URL.revokeObjectURL(img.src);  // no blob leak per click
    img.src = URL.createObjectURL(await r.blob());
  } else {
    document.getElementById('meshimg').src =
      `/api/mesh?feature=${f}&max_cell=${m}&t=${Date.now()}`;
  }
}
defaultSketch();
document.getElementById('feature').oninput = e =>
  document.getElementById('featureval').textContent = e.target.value;
document.getElementById('max_cell').oninput = e =>
  document.getElementById('maxval').textContent = e.target.value;
document.getElementById('tracers').onchange = () =>
  { if (streaming) attachStream(); };
attachStream();
poll();
</script>
</body>
</html>
"""
