"""Host-side episode viewer (twin of massive_marl_tpu/utils/viewer.py).

One episode of a batched env is rolled on its device and copied to the
host; `export_interactive` writes it as one self-contained HTML file (the
JAX package's template, byte for byte) and `render_topdown` as a PNG
(matplotlib, optional as in the JAX package).

Usage:
    from massive_marl_tpu_torch.utils.viewer import record_episode_3d, export_interactive
    ant, box = record_episode_3d(env, policy_fn, n_steps=200)
    export_interactive(ant, box, out="viewer.html")
"""
from __future__ import annotations

import numpy as np
import torch

from massive_marl_tpu_torch.envs.base import env_generator


def render_topdown(ant_xy, box_xy=None, goals=None, out: str = "episode.png",
                   arena=((-20, 20), (-20, 20))):
    """ant_xy: [T, A, 2]; box_xy: [T, 2] or None; goals: [A, 2] or None."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ant_xy = np.asarray(ant_xy)
    T, A, _ = ant_xy.shape
    fig, ax = plt.subplots(figsize=(6, 6))
    cmap = plt.get_cmap("tab10")
    for a in range(A):
        ax.plot(ant_xy[:, a, 0], ant_xy[:, a, 1], color=cmap(a % 10), lw=1.0,
                alpha=0.8, label=f"ant {a}" if A <= 10 else None)
        ax.scatter(ant_xy[-1, a, 0], ant_xy[-1, a, 1], color=cmap(a % 10), s=25,
                   zorder=3)
    if box_xy is not None:
        box_xy = np.asarray(box_xy)
        ax.plot(box_xy[:, 0], box_xy[:, 1], "k--", lw=1.5, label="box")
        ax.scatter(box_xy[-1, 0], box_xy[-1, 1], c="k", marker="s", s=60, zorder=3)
    if goals is not None:
        goals = np.asarray(goals)
        ax.scatter(goals[:, 0], goals[:, 1], marker="x", c="red", s=40, label="goals")
    ax.set_xlim(*arena[0])
    ax.set_ylim(*arena[1])
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    if A <= 10:
        ax.legend(fontsize=7, loc="upper right")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def _env_has_box(env) -> bool:
    """Whether the scene holds a push-box (AntSceneState carries a box pose
    placeholder either way, so the scene spec decides)."""
    return getattr(getattr(env, "spec", None), "box_sys", None) is not None


@torch.no_grad()
def record_episode_3d(env, policy_fn, n_steps: int = 200, seed: int = 0):
    """Roll one env for n_steps with actions = policy_fn(obs [1, num_obs])
    and return (ant_xyz [T, A, 3], box_xyz [T, 3] or None) as numpy.  The
    reset draws from a generator seeded with `seed`."""
    g = torch.Generator(device=torch.device(env.device))
    g.manual_seed(seed)
    has_box = _env_has_box(env)
    ants, boxes = [], []
    with env_generator(env, g):
        state = env.reset(1)
        for _ in range(n_steps):
            state = env.step_batch(state, policy_fn(state.obs))
            ants.append(state.pipeline.ant_qpos[0, :, 0:3])
            boxes.append(state.pipeline.box_qpos[0, 0:3])
    ant = torch.stack(ants).cpu().numpy()
    return ant, (torch.stack(boxes).cpu().numpy() if has_box else None)


def record_episode(env, policy_fn, n_steps: int = 200, seed: int = 0):
    """record_episode_3d without the height: (ant_xy [T, A, 2], box_xy
    [T, 2] or None)."""
    ant, box = record_episode_3d(env, policy_fn, n_steps, seed)
    return ant[..., 0:2], (None if box is None else box[:, 0:2])


_VIEWER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>massive_marl_tpu viewer</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px monospace; }}
 #hud {{ position:fixed; top:8px; left:10px; white-space:pre; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
const DATA = {data_json};
const ants = DATA.ant, box = DATA.box, goals = DATA.goals,
      border = DATA.borderline, T = ants.length, A = ants[0].length;
let t = 0, ft = 0, playing = true, speed = 1, trails = true,
    scale = 18, cx = 0, cy = 0, drag = null;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
function resize() {{ cv.width = innerWidth; cv.height = innerHeight - 80; }}
addEventListener('resize', resize); resize();
const COLORS = ['#4ec9f0','#f0a84e','#9ef04e','#f04e9e','#4ef0b8',
                '#b84ef0','#f0e44e','#f05b4e','#4e6df0','#8ff0e8'];
function sx(x) {{ return cv.width/2 + (x - cx) * scale; }}
function sy(y) {{ return cv.height/2 - (y - cy) * scale; }}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  ctx.strokeStyle = '#333';
  for (let g = -20; g <= 20; g += 5) {{
    ctx.beginPath(); ctx.moveTo(sx(g), sy(-20)); ctx.lineTo(sx(g), sy(20));
    ctx.moveTo(sx(-20), sy(g)); ctx.lineTo(sx(20), sy(g)); ctx.stroke();
  }}
  if (border) {{  // task borderline (reference ten_ant.py:229-256)
    ctx.strokeStyle = '#666'; ctx.setLineDash([6, 6]); ctx.beginPath();
    ctx.arc(sx(0), sy(0), border * scale, 0, 6.2832); ctx.stroke();
    ctx.setLineDash([]);
  }}
  if (goals) for (const g of goals) {{
    ctx.strokeStyle = '#f33'; ctx.beginPath();
    ctx.moveTo(sx(g[0])-5, sy(g[1])-5); ctx.lineTo(sx(g[0])+5, sy(g[1])+5);
    ctx.moveTo(sx(g[0])-5, sy(g[1])+5); ctx.lineTo(sx(g[0])+5, sy(g[1])-5);
    ctx.stroke();
  }}
  if (trails) for (let a = 0; a < A; a++) {{
    ctx.strokeStyle = COLORS[a % 10] + '55'; ctx.beginPath();
    for (let k = 0; k <= t; k++) {{
      const p = ants[k][a];
      k ? ctx.lineTo(sx(p[0]), sy(p[1])) : ctx.moveTo(sx(p[0]), sy(p[1]));
    }}
    ctx.stroke();
  }}
  if (box) {{
    const b = box[t]; ctx.fillStyle = '#ccc';
    ctx.fillRect(sx(b[0]) - 8, sy(b[1]) - 8, 16, 16);
  }}
  for (let a = 0; a < A; a++) {{
    const p = ants[t][a];
    ctx.fillStyle = COLORS[a % 10]; ctx.beginPath();
    ctx.arc(sx(p[0]), sy(p[1]), 3 + 8 * Math.max(0, Math.min(1, p[2])), 0, 6.2832);
    ctx.fill();
  }}
  document.getElementById('hud').textContent =
    `frame ${{t}}/${{T - 1}}  speed x${{speed}}  ${{playing ? 'PLAYING' : 'PAUSED'}}\\n` +
    `space pause | arrows step | +/- speed | t trails | drag pan | wheel zoom | r reset`;
}}
function tick() {{
  if (playing) {{ ft = (ft + speed) % T; if (ft < 0) ft += T; t = Math.floor(ft); }}
  draw(); requestAnimationFrame(tick);
}}
addEventListener('keydown', e => {{
  if (e.key === ' ') playing = !playing;
  else if (e.key === 'ArrowRight') {{ playing = false; t = (t + 1) % T; ft = t; }}
  else if (e.key === 'ArrowLeft') {{ playing = false; t = (t - 1 + T) % T; ft = t; }}
  else if (e.key === '+' || e.key === '=') speed = Math.min(speed * 2, 32);
  else if (e.key === '-') speed = Math.max(speed / 2, 0.25);
  else if (e.key === 't') trails = !trails;
  else if (e.key === 'r') {{ scale = 18; cx = cy = 0; t = 0; ft = 0; }}
}});
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{
  if (drag) {{ cx -= (e.clientX - drag[0]) / scale; cy += (e.clientY - drag[1]) / scale;
               drag = [e.clientX, e.clientY]; }}
}});
cv.addEventListener('wheel', e => {{ scale *= e.deltaY < 0 ? 1.15 : 0.87; e.preventDefault(); }});
tick();
</script></body></html>
"""


def export_interactive(ant_xyz, box_xyz=None, goals=None, borderline=None,
                       out: str = "viewer.html") -> str:
    """Interactive episode viewer: a single self-contained HTML file (canvas
    2D, no external assets - works in any browser, offline).

    Playback (pause/step/speed), pan/zoom camera, per-ant trails, the task
    borderline circle and goal markers - the counterpart of the
    reference's IsaacGym viewer loop (base_task.py:90-109 keyboard QUIT /
    toggle-sync events, camera at base_task.py:154-176, per-task borderline
    drawing ten_ant.py:229-256).  Height renders as marker size; data is
    embedded, so the file can be copied off the machine and opened locally.

    ant_xyz: [T, A, 3] (or [T, A, 2] - z treated as 0); box_xyz: [T, 3] or
    None; goals: [A, 2] or None; borderline: circle radius in meters or None.
    """
    import json

    ant = np.asarray(ant_xyz, dtype=np.float32)
    if ant.shape[-1] == 2:
        ant = np.concatenate([ant, np.zeros_like(ant[..., :1])], axis=-1)
    payload = {
        "ant": np.round(ant, 3).tolist(),
        "box": None if box_xyz is None
        else np.round(np.asarray(box_xyz, dtype=np.float32), 3).tolist(),
        "goals": None if goals is None
        else np.round(np.asarray(goals, dtype=np.float32), 3).tolist(),
        "borderline": None if borderline is None else float(borderline),
    }
    # un-escape the template's literal JS braces FIRST, then substitute the
    # payload - the other order would corrupt any payload that itself
    # contains a doubled-brace byte sequence
    html = _VIEWER_HTML.replace("{{", "{").replace("}}", "}")
    html = html.replace("{data_json}", json.dumps(payload))
    with open(out, "w") as f:
        f.write(html)
    return out
