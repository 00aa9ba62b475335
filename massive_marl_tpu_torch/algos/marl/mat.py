"""MAT: the Multi-Agent Transformer (twin of massive_marl_tpu/algos/marl/mat.py).

  * an encoder runs self-attention over the AGENT axis of the clipped
    per-agent observations [E, N, obs] and gives each agent a
    representation and a value; the team value is the agents' mean;
  * a causal decoder picks the actions agent by agent: in the rollout one
    KV-cached single-token step per agent (`decode_step`, caches [E, N,
    heads, D]), fed the previous agent's sampled action (zeros for agent
    0); the joint log-prob is the sum over the agents;
  * the update is ppo_epoch full-batch steps over the T * E rows: the
    scalar ValueNorm first takes the returns, then the clipped joint
    surrogate (the decoder teacher-forced on the shifted batch actions)
    and max(huber(ret_n - v), huber(ret_n - v_clip)) at delta 10; the
    optimizer clips the whole tree's global norm (max_grad_norm), then Adam
    with eps 1e-5;
  * eval acts with the means of N full decodes per step, not the cache.
Everything is float32, in flax's conventions: LayerNorm eps 1e-6 (the fast
variance E[x^2] - E[x]^2), GELU in its tanh form, attention masked with
-1e9 and written as explicit products and a softmax.  Parameters are one
tree in flax's layout ({"params": {"encoder": {"LayerNorm_0", "Dense_0",
"Block_i": {"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln2", "fc1", "fc2"},
"LayerNorm_1", "Dense_1"}, "decoder": {"embed_act", "blks_i", "ln_out",
"head", "log_std"}}}, Dense kernels [in, out]), so a checkpoint
({"params", "iteration"}) is the JAX runner's file.  The rollout's normal
draws go through `_normal` ([E, act] per agent and step).

Under a `mesh` (parallel/mesh.py) each rank steps its E / R envs and holds
an equal share of the full batch: the advantages are normalised by their
global mean and std, and the value normalizer's moments, the gradients and
the losses are averaged over the ranks.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.algos.marl import nets
from massive_marl_tpu_torch.algos.marl.runner import episode_returns
from massive_marl_tpu_torch.algos.nets import orthogonal_
from massive_marl_tpu_torch.algos.rl.offpolicy import dense, init_dense
from massive_marl_tpu_torch.algos.rl.ppo import AdamState, adam_update
from massive_marl_tpu_torch.envs.base import eval_generator, evaluate_episodes
from massive_marl_tpu_torch.parallel.mesh import LOCAL, draw
from massive_marl_tpu_torch.utils import bridge, checkpoint, msgpack_lite
from massive_marl_tpu_torch.utils.logging import Writer, fetch_metrics
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from massive_marl_tpu_torch.wrap.vec_task import split_multi_agent_obs


# ---------------------------------------------------------------------------
# the model (functions of the flax parameter tree)
# ---------------------------------------------------------------------------

def _ln(p, x):
    """flax LayerNorm: fast variance, eps 1e-6."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mu * mu, 0.0)
    return (x - mu) * (torch.rsqrt(var + nets.EPS) * p["scale"]) + p["bias"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _attend(q, k, v, mask):
    """q [..., q, H, D], k/v [..., k, H, D], mask broadcastable to [..., H,
    q, k] (True: attend) or None -> [..., q, H, D]."""
    att = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        att = torch.where(mask, att, torch.full_like(att, -1e9))
    return torch.einsum("...hqk,...khd->...qhd", torch.softmax(att, dim=-1), v)


def attention(p, x, heads: int, causal: bool):
    """SelfAttention over the agent axis of x [..., N, embed]."""
    *lead, n, embed = x.shape
    split = lambda y: y.reshape(*lead, n, heads, embed // heads)
    mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device)) if causal else None
    out = _attend(split(dense(p["wq"], x)), split(dense(p["wk"], x)),
                  split(dense(p["wv"], x)), mask)
    return dense(p["wo"], out.reshape(*lead, n, embed))


def attention_step(p, x, cache_k, cache_v, idx: int, heads: int):
    """The causal branch restricted to row idx, with a KV cache: x [E, 1,
    embed]; writes this token's k/v into the caches [E, N, heads, D] at idx
    (in place) and attends over the rows <= idx."""
    E, _, embed = x.shape
    D = embed // heads
    q = dense(p["wq"], x).reshape(E, 1, heads, D)
    cache_k[:, idx] = dense(p["wk"], x).reshape(E, heads, D)
    cache_v[:, idx] = dense(p["wv"], x).reshape(E, heads, D)
    mask = torch.arange(cache_k.shape[1], device=x.device) <= idx
    out = _attend(q, cache_k, cache_v, mask)
    return dense(p["wo"], out.reshape(E, 1, embed))


def block(p, x, heads: int, causal: bool = False):
    x = x + attention(p["attn"], _ln(p["ln1"], x), heads, causal)
    return x + dense(p["fc2"], _gelu(dense(p["fc1"], _ln(p["ln2"], x))))


def block_step(p, x, cache_k, cache_v, idx: int, heads: int):
    x = x + attention_step(p["attn"], _ln(p["ln1"], x), cache_k, cache_v, idx, heads)
    return x + dense(p["fc2"], _gelu(dense(p["fc1"], _ln(p["ln2"], x))))


@dataclass(frozen=True)
class MatModel:
    act_dim: int
    embed: int = 64
    blocks: int = 2
    heads: int = 1

    def init(self, obs_dim: int, generator: torch.Generator) -> dict:
        """flax's init: Dense lecun_normal kernels and zero biases, LayerNorm
        ones and zeros, the action head orthogonal(0.01), log_std log 0.5."""
        e = self.embed
        lin = lambda a, b: init_dense(a, b, generator)
        ln = lambda d: {"scale": torch.ones(d), "bias": torch.zeros(d)}

        def blk():
            return {"ln1": ln(e), "attn": {w: lin(e, e) for w in ("wq", "wk", "wv", "wo")},
                    "ln2": ln(e), "fc1": lin(e, 4 * e), "fc2": lin(4 * e, e)}
        enc = {"LayerNorm_0": ln(obs_dim), "Dense_0": lin(obs_dim, e),
               **{f"Block_{i}": blk() for i in range(self.blocks)},
               "LayerNorm_1": ln(e), "Dense_1": lin(e, 1)}
        head = torch.empty(e, self.act_dim)
        orthogonal_(head, 0.01, generator)
        dec = {"embed_act": lin(self.act_dim, e),
               **{f"blks_{i}": blk() for i in range(self.blocks)},
               "ln_out": ln(e), "head": {"kernel": head, "bias": torch.zeros(self.act_dim)},
               "log_std": torch.full((self.act_dim,), math.log(0.5))}
        return {"params": {"encoder": enc, "decoder": dec}}

    def encode(self, params, obs):
        """obs [..., N, obs_dim] -> (repr [..., N, embed], values [..., N])."""
        p = params["params"]["encoder"]
        x = _gelu(dense(p["Dense_0"], _ln(p["LayerNorm_0"], obs)))
        for i in range(self.blocks):
            x = block(p[f"Block_{i}"], x, self.heads)
        return x, dense(p["Dense_1"], _ln(p["LayerNorm_1"], x)).squeeze(-1)

    def decode(self, params, rep, prev_actions):
        """(repr, shifted previous actions [..., N, act]) -> (mean, std),
        each [..., N, act]: the causal decoder over all N tokens."""
        p = params["params"]["decoder"]
        x = dense(p["embed_act"], prev_actions) + rep
        for i in range(self.blocks):
            x = block(p[f"blks_{i}"], x, self.heads, causal=True)
        mean = dense(p["head"], _ln(p["ln_out"], x))
        return mean, torch.exp(p["log_std"]).expand(mean.shape)

    def decode_step(self, params, rep_i, prev_a_i, caches, idx: int):
        """One cached token: rep_i [E, 1, embed], prev_a_i [E, 1, act];
        caches ((k, v),) * blocks, each [E, N, heads, D], written in place at
        idx.  Returns (mean [E, act], std [act])."""
        p = params["params"]["decoder"]
        x = dense(p["embed_act"], prev_a_i) + rep_i
        for i, (ck, cv) in enumerate(caches):
            x = block_step(p[f"blks_{i}"], x, ck, cv, idx, self.heads)
        return dense(p["head"], _ln(p["ln_out"], x))[:, 0], torch.exp(p["log_std"])


def joint_log_prob(mean, std, actions):
    """The Gaussian log-prob summed over the action dims and the agents."""
    return nets.normal_log_prob(mean, std, actions).sum(-1)


# ---------------------------------------------------------------------------
# config / state
# ---------------------------------------------------------------------------

@dataclass
class MatConfig:
    episode_length: int = 8
    num_env_steps: int = 50_000_000
    gamma: float = 0.96
    gae_lambda: float = 0.95
    clip_param: float = 0.2
    ppo_epoch: int = 5
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.0
    max_grad_norm: float = 10.0
    lr: float = 5e-4
    embed: int = 64
    blocks: int = 2
    heads: int = 1
    clip_obs: float = 7.0
    clip_actions: float = 1.0
    save_interval: int = 200

    @classmethod
    def from_cfg_train(cls, cfg_train: dict) -> "MatConfig":
        """Build from cfg/mat/config.yaml with the JAX key map (the YAML's
        clip_observations / clip_actions are not read; the defaults are
        equal)."""
        cfg_train = cfg_train if isinstance(cfg_train, dict) else {}
        fields = ("episode_length", "num_env_steps", "gamma", "gae_lambda", "clip_param",
                  "ppo_epoch", "value_loss_coef", "entropy_coef", "max_grad_norm", "lr",
                  "embed", "blocks", "heads", "save_interval")
        kw = {k: cfg_train[k] for k in fields if cfg_train.get(k) is not None}
        for f in ("gamma", "gae_lambda", "clip_param", "value_loss_coef", "entropy_coef",
                  "max_grad_norm", "lr"):
            if f in kw:
                kw[f] = float(kw[f])
        return cls(**kw)


@dataclass
class MatTrainState:
    params: dict
    opt: AdamState
    vnorm: nets.ValueNorm     # scalar running stats of the team returns
    env_state: Any
    iteration: int = 0
    ep_ret: torch.Tensor | None = None
    last_ep_ret: torch.Tensor | None = None
    ep_count: torch.Tensor | None = None


class MatRunner:
    """MAT trainer over a task of many agents (shared team reward):
    MatRunner(env, num_envs, cfg).run(num_env_steps)."""

    def __init__(self, env, num_envs: int, cfg: MatConfig | None = None, seed: int = 0,
                 log_dir: str | None = None, print_log: bool = True, mesh=None, device=None):
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, runner on {self.device}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.env = env
        self.num_envs = num_envs
        self.cfg = cfg or MatConfig()
        self.seed = seed
        self.log_dir = log_dir
        self.print_log = print_log
        self.N = env.num_agents
        self.act_dim = env.num_actions
        self.obs_dim = env.num_ant_obs + (env.num_obs - env.num_agents * env.num_ant_obs)
        c = self.cfg
        self.model = MatModel(self.act_dim, c.embed, c.blocks, c.heads)
        self.mesh = mesh or LOCAL
        self.local_envs = self.mesh.shard_env(env, num_envs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.generator = self.mesh.shard_generator(gen, num_envs)
        self.state: MatTrainState | None = None
        self.last_metrics: Dict[str, float] = {}

    def init_state(self) -> MatTrainState:
        g = torch.Generator()
        g.manual_seed(self.seed)
        params = tree_map(lambda x: x.to(self.device), self.model.init(self.obs_dim, g))
        leaves = tree_leaves(params)
        E = self.local_envs
        zeros = lambda dtype=torch.float32: torch.zeros(E, dtype=dtype, device=self.device)
        self.state = MatTrainState(
            params=params, opt=AdamState(mu=[torch.zeros_like(p) for p in leaves],
                                         nu=[torch.zeros_like(p) for p in leaves]),
            vnorm=nets.ValueNorm.create((), device=self.device), env_state=self.env.reset(E),
            ep_ret=zeros(), last_ep_ret=zeros(), ep_count=zeros(torch.int32))
        return self.state

    def _normal(self, shape):
        """[E, act] (over the global envs under a mesh)."""
        return draw(torch.randn, shape, self.generator, device=self.device)

    def _obs_view(self, obs_buf):
        """[E, full] -> the clipped per-agent obs [E, N, obs_dim]."""
        c = self.cfg
        return split_multi_agent_obs(torch.clamp(obs_buf, -c.clip_obs, c.clip_obs), self.N,
                                     self.env.num_ant_obs)

    def decode_autoregressive(self, params, rep):
        """Sampled actions agent by agent, each conditioned on the sampled
        actions of the agents before it, one cached decoder token per
        agent.  Returns (actions, mean, std), each [E, N, act]."""
        c = self.cfg
        E, N, A = rep.shape[0], self.N, self.act_dim
        D = c.embed // c.heads
        caches = [(rep.new_zeros(E, N, c.heads, D), rep.new_zeros(E, N, c.heads, D))
                  for _ in range(c.blocks)]
        prev = rep.new_zeros(E, A)
        actions, means = [], []
        for i in range(N):
            mean, std = self.model.decode_step(params, rep[:, i:i + 1], prev[:, None], caches, i)
            prev = mean + std * self._normal((E, A))
            actions.append(prev)
            means.append(mean)
        mean = torch.stack(means, 1)
        return torch.stack(actions, 1), mean, std.expand(mean.shape)

    # ---------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout_phase(self) -> Dict[str, torch.Tensor]:
        """episode_length steps of the encoder, the cached decode and the env
        step; advances the env state and returns the [T, E, ...]
        trajectory (obs [T,E,N,obs], actions [T,E,N,act], logp, value,
        reward, done)."""
        cfg, st = self.cfg, self.state
        E = self.local_envs
        env_state, steps = st.env_state, []
        for _ in range(cfg.episode_length):
            obs = self._obs_view(env_state.obs)
            rep, values = self.model.encode(st.params, obs)
            actions, mean, std = self.decode_autoregressive(st.params, rep)
            a_clip = torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions)
            nxt = self.env.step_batch(env_state, a_clip.reshape(E, -1))
            steps.append(dict(obs=obs, actions=actions, logp=joint_log_prob(mean, std, actions),
                              value=values.mean(-1), reward=nxt.reward, done=nxt.done.float()))
            env_state = nxt
        st.env_state = env_state
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    # ----------------------------------------------------------------- update
    def _loss(self, params, vn, batch):
        """(clipped joint surrogate + value_loss_coef * value loss, (policy
        loss, value loss))."""
        cfg = self.cfg
        rep, values = self.model.encode(params, batch["obs"])
        acts = batch["actions"]
        prev = torch.cat([torch.zeros_like(acts[:, :1]), acts[:, :-1]], dim=1)
        mean, std = self.model.decode(params, rep, prev)
        ratio = torch.exp(joint_log_prob(mean, std, acts) - batch["logp"])
        adv = batch["adv"]
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        policy_loss = -surr.mean()
        v = values.mean(-1)
        ret_n = vn.normalize(batch["returns"])
        v_clip = batch["value"] + torch.clamp(v - batch["value"], -cfg.clip_param, cfg.clip_param)
        vloss = torch.maximum(nets.huber(ret_n - v, 10.0), nets.huber(ret_n - v_clip, 10.0)).mean()
        return policy_loss + cfg.value_loss_coef * vloss, (policy_loss.detach(), vloss.detach())

    def update_phase(self, traj: Dict[str, torch.Tensor], last_obs: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
        """GAE on the denormalized team values and ppo_epoch full-batch
        steps; returns the iteration's metrics (device tensors)."""
        cfg, st, mesh = self.cfg, self.state, self.mesh
        T, E = traj["reward"].shape
        with torch.no_grad():
            _, last_v = self.model.encode(st.params, self._obs_view(last_obs))
            v_den = st.vnorm.denormalize(traj["value"])
            nv = torch.cat([v_den[1:], st.vnorm.denormalize(last_v.mean(-1))[None]], 0)
            r, d = traj["reward"], traj["done"]
            adv, out = torch.zeros(E, device=self.device), []
            for t in reversed(range(T)):
                delta = r[t] + cfg.gamma * nv[t] * (1 - d[t]) - v_den[t]
                adv = delta + cfg.gamma * cfg.gae_lambda * (1 - d[t]) * adv
                out.append(adv)
            adv = torch.stack(out[::-1])
            returns = adv + v_den
            mean, std = mesh.mean_std(adv)
            adv_n = (adv - mean) / (std + 1e-5)
        rows = T * E
        batch = dict(obs=traj["obs"].reshape(rows, self.N, -1),
                     actions=traj["actions"].reshape(rows, self.N, -1),
                     logp=traj["logp"].reshape(rows), value=traj["value"].reshape(rows),
                     adv=adv_n.reshape(rows), returns=returns.reshape(rows))
        leaves = tree_leaves(st.params)
        pl, vl = [], []
        ret = batch["returns"]
        moments = None if mesh is LOCAL else tuple(mesh.mean([ret.mean(), (ret * ret).mean()]))
        for _ in range(cfg.ppo_epoch):
            st.vnorm = st.vnorm.update(ret, moments)
            req = [p.detach().requires_grad_() for p in leaves]
            loss, (p_loss, v_loss) = self._loss(tree_unflatten(st.params, req), st.vnorm, batch)
            grads = list(torch.autograd.grad(loss, req))
            if mesh is not LOCAL:
                *grads, p_loss, v_loss = mesh.mean(grads + [p_loss, v_loss])
            adam_update(leaves, grads, st.opt, cfg.lr, cfg.max_grad_norm, eps=1e-5)
            pl.append(p_loss)
            vl.append(v_loss)
        st.iteration += 1
        return dict(mean_reward=mesh.mean(traj["reward"].mean()),
                    policy_loss=torch.stack(pl).mean(), value_loss=torch.stack(vl).mean(),
                    **episode_returns(st, traj, mesh))

    def train_iter(self):
        traj = self.rollout_phase()
        return self.update_phase(traj, self.state.env_state.obs)

    # ---------------------------------------------------------------- driving
    def run(self, num_env_steps: int | None = None, log_interval: int = 1):
        spi = self.cfg.episode_length * self.num_envs
        n = max(1, int((num_env_steps or self.cfg.num_env_steps) // spi))
        if self.state is None:
            self.init_state()
        writer = Writer(self.log_dir) if self.log_dir else None
        for it in range(self.state.iteration, n):
            t0 = time.perf_counter()
            metrics = self.train_iter()
            if it % log_interval == 0:
                m = fetch_metrics(metrics)
                m["fps"] = spi / (time.perf_counter() - t0)
                self.last_metrics = m
                if writer:
                    writer.add_scalar("train/mean_reward", m["mean_reward"], it)
                    writer.add_scalar("train/value_loss", m["value_loss"], it)
                    if m["episodes_done"] > 0:
                        writer.add_scalar("train_episode_rewards", m["episode_rewards"], it * spi)
                if self.print_log:
                    print(f"[mat] it {it}: rew {m['mean_reward']:.3f} fps {m['fps']:.0f}",
                          flush=True)
            if self.log_dir and self.cfg.save_interval and (it + 1) % self.cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"mat_{it + 1}.ckpt"))
        if writer:
            writer.close()
        return self.state

    def save(self, path: str):
        """The parameters and the iteration (the JAX runner's file)."""
        tree = bridge.mat_state_to_flax(self.state.params, self.state.iteration)
        checkpoint.atomic_write_bytes(path, msgpack_lite.packb(checkpoint.to_host(tree)))

    def restore(self, path: str):
        """Parameters and iteration from a file of either package; the
        optimizer moments and the value normalizer stay, as in the JAX
        runner."""
        if self.state is None:
            self.init_state()
        st = self.state
        params, iteration = bridge.mat_state_from_flax(checkpoint.load_tree(path), st.params)
        st.params = checkpoint.restore_into(st.params, params)
        st.iteration = iteration

    @torch.no_grad()
    def eval(self, n_episodes: int | None = None, deterministic: bool = True):
        """Deterministic episodes in num_envs dedicated envs (reset from seed
        + 10_000 and the iteration): each step N full decodes, agent i taking
        the mean of the i-th, conditioned on the means before it; actions
        clipped to [-1, 1]; the mean first-episode return."""
        if self.state is None:
            self.init_state()
        params, E, N = self.state.params, self.num_envs, self.N

        def policy(obs_buf):
            rep, _ = self.model.encode(params, self._obs_view(obs_buf))
            actions = rep.new_zeros(E, N, self.act_dim)
            for i in range(N):
                prev = torch.cat([torch.zeros_like(actions[:, :1]), actions[:, :-1]], dim=1)
                mean, _ = self.model.decode(params, rep, prev)
                actions[:, i] = mean[:, i]
            return torch.clamp(actions, -1.0, 1.0).reshape(E, -1)

        return evaluate_episodes(self.env, E, policy,
                                 eval_generator(self.seed, self.device, self.state.iteration))

