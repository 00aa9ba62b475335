"""Recurrent MAPPO in plain PyTorch: the reference that the benchmark holds
the port's first recurrent MAPPO iterations to.

rMAPPO as Yu et al. publish it ("The Surprising Effectiveness of PPO in
Cooperative Multi-Agent Games", arXiv:2103.01955, the recurrent policy that
is the paper's default), with the settings of
SafeRL-Lab/Massive-MARL-Benchmark's cfg/mappo/config.yaml and
use_recurrent_policy, on TenAnt (tenant.py).  Each of the N = 10 agents has
an actor on its own 46 observation values and a critic on the 388-value
state (use_centralized_V), each MLPBase (mappo.py: a feature LayerNorm,
then 1 + layer_N blocks of Dense(hidden) -> ELU -> LayerNorm), then flax's
GRUCell(hidden):

    r = sigmoid(W_ir x + b_ir + W_hr h)
    z = sigmoid(W_iz x + b_iz + W_hz h)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h,

with h zeroed where mask = 1 - (the env's done before the step) is 0, then
the heads on h' (the actor's mean and its std sigmoid(p / std_x_coef) *
std_y_coef, the critic's value).  The hidden states of the actor and the
critic [N, E, H] are carried from step to step and from one iteration to
the next.  An iteration is an episode_length rollout, then per agent GAE on
the PopArt-denormalised values and the advantages normalised over the
agent's rows, then per agent (one after another) ppo_epoch steps, each on
one minibatch of every env's whole rollout (data_chunk_length null: one
chunk of T steps an env; cfg/mappo's num_mini_batch 1): the actor's
clipped surrogate and the critic's clipped Huber value loss, each through
the T-step GRU loop from the hidden state that the rollout started from
(backpropagation through time), each with its own Adam after a global-norm
clip over that agent's net.

Where this departs from the published rMAPPO (and follows the system it
checks, the benchmark's source repository), besides mappo.py's departures
(ELU, the feature LayerNorm always on, PopArt's cadence, the clip with no
epsilon, the advantages' normaliser, the team reward, no active or bad
masks):
  * the GRU's output goes to the heads without a LayerNorm;
  * one GRU layer (recurrent_N 1) and one chunk of the whole rollout an env;
  * every epoch re-runs the GRU from the rollout-start hidden states that
    the rollout recorded, as the published recurrent generator does.

Precision, as the configuration states it: the bases act and update as
flax's Dense(dtype=bf16) (mappo.py's acting form), differentiated as
written (bf16 products and cotangents); the GRU, the heads, the value math,
GAE and Adam in float32, TF32 off.

`precision="control"` is the next precision down: the bases' operands in
fp8 (e4m3, one scale per tensor), the GRU and the heads in TF32.
`precision="reorder"` is a sound program that rounds otherwise: the bases'
products summed in float32 and rounded to bf16 once, the GRU's and the
heads' products summed over two halves of their inputs and added.
`fault` plants one of the faults that the comparison must catch
(reference/ppo.py FAULTS): "half_batch" (each step's actor and critic
loss over the first half of the envs), "altered" (the reward of every
eighth env zeroed where the env produces it).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench.reference.mappo import OWN, MAPPORef, _rows
from port_bench.reference.tenant import A


def _product(x, w, precision):
    """x [n, M, in] @ w [n, in, out] in float32 (TF32 as the caller set it);
    `reorder` sums two halves of the inputs."""
    if precision == "reorder":
        k = x.shape[-1] // 2
        return torch.bmm(x[..., :k], w[:, :k]) + torch.bmm(x[..., k:], w[:, k:])
    return torch.bmm(x, w)


class MAPPORNNRef(MAPPORef):
    """The reference trainer, started from the benchmark's agent-stacked
    leaves ({"actor/GRUCell_0/ir/kernel": [N, H, H], ...}) and random
    streams."""

    def __init__(self, cfg: dict, clip: dict, env_cfg: dict, sim_cfg: dict, num_envs: int,
                 leaves: Dict[str, torch.Tensor], env_gen: torch.Generator,
                 pol_gen: torch.Generator, precision: str = "stated", fault: str | None = None):
        if not cfg.get("use_recurrent_policy") or cfg.get("recurrent_N", 1) != 1 or \
                cfg.get("data_chunk_length") not in (None, cfg["episode_length"]):
            raise ValueError("the reference computes one GRU layer over whole-rollout chunks")
        super().__init__(cfg, clip, env_cfg, sim_cfg, num_envs, leaves, env_gen, pol_gen,
                         precision=precision, fault=fault)
        H = cfg["hidden_size"]
        dev = leaves["actor/std_param"].device
        self.h = {net: torch.zeros(self.N, num_envs, H, device=dev)
                  for net in ("actor", "critic")}

    # ------------------------------------------------------------------ nets
    def _dense(self, p, x):
        return _product(x.float(), p["kernel"], self.precision) + _rows(p["bias"], x)

    def _cell(self, g, x, h):
        """flax GRUCell on the bf16 x [n, M, H] and the float32 h [n, M, H]:
        each input product takes x to float32 on its own, as flax's Dense
        promotes it, so x's gradient is the sum of three bf16 cotangents."""
        lin = lambda name, v: _product(v, g[name]["kernel"], self.precision)
        r = torch.sigmoid(self._dense(g["ir"], x) + lin("hr", h))
        z = torch.sigmoid(self._dense(g["iz"], x) + lin("hz", h))
        n = torch.tanh(self._dense(g["in"], x) + r * self._dense(g["hn"], h))
        return (1.0 - z) * n + z * h

    def _seq(self, p, x, h, mask):
        """A net's base, then its GRU through the steps: x [n, T, M, in], h
        [n, M, H] before the first step, mask [T, M] -> hidden states [n,
        T, M, H]."""
        n, T, M = x.shape[:3]
        feats = self._base_acting(p["MLPBase_0"], x.reshape(n, T * M, -1)).reshape(n, T, M, -1)
        out = []
        for t in range(T):
            h = self._cell(p["GRUCell_0"], feats[:, t], h * mask[t][None, :, None])
            out.append(h)
        return torch.stack(out, 1)

    def _heads(self, net, p, hs):
        n = hs.shape[0]
        y = self._dense(p["Dense_0"], hs.reshape(n, -1, hs.shape[-1])).reshape(*hs.shape[:-1], -1)
        if net == "critic":
            return y.squeeze(-1)
        return y, _rows(self._std(p["std_param"]), y).expand(y.shape)

    # --------------------------------------------------------------- acting
    def _views(self, obs_buf):
        E = obs_buf.shape[0]
        own = obs_buf[:, :A * OWN].reshape(E, A, OWN)
        shared = obs_buf[:, A * OWN:][:, None, :].expand(E, A, obs_buf.shape[1] - A * OWN)
        obs = torch.cat([own, shared], dim=-1).transpose(0, 1)                 # [N, E, 46]
        return obs, obs_buf[None].expand(self.N, *obs_buf.shape).contiguous()

    def _step(self, net, x, done):
        """One acting step of every agent's net on x [N, E, in] from the
        carried hidden state: (its heads' output, the new hidden state)."""
        p = self.tree(self.of(net))
        hs = self._seq(p, x[:, None], self.h[net], 1.0 - done.float()[None])
        out = self._heads(net, p, hs)
        return tuple(o[:, 0] for o in out) if net == "actor" else out[:, 0], hs[:, 0]

    @torch.no_grad()
    def rollout(self) -> Dict[str, torch.Tensor]:
        clip_obs, clip_act = self.clip["obs"], self.clip["actions"]
        s, steps = self.state, []
        h0 = dict(self.h)
        for _ in range(self.cfg["episode_length"]):
            obs_buf = torch.clamp(s.obs, -clip_obs, clip_obs)
            obs, cin = self._views(obs_buf)
            (mean, std), self.h["actor"] = self._step("actor", obs, s.done)
            # the runner draws the noise env-major, [E, N, act]
            noise = torch.randn((self.E, self.N, mean.shape[-1]), generator=self.pol_gen,
                                device=mean.device).transpose(0, 1)
            actions = mean + std * noise
            logp = self.log_prob(mean, std, actions)
            value, self.h["critic"] = self._step("critic", cin, s.done)
            a = torch.clamp(actions, -clip_act, clip_act).transpose(0, 1).reshape(self.E, -1)
            mask = 1.0 - s.done.float()
            s = self.env.step(s, a, self.env_gen)
            if self.fault == "altered":
                s.reward = s.reward.clone()
                s.reward[::8] = 0.0
            steps.append(dict(obs=obs, share=obs_buf, actions=actions, logp=logp, values=value,
                              reward=s.reward, done=s.done.float(), mask=mask))
        self.state = s
        traj = {k: torch.stack([st[k] for st in steps], dim=1 if k in ("obs", "actions", "logp",
                                                                          "values") else 0)
                for k in steps[0]}
        return dict(traj, h0_actor=h0["actor"], h0_critic=h0["critic"])

    # --------------------------------------------------------------- update
    def _leaves(self, net, agent):
        """One agent's leaves of a net, fresh for a gradient, and their tree
        with a leading agent axis of 1."""
        leaves = {n: v.detach().clone().requires_grad_(True)
                  for n, v in self.of(net, agent).items()}
        return leaves, self.tree({n: v[None] for n, v in leaves.items()})

    def _half_envs(self, d):
        """d as a step's loss reads it: every env, or with `half_batch` the
        first half ([T, E, ...] entries on axis 1, the hiddens on axis 0)."""
        if self.fault != "half_batch":
            return d
        half = lambda t, axis: t.narrow(axis, 0, t.shape[axis] // 2)
        return {k: half(v, 0 if k.startswith("h0_") else 1) for k, v in d.items()}

    def _actor_step(self, agent, d):
        cfg = self.cfg
        d = self._half_envs(d)
        leaves, p = self._leaves("actor", agent)
        mean, std = self._heads("actor", p, self._seq(p, d["obs"][None], d["h0_actor"][None],
                                                      d["mask"]))
        ratio = torch.exp(self.log_prob(mean[0], std[0], d["actions"]) - d["logp"])
        clip, adv = cfg["clip_param"], d["adv"]
        obj = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        ent = torch.sum(torch.log(std) + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
        surrogate = -obj.mean()
        loss = surrogate - cfg["entropy_coef"] * ent.mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        self._adam("actor", agent, dict(zip(leaves, grads)))
        return surrogate.detach()

    def _critic_step(self, agent, d):
        cfg = self.cfg
        pa = {k: v[agent] for k, v in self.popart.items()}
        st1 = self._popart_step(pa, d["returns"])
        m1, s1 = self._stats(st1)
        st2 = self._popart_step(st1, d["returns"])
        m2, s2 = self._stats(st2)
        for k in self.popart:
            self.popart[k][agent] = st2[k]
        d = self._half_envs(d)
        leaves, p = self._leaves("critic", agent)
        values = self._heads("critic", p, self._seq(p, d["cin"][None], d["h0_critic"][None],
                                                    d["mask"]))[0]
        old, ret, clip = d["values"], d["returns"], cfg["clip_param"]
        v_clip = old + torch.clamp(values - old, -clip, clip)
        loss_o = self._huber((ret - m2) / s2 - values)
        loss_c = self._huber((ret - m1) / s1 - v_clip)
        v_loss = torch.maximum(loss_o, loss_c).mean()
        grads = torch.autograd.grad(cfg["value_loss_coef"] * v_loss, list(leaves.values()))
        self._adam("critic", agent, dict(zip(leaves, grads)))
        return v_loss.detach()

    def update(self, traj) -> Dict[str, torch.Tensor]:
        cfg, N = self.cfg, self.N
        T, E = traj["reward"].shape
        with torch.no_grad():
            _, cin = self._views(torch.clamp(self.state.obs, -self.clip["obs"], self.clip["obs"]))
            last, _ = self._step("critic", cin, self.state.done)     # carries nothing on
            m, s = self._stats(self.popart)
            den = lambda x: x * s.reshape(N, *[1] * (x.dim() - 1)) + m.reshape(
                N, *[1] * (x.dim() - 1))
            v, last = den(traj["values"]), den(last)                       # [N, T, E], [N, E]
            nv = torch.cat([v[:, 1:], last[:, None]], dim=1)
            r, d = traj["reward"], traj["done"]
            adv, advs = torch.zeros_like(last), []
            for t in reversed(range(T)):
                delta = r[t] + cfg["gamma"] * nv[:, t] * (1 - d[t]) - v[:, t]
                adv = delta + cfg["gamma"] * cfg["gae_lambda"] * (1 - d[t]) * adv
                advs.append(adv)
            raw = torch.stack(advs[::-1], dim=1)
            flat = raw.reshape(N, T * E)
            adv = (flat - flat.mean(1, keepdim=True)) / (flat.std(1, correction=0,
                                                                  keepdim=True) + 1e-5)
            returns = raw + v
        a_losses, v_losses = [], []
        for i in range(N):
            # one minibatch of every env's whole rollout: the runner draws no permutation
            data = dict(obs=traj["obs"][i], cin=traj["share"], actions=traj["actions"][i],
                        logp=traj["logp"][i], values=traj["values"][i],
                        adv=adv[i].reshape(T, E), returns=returns[i], mask=traj["mask"],
                        h0_actor=traj["h0_actor"][i], h0_critic=traj["h0_critic"][i])
            al, vl = [], []
            for _ in range(cfg["ppo_epoch"]):
                al.append(self._actor_step(i, data))
                vl.append(self._critic_step(i, data))
                if i == 0 and "loss" not in self.first:
                    self.first["loss"] = float(al[0]) + cfg["value_loss_coef"] * float(vl[0])
            a_losses.append(torch.stack(al).mean())
            v_losses.append(torch.stack(vl).mean())
        return dict(policy_loss=torch.stack(a_losses).mean(),
                    value_loss=torch.stack(v_losses).mean(),
                    mean_reward=traj["reward"].mean())

    def train_iter(self) -> Dict[str, float]:
        cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return super().train_iter()
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn
