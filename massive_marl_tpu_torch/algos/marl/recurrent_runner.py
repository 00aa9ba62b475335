"""Recurrent MARL runner: MAPPO / IPPO / HAPPO with GRU policies (twin of
massive_marl_tpu/algos/marl/recurrent_runner.py).

The reference's recurrent path (`use_recurrent_policy`) trains with
chunked BPTT over `data_chunk_length`:
  * the nets are nets.MarlActorRNN / MarlCriticRNN (MLPBase -> GRUCell ->
    heads), agent-stacked as in the feed-forward runner; the update never
    runs on the fused kernels B2/B3 (the reference's recurrent nets are
    flax MLPBase), whatever `use_fused_mlp` says;
  * the hidden states actor_h / critic_h [N, E, H] are carried across
    iterations in the state and zeroed where mask = 1 - (the pre-step
    done) is 0;
  * L = data_chunk_length (None: the whole rollout, L = T) splits each
    [T, E] rollout into C = (T // L) * E chunks, chunk index chunk_t * E + e
    (`to_chunks`); every update re-runs the GRU through each L-step chunk
    from the hidden state recorded at its start (`chunk_starts`; recorded
    per step only when T // L > 1);
  * per-agent GAE on the denormalized values, with no time-limit mask;
    advantages normalized per agent by the population std + 1e-5;
  * MAPPO/IPPO update every agent independently (all N at once here, the
    reference's vmap): ppo_epoch x num_mini_batch steps, each agent drawing
    its own permutation of the C chunks per epoch when num_mini_batch > 1;
    HAPPO and HATRPO both take the HAPPO path: the agents in a random order,
    each with clipped-PPO steps weighted by the factor [L, C] that the
    agents before it built from their sequence log-probs, before and after
    their update (no trust-region step);
  * in each step the actor steps before the critic (MarlRunner._update_once,
    the same optimizer and value-target cadence as the feed-forward runner).
Random draws go through `_normal` (the rollout's noise, [E, N, act]),
`_chunk_perm` and `_agent_perm`, so the tests can feed both packages the
same numbers.  The checkpoint is the parent's file (the JAX runner's, GRU
leaves included); the hidden states are not in it, as in the reference.

Under a `mesh` the update is the single-process one (GSPMD in the JAX
package), on the parent's global path: each rank holds its E / R envs'
chunks, the chunk permutation is drawn over every rank's chunks and each
rank keeps its own, and the losses, gradients and value-norm moments are
sums over its rows divided by the global minibatch size, summed over the
ranks.  A MAPPO/IPPO minibatch then holds a different number of a rank's
chunks for each agent, so each agent steps on its own (the agents are
independent, as the single-process joint step is).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import torch

from massive_marl_tpu_torch.algos.marl import nets
from massive_marl_tpu_torch.algos.marl.runner import (AdamState, MarlConfig, MarlRunner,
                                                      MarlTrainState, _nested_mean,
                                                      episode_returns)
from massive_marl_tpu_torch.envs.base import eval_generator, evaluate_episodes
from massive_marl_tpu_torch.parallel.mesh import draw
from massive_marl_tpu_torch.utils.tree import tree_map


@dataclass
class RecurrentMarlTrainState(MarlTrainState):
    actor_h: torch.Tensor | None = None     # [N, E, H]
    critic_h: torch.Tensor | None = None    # [N, E, H]


def to_chunks(x, L: int):
    """[n, T, E, ...] -> [n, L, C, ...]: time split into whole chunks of L
    steps, the chunk index folded into the batch axis as chunk_t * E + e."""
    n, T, E = x.shape[:3]
    x = x.reshape(n, T // L, L, E, *x.shape[3:]).transpose(1, 2)
    return x.reshape(n, L, (T // L) * E, *x.shape[4:])


def chunk_starts(h_seq, L: int):
    """Chunk-start hiddens [n, C, H] from per-step hiddens [n, T, E, H]."""
    n, T, E, H = h_seq.shape
    return h_seq[:, ::L].reshape(n, (T // L) * E, H)


def _take(v, ix, axis: int):
    """v's entries at per-agent indices ix [n, m] along `axis` (v [n, ...])."""
    shape = [1] * v.dim()
    shape[0], shape[axis] = ix.shape
    idx = ix.reshape(shape).expand(*v.shape[:axis], ix.shape[1], *v.shape[axis + 1:])
    return torch.gather(v, axis, idx)


# the data's keys and their chunk axis (h0: [n, C, H]; the rest [n, L, C, ...])
_CHUNK_AXIS = {"ah0": 1, "ch0": 1}
# the keys the losses read per row, flattened to [n, L * B, ...]
_ROW_KEYS = ("actions", "logp", "values", "adv", "returns", "factor", "active")


class RecurrentMarlRunner(MarlRunner):
    """RecurrentMarlRunner(env, num_envs, cfg).run(num_env_steps)."""

    def __init__(self, env, num_envs: int, cfg: MarlConfig | None = None, seed: int = 0,
                 log_dir: str | None = None, print_log: bool = True, mesh=None, device=None):
        cfg = cfg or MarlConfig()
        L = cfg.data_chunk_length
        if L is not None and cfg.episode_length % int(L) != 0:
            raise ValueError(
                f"data_chunk_length={L} must divide episode_length={cfg.episode_length} "
                f"(the reference's recurrent generator slices whole chunks)")
        super().__init__(env, num_envs, cfg, seed, log_dir, print_log, mesh=mesh, device=device)
        c = self.cfg
        self.H = c.hidden_size
        self.L = int(L) if L else c.episode_length
        self.chunked = c.episode_length // self.L > 1
        self.use_fused = self.shard_local = False
        self.actor = nets.MarlActorRNN(act_dim=self.act_dim, hidden_size=c.hidden_size,
                                       layer_n=c.layer_n, gain=c.gain,
                                       std_x_coef=c.std_x_coef, std_y_coef=c.std_y_coef)
        self.critic = nets.MarlCriticRNN(hidden_size=c.hidden_size, layer_n=c.layer_n)

    def init_state(self) -> RecurrentMarlTrainState:
        st = super().init_state()
        zeros = lambda: torch.zeros(self.N, self.local_envs, self.H, device=self.device)
        self.state = RecurrentMarlTrainState(
            **{f.name: getattr(st, f.name) for f in dataclasses.fields(st)},
            actor_h=zeros(), critic_h=zeros())
        return self.state

    # ------------------------------------------------------------ random draws
    def _normal(self, shape):
        """The rollout's noise [E, N, act] (over the global envs under a mesh)."""
        return draw(torch.randn, shape, self.generator, device=self.device)

    def _chunk_perm(self, C: int):
        return torch.randperm(C, generator=self.generator, device=self.device)

    def _agent_perm(self):
        return torch.randperm(self.N, generator=self.generator, device=self.device)

    # ---------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout_phase(self) -> Dict[str, torch.Tensor]:
        """episode_length steps of the GRU policies and the env step; advances
        the env state and the hidden states.  The trajectory keeps the
        reference's [T, E, N, ...] layout, plus mask [T, E], the
        rollout-start hiddens ah0/ch0 [N, E, H] and, when chunked, the
        pre-step hiddens ah/ch [T, N, E, H]."""
        cfg, st = self.cfg, self.state
        E, N, A = self.local_envs, self.N, self.act_dim
        env_state, ah, ch = st.env_state, st.actor_h, st.critic_h
        steps = []
        for _ in range(cfg.episode_length):
            mask = 1.0 - env_state.done.float()
            obs_buf = torch.clamp(env_state.obs, -cfg.clip_obs, cfg.clip_obs)
            obs, cin = self._agent_views(obs_buf)
            mean, std, ah_next = self.actor.apply(st.actor_params, obs, ah, mask)   # [N,E,act]
            actions = mean + std * self._normal((E, N, A)).transpose(0, 1)
            logp = nets.normal_log_prob(mean, std, actions)
            values, ch_next = self.critic.apply(st.critic_params, cin, ch, mask)
            a_clip = torch.clamp(actions, -cfg.clip_actions, cfg.clip_actions)
            nxt = self.env.step_batch(env_state, a_clip.transpose(0, 1).reshape(E, -1))
            step = dict(obs=obs.transpose(0, 1), share=obs_buf, actions=actions.transpose(0, 1),
                        logp=logp.t(), values=values.t(), mask=mask, reward=nxt.reward,
                        done=nxt.done.float())
            if self.chunked:
                step["ah"], step["ch"] = ah, ch
            steps.append(step)
            env_state, ah, ch = nxt, ah_next, ch_next
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        traj["ah0"], traj["ch0"] = st.actor_h, st.critic_h
        st.env_state, st.actor_h, st.critic_h = env_state, ah, ch
        return traj

    # ----------------------------------------------------------------- update
    def _gae(self, traj, last_values, vn):
        """Per-agent GAE on the denormalized values (no time-limit mask),
        advantages normalized per agent.  Returns (adv_norm, returns), each
        [N, T, E]."""
        cfg = self.cfg
        den = (lambda x: vn.denormalize(x)) if self.norm_mode != "none" else (lambda x: x)
        v = den(traj["values"].permute(2, 0, 1))
        last = den(last_values)
        r, d = traj["reward"], traj["done"]
        nv = torch.cat([v[:, 1:], last[:, None]], dim=1)
        adv, out = torch.zeros_like(last), []
        for t in reversed(range(r.shape[0])):
            delta = r[t] + cfg.gamma * nv[:, t] * (1 - d[t]) - v[:, t]
            adv = delta + cfg.gamma * cfg.gae_lambda * (1 - d[t]) * adv
            out.append(adv)
        adv = torch.stack(out[::-1], dim=1)
        flat = adv.reshape(adv.shape[0], -1)
        mean, std = self.mesh.mean_std(flat, dim=1)
        lead = lambda s: s.reshape(-1, 1, 1)
        return (adv - lead(mean)) / (lead(std) + 1e-5), adv + v

    def _seq_logp(self, ap, d):
        """Sequence log-probs [n, L, C] of d's actions from its chunk starts."""
        mean, std = self.actor.apply_seq(ap, d["obs"], d["ah0"], d["mask"])
        return nets.normal_log_prob(mean, std, d["actions"])

    def _loss_inputs(self, d):
        """The loss view of a minibatch d: the per-row keys flattened to
        [n, L * B, ...]; obs and cin stay sequences, read by the appliers
        together with d's mask and chunk-start hiddens."""
        mb = dict(d)
        for k in _ROW_KEYS:
            mb[k] = d[k].flatten(1, 2)
        a_apply = lambda p, obs: tuple(x.flatten(1, 2) for x in
                                       self.actor.apply_seq(p, obs, d["ah0"], d["mask"]))
        c_apply = lambda p, cin: self.critic.apply_seq(p, cin, d["ch0"], d["mask"]).flatten(1, 2)
        return a_apply, c_apply, mb

    def _epochs(self, data, agents: slice, vn):
        """ppo_epoch x num_mini_batch steps of the agents `agents` on their
        chunked data (leaves [n, L, C, ...], ah0/ch0 [n, C, H]).  Returns
        (vn', per-epoch lists of actor and value losses, each [n])."""
        cfg, st = self.cfg, self.state
        view = lambda tree: tree_map(lambda x: x[agents], tree)
        ap, cp = view(st.actor_params), view(st.critic_params)
        opt_view = lambda o: AdamState([m[agents] for m in o.mu], [v[agents] for v in o.nu], [])
        ao, co = opt_view(st.actor_opt), opt_view(st.critic_opt)
        n, C = data["obs"].shape[0], data["obs"].shape[2]
        nmb = max(1, cfg.num_mini_batch)
        Cg = C * self.mesh.size            # every rank's chunks
        mbs = Cg // nmb
        take = lambda d, ix: {k: _take(v, ix, _CHUNK_AXIS.get(k, 2)) for k, v in d.items()}
        al, vl = [], []
        for _ in range(cfg.ppo_epoch):
            # each minibatch: (agents of the step, their data) per step
            if nmb == 1:
                steps = [[(slice(0, n), data)]]
            else:
                ix = torch.stack([self._chunk_perm(Cg)[: nmb * mbs] for _ in range(n)])
                ix = ix.reshape(n, nmb, mbs)
                if not self._glob:
                    steps = [[(slice(0, n), take(data, ix[:, j]))] for j in range(nmb)]
                else:
                    one = lambda i, j: take({k: v[i:i + 1] for k, v in data.items()},
                                            self.mesh.local_index(ix[i, j], self.num_envs)[None])
                    steps = [[(slice(i, i + 1), one(i, j)) for i in range(n)]
                             for j in range(nmb)]
            al.append([])
            vl.append([])
            for step in steps:
                a_parts, v_parts = [], []
                for sl, d in step:
                    a_apply, c_apply, mb = self._loss_inputs(d)
                    whole = sl.stop - sl.start == n
                    sub = (lambda t: t) if whole else \
                        (lambda t, sl=sl: tree_map(lambda x: x[sl], t))
                    sub_opt = (lambda o: o) if whole else \
                        (lambda o, sl=sl: AdamState([m[sl] for m in o.mu], [v[sl] for v in o.nu], []))
                    vn_i, a_n, v_n = self._update_once(
                        a_apply, c_apply, sub(ap), sub_opt(ao), sub(cp), sub_opt(co),
                        vn if whole else vn.index(sl), mb,
                        slice(agents.start + sl.start, agents.start + sl.stop),
                        n=mbs * self.L)
                    if whole:
                        vn = vn_i
                    else:
                        vn.assign(sl, vn_i)
                    a_parts.append(a_n)
                    v_parts.append(v_n)
                al[-1].append(torch.cat(a_parts))
                vl[-1].append(torch.cat(v_parts))
        return vn, al, vl

    def update_phase(self, traj: Dict[str, torch.Tensor], last_obs: torch.Tensor, *,
                     perm=None) -> Dict[str, torch.Tensor]:
        """GAE and the chunked-BPTT updates on one trajectory; returns the
        iteration's metrics (device tensors).  The last values start from the
        state's hiddens and env done flags, as rollout_phase left them;
        `perm` fixes HAPPO's agent order."""
        cfg, st, N, L = self.cfg, self.state, self.N, self.L
        T, E = traj["reward"].shape
        C = (T // L) * E
        with torch.no_grad():
            _, last_cin = self._agent_views(torch.clamp(last_obs, -cfg.clip_obs, cfg.clip_obs))
            last_mask = 1.0 - st.env_state.done.float()
            last_values, _ = self.critic.apply(st.critic_params, last_cin, st.critic_h, last_mask)
            adv, returns = self._gae(traj, last_values, st.vnorm)
        # [T, E, N, ...] -> [N, T, E, ...]
        agent_major = lambda x: x.permute(2, 0, 1, *range(3, x.dim()))
        chunks = lambda x: to_chunks(agent_major(x), L)
        obs = chunks(traj["obs"])
        if cfg.use_centralized_v:
            share = to_chunks(traj["share"][None], L)
            cin = share.expand(N, *share.shape[1:])
        else:
            cin = obs
        starts = (lambda h: chunk_starts(h.transpose(0, 1), L)) if self.chunked else None
        data = dict(obs=obs, cin=cin, actions=chunks(traj["actions"]), logp=chunks(traj["logp"]),
                    values=chunks(traj["values"]), adv=to_chunks(adv, L),
                    returns=to_chunks(returns, L),
                    mask=to_chunks(traj["mask"][None], L).expand(N, L, C),
                    ah0=starts(traj["ah"]) if self.chunked else traj["ah0"],
                    ch0=starts(traj["ch"]) if self.chunked else traj["ch0"],
                    factor=torch.ones(N, L, C, device=self.device),
                    active=torch.ones(N, L, C, device=self.device))
        self.update_graph.eager_updates += 1     # its own loop, never graphed
        if self.is_happo:
            aloss, vloss = self._happo(data, perm)
        else:
            vn, al, vl = self._epochs(data, slice(0, N), st.vnorm)
            st.vnorm = vn
            aloss = _nested_mean([[x.mean() for x in e] for e in al])
            vloss = _nested_mean([[x.mean() for x in e] for e in vl])
        st.iteration += 1
        reward, done = self.mesh.mean([traj["reward"].mean(), traj["done"].mean()])
        return dict(mean_reward=reward, value_loss=vloss, policy_loss=aloss,
                    done_frac=done, **episode_returns(st, traj, self.mesh))

    def _happo(self, data, perm):
        """The agents one after another in `perm` (default: a random order),
        each weighted by the factor of those before it.  Returns the loss
        means."""
        st = self.state
        if perm is None:
            perm = self._agent_perm()
        factor = data["factor"][:1]
        alosses, vlosses = [], []
        for i in (int(i) for i in perm):
            sl = slice(i, i + 1)
            d = {k: v[sl] for k, v in data.items()}
            d["factor"] = factor
            ap = tree_map(lambda x: x[sl], st.actor_params)
            with torch.no_grad():
                old = self._seq_logp(ap, d)
            vn, al, vl = self._epochs(d, sl, st.vnorm.index(sl))
            st.vnorm.assign(sl, vn)
            with torch.no_grad():
                factor = factor * torch.exp(self._seq_logp(ap, d) - old)
            alosses.append(_nested_mean([[x.mean() for x in e] for e in al]))
            vlosses.append(_nested_mean([[x.mean() for x in e] for e in vl]))
        return torch.stack(alosses).mean(), torch.stack(vlosses).mean()

    # ---------------------------------------------------------------- driving
    def eval(self, n_episodes: int | None = None, deterministic: bool = True):
        """Deterministic episodes in E = min(n_episodes or eval_episodes,
        num_envs) dedicated envs (reset from seed + 10_000 and the
        iteration), the GRU actor from zero hiddens, reset where an env is
        done, acting with its mean clipped to [-1, 1]; the mean first-episode
        return."""
        if self.state is None:
            self.init_state()
        cfg, ap = self.cfg, self.state.actor_params
        E = max(1, min(n_episodes or cfg.eval_episodes, self.num_envs))
        h = torch.zeros(self.N, E, self.H, device=self.device)

        def policy(obs_buf, done):
            nonlocal h
            obs, _ = self._agent_views(torch.clamp(obs_buf, -cfg.clip_obs, cfg.clip_obs))
            mean, _, h = self.actor.apply(ap, obs, h, 1.0 - done.float())
            return torch.clamp(mean, -1.0, 1.0).transpose(0, 1).reshape(E, -1)

        return evaluate_episodes(self.env, E, policy,
                                 eval_generator(self.seed, self.device, self.state.iteration),
                                 with_done=True)
