"""ppo_collect: train PPO online, then dump an offline dataset (twin of
massive_marl_tpu/algos/offrl/collect.py).

The port's PPO (rl/ppo.py) trains on the env; its policy then rolls on in
chunks of 8 steps x E envs (obs clipped to +-clip_obs, sampled actions
clipped to +-clip_actions, from the trainer's own env state and generator)
until collect_steps transitions are held, and the first collect_steps are
written with algos/offrl/datasets.save_dataset under
<dataset_dir>/<task>_<datatype>/.
"""
from __future__ import annotations

import torch

from massive_marl_tpu_torch.algos import nets
from massive_marl_tpu_torch.algos.offrl import datasets
from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig

CHUNK = 8   # env steps per collection chunk


class PPOCollect:
    def __init__(self, env, num_envs: int, cfg_train: dict, seed: int = 0,
                 log_dir: str | None = None, dataset_dir: str = "./datasets",
                 task: str = "OneAnt", datatype: str = "expert",
                 collect_steps: int | None = None, device=None):
        self.ppo = PPO(env, num_envs, PPOConfig.from_cfg_train(cfg_train), seed=seed,
                       log_dir=log_dir, device=device, print_log=True)
        self.env = env
        self.num_envs = num_envs
        self.out_dir = datasets.dataset_dir(dataset_dir, task, datatype)
        self.collect_steps = collect_steps or cfg_train.get("learn", {}).get(
            "collect_steps", 100_000)

    @torch.no_grad()
    def collect_chunk(self):
        """CHUNK steps of the trained policy from the trainer's env state;
        returns the five [CHUNK x E, dim] arrays on the host."""
        ppo, cfg = self.ppo, self.ppo.cfg
        st = ppo.state.env_state
        rows = {k: [] for k in datasets.FILES}
        for _ in range(CHUNK):
            obs = torch.clamp(st.obs, -cfg.clip_obs, cfg.clip_obs)
            mean, _, log_std = ppo.model(obs)
            a = torch.clamp(nets.gaussian_sample(mean, log_std, generator=ppo.generator),
                            -cfg.clip_actions, cfg.clip_actions)
            st = self.env.step_batch(st, a)
            for k, v in zip(datasets.FILES, (obs, a, st.reward[:, None],
                                             st.done.to(torch.float32)[:, None],
                                             torch.clamp(st.obs, -cfg.clip_obs, cfg.clip_obs))):
                rows[k].append(v)
        ppo.state.env_state = st
        return {k: torch.cat(v).cpu() for k, v in rows.items()}

    def run(self, num_learning_iterations: int | None = None) -> str:
        self.ppo.run(num_learning_iterations)
        bufs = {k: [] for k in datasets.FILES}
        steps = 0
        while steps < self.collect_steps:
            for k, v in self.collect_chunk().items():
                bufs[k].append(v)
            steps += CHUNK * self.num_envs
        arrays = {k: torch.cat(v)[: self.collect_steps] for k, v in bufs.items()}
        datasets.save_dataset(self.out_dir, **arrays)
        print(f"[ppo_collect] wrote {len(arrays['states'])} transitions to {self.out_dir}",
              flush=True)
        return self.out_dir
