"""Multi-task TRPO (twin of massive_marl_tpu/algos/mtrl/mttrpo.py).

MTPPO's per-task collection, and a TRPO update on the joined batch over
the flattened whole ActorCritic (actor, critic and log_std), through
trpo.natural_gradient_step:
  * the advantages normalised by their population std plus 1e-8;
  * g, the gradient of the surrogate mean(exp(logp - old_logp) * adv);
  * cg_nsteps conjugate-gradient iterations on F s = g with the 1e-10
    guards, F v the Hessian of the mean KL from the pre-step (mean,
    log_std) times v plus damping * v, by double backward (the JAX package
    takes forward-over-reverse; the critic's coordinates get damping * v);
  * the step sqrt(2 max_kl / max(s F s, 1e-10)) s and a backtracking search
    over backtrack_coeff**i, i < max_num_backtrack, that takes the first
    candidate whose surrogate improves and whose KL is at most 1.5 max_kl,
    else keeps the old parameters;
  * then vf_epochs full-batch steps of the (unclipped) value loss over all
    parameters with MTPPO's Adam state: p -= lr * Adam(clip(g)).
MTTRPOConfig.from_cfg_train is MTPPO's: cfg/mttrpo's cg_iters, cg_damping,
max_kl and backtrack_* are not read, and the defaults hold.  Under a mesh
the gradient, Fisher products, line-search values and value steps are
means over the ranks, as in MTPPO and TRPO.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from massive_marl_tpu_torch.algos import nets
from massive_marl_tpu_torch.algos.mtrl.mtppo import MTPPO, MTPPOConfig
from massive_marl_tpu_torch.algos.rl.ppo import adam_update
from massive_marl_tpu_torch.algos.rl.trpo import natural_gradient_step


@dataclass
class MTTRPOConfig(MTPPOConfig):
    max_kl: float = 0.016
    cg_nsteps: int = 10
    damping: float = 0.1
    max_num_backtrack: int = 10
    backtrack_coeff: float = 0.8
    vf_epochs: int = 5


class MTTRPO(MTPPO):
    """MTPPO's collection with the TRPO update."""

    def __init__(self, envs: Dict[str, Any], num_envs: int, cfg: MTTRPOConfig | None = None,
                 **kw):
        super().__init__(envs, num_envs, cfg or MTTRPOConfig(), **kw)
        # per update: Fisher-vector products and line-search candidates
        self.last_search: Dict[str, int] = {}

    def _policy_step(self, obs, actions, old_logp, adv):
        """The natural-gradient step over every parameter, in place."""
        with torch.no_grad():
            mean0, _, log_std0 = self.model(obs)
        log_std0 = log_std0.detach().clone()    # forward returns the parameter itself

        def surrogate():
            mean, _, log_std = self.model(obs)
            return torch.mean(torch.exp(nets.gaussian_log_prob(mean, log_std, actions) - old_logp)
                              * adv)

        def mean_kl():
            mean, _, log_std = self.model(obs)
            return nets.gaussian_kl(mean0, log_std0.expand_as(mean), mean,
                                    log_std.expand_as(mean)).mean()

        _, accepted, search = natural_gradient_step(
            list(self.model.parameters()), surrogate, mean_kl, self.cfg, self.mesh.mean)
        self.last_search = dict(search, accepted=int(accepted))

    def update(self, batch):
        """The policy step, then vf_epochs value steps; returns the mean of
        the epochs' value losses."""
        batch = self._normalized(batch)
        self._policy_step(batch["obs"], batch["actions"], batch["logp"], batch["adv"])
        params = list(self.model.parameters())
        losses = []
        for _ in range(self.cfg.vf_epochs):
            def value_loss():
                loss = torch.mean((self.model(batch["obs"])[1] - batch["returns"]) ** 2)
                return loss, loss.detach()
            grads, loss = self._mean_grads(value_loss)
            adam_update(params, grads, self.state.opt, self.state.lr, self.cfg.max_grad_norm)
            losses.append(loss)
        return torch.stack(losses).mean()

