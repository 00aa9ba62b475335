"""PPO's update as one CUDA graph (torch.cuda.graphs): the last-value
forward, GAE, the advantages' normalisation, the noptepochs x nminibatches
minibatch steps (forward, autograd.grad, the adaptive lr and Adam) and the
metric means, captured once and replayed once an update, in place of the
thousands of small launches that Python and the autograd engine make for
them one by one.  Kernels, operands, precisions and the order of operations
are the eager body's; only the launch path changes.

An update takes the graph only where the trainer can show that a replay
does what the eager body would (`refusal`): a CUDA device; no mesh (no
collectives inside a graph); `_loss` and `_step` not overridden on the
instance (a wrapper may read the device on the host, as the benchmark's
checked first step does).  The body reads nothing from the device on the
host and draws no random numbers: the lr is a 0-d device tensor changed by
torch.where, the clip's global norm stays on the device, and the minibatches
are the same contiguous slices every epoch.  Every other update runs the
eager body: the CPU, a mesh, an overridden step.

  * The graph captures only after the trainer has run one update eagerly,
    refused or not: the warm-up capture needs (cuBLAS handles, autograd,
    the caching allocator).  Its results are the real update.  This
    lifecycle is algos/graphed.py's, shared with the rollout's graph.
  * The next update captures the body (`PPO._update`) on a side stream into
    the graph's private memory pool; capture runs nothing, so the graph's
    first replay is that update.  Each later update copies its inputs (the
    trajectory's seven tensors and the last observations) into the buffers
    the graph reads, replays, and returns clones of the metrics.
  * The state changes in place, where the eager body changes it: the
    parameters, Adam's moments and the lr (`state.lr`, which the body
    overwrites with `copy_`).  Before each replay those addresses and the
    inputs' shapes are compared with the capture's; any change (`load`, a
    new `init_state`) drops the graph, and that update captures anew.
  * Adam's step count stays on the host (AdamState.count, which checkpoints
    read).  Before each replay the host writes the reciprocals of the bias
    corrections of the update's k-th step, ppo.adam_scalars(count + k),
    into a [K, 2] float32 buffer; the captured steps multiply by them, and
    ppo.adam_update gives the same bits for those tensors as for the Python
    floats the eager step divides by.  After the replay the host advances
    the count by the steps the graph took.

Counters: `captures`, `replays` and `eager_updates` (an update is one of the
three; the update that captures is not counted as a replay).  A replay runs
in the span `update.graph`; the spans inside the body (`update.forward`,
`update.backward`, `update.optimizer`) fire only where it runs on the host:
eagerly, or while it is captured.
"""
from __future__ import annotations

import torch

from massive_marl_tpu_torch.algos.graphed import GraphedBody
from massive_marl_tpu_torch.parallel.mesh import LOCAL


def state_tensors(trainer) -> list:
    """Every tensor of the trainer's state that the update changes in place:
    the parameters, Adam's moments and the lr."""
    st = trainer.state
    return list(trainer.model.parameters()) + st.opt.mu + st.opt.nu + [st.lr]


class PPOUpdateGraph(GraphedBody):
    """One trainer's graph of its update (see the module doc);
    `update_graph(trainer, traj, last_obs)` stands for `trainer._update`."""
    EAGER = "eager_updates"
    SPAN = "update.graph"

    def _drop(self):
        super()._drop()
        self.inputs = self.last_obs = self.scalars = None
        self.steps = None    # the Adam steps one replay takes
        self.base = None     # while capturing: Adam's count before

    @staticmethod
    def refusal(trainer) -> str | None:
        """Why the trainer's update runs eagerly, or None where the graph
        takes it."""
        if trainer.device.type != "cuda":
            return "not a CUDA device"
        if trainer.mesh is not LOCAL:
            return "a mesh"
        for name in ("_loss", "_step"):
            if name in vars(trainer):
                return f"{name} overridden on the trainer"
        return None

    @staticmethod
    def _eager(trainer, traj, last_obs):
        return trainer._update(traj, last_obs)

    @staticmethod
    def _key(trainer, traj, last_obs) -> tuple:
        """What a replay relies on: the addresses of the state it updates in
        place and the inputs' shapes."""
        return (tuple(t.data_ptr() for t in state_tensors(trainer)),
                tuple((k, tuple(v.shape)) for k, v in traj.items()), tuple(last_obs.shape))

    def step_scalars(self, count: int):
        """Adam's (1 / bc1, 1 / bc2) for the step after `count` steps: while
        capturing, the buffer's device scalars; otherwise None (the step
        computes the bias corrections as Python floats)."""
        if self.base is None:
            return None
        return tuple(self.scalars[count - self.base].unbind())

    def _capture(self, trainer, traj, last_obs):
        opt, cfg = trainer.state.opt, trainer.cfg
        self.inputs = {k: v.clone() for k, v in traj.items()}
        self.last_obs = last_obs.clone()
        self.scalars = torch.zeros((cfg.noptepochs * cfg.nminibatches, 2), device=trainer.device)
        self.base = opt.count
        try:
            self._record(lambda: trainer._update(self.inputs, self.last_obs))
            self.steps = opt.count - self.base
        finally:
            # the capture took no step; the replay that follows takes them
            opt.count = self.base
            self.base = None

    @staticmethod
    def schedule(count: int, K: int) -> torch.Tensor:
        """The host's [K, 2] float32 table of adam_scalars(count + k), k <
        K: what the buffer `scalars` holds for a replay."""
        from massive_marl_tpu_torch.algos.rl.ppo import adam_scalars  # ppo imports this module
        return torch.tensor([adam_scalars(count + k) for k in range(K)], dtype=torch.float32)

    def _feed(self, trainer, traj, last_obs):
        table = self.schedule(trainer.state.opt.count, self.scalars.shape[0])
        for name, v in traj.items():
            self.inputs[name].copy_(v)
        self.last_obs.copy_(last_obs)
        self.scalars.copy_(table.pin_memory(), non_blocking=True)

    def _advance(self, trainer):
        trainer.state.opt.count += self.steps
