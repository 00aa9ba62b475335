"""The sequential fused MAPPO/IPPO update of one MarlRunner as one CUDA graph
(torch.cuda.graphs): every agent's ppo_epoch actor steps, value-target
updates and critic steps, captured once and replayed once an update, in
place of the ~18,000 launches the host makes for them one by one.  The
hand-written kernels (B2/B3, B4/B5 under FUSED_TOWER=1) are launched from
inside the graph as they are outside it.  GAE, the last values, the
agent-major batch and everything else of `update_phase` stay eager.

An update takes the graph only where the runner can show that a replay
does what the eager body would (`refusal`): a CUDA device; the sequential
schedule on the fused path; MAPPO or IPPO (HAPPO draws a permutation on
the device, HATRPO's line search reads the device on the host); no mesh (no
collectives inside a graph); one minibatch an epoch, so the body draws no
random numbers; the runner's own agent order.  Every other update runs the
eager body: the CPU, the stacked schedule, a mesh, HAPPO and HATRPO, more
minibatches, and RecurrentMarlRunner, whose update is its own.

  * The runner's first update runs eagerly, refused or not: the warm-up
    capture needs (kernel builds, cuBLAS handles, autograd, the caching
    allocator).  Its results are the real update.  This lifecycle is
    algos/graphed.py's, shared with PPO's graphs.
  * The next one captures the body (`MarlRunner._sequential`) on a side
    stream into the graph's private memory pool; capture runs nothing, so
    the graph's first replay is that update.  Each later update copies its
    inputs (the agent-major batch and the shared observations) into the
    buffers the graph reads, replays, and returns clones of the loss means.
  * The state changes in place, where the eager body changes it: the
    parameters, Adam's moments and the value normaliser's statistics, all
    views into the agent-stacked tensors whose addresses the graph holds.
    Before each replay those addresses, the inputs' shapes and FUSED_TOWER
    are compared with the capture's; any change (`restore`, a new
    `init_state`) drops the graph, and that update captures anew.
  * Adam's step count stays on the host (AdamState.count, which checkpoints
    and `restore` read).  Before each replay the host writes the bias
    corrections and learning rate of agent i's k-th step,
    ClipAdam.scalars(count[i] + k, device), into a [2, N, K, 3] float32
    buffer (optimizer, agent, step); the captured steps read them from
    there, and ClipAdam.step gives the same bits for those tensors as for
    the Python floats the eager step takes.  After the replay the host
    advances each agent's count by the steps the graph took.

Counters: `captures`, `replays` and `eager_updates` (an update is one of the
three; the update that captures is not counted as a replay), and `calls`,
the B2-B5 wrappers' calls (KERNELS) that one replay makes, as the capture
counted them.  The wrappers' own `launches` (ops/fused_mlp.py) count their
host calls: an eager update's and a capture's, none of a replay's, which
launches its kernels from the graph.  A replay runs in the span
`update.graph`; the spans inside the body (`update.agent`,
`update.forward`, `update.backward`, `update.optimizer`) fire only where it
runs on the host: eagerly, or while it is captured.
"""
from __future__ import annotations

import os

import torch

from massive_marl_tpu_torch.algos.graphed import GraphedBody
from massive_marl_tpu_torch.ops import fused_mlp
from massive_marl_tpu_torch.parallel.mesh import LOCAL
from massive_marl_tpu_torch.utils.tree import tree_leaves

# the kernel wrappers whose calls `UpdateGraph.calls` counts
KERNELS = (fused_mlp.fwd_kernel, fused_mlp.bwd_kernel, fused_mlp.tower_fwd_kernel,
           fused_mlp.tower_bwd_kernel)


def state_tensors(runner) -> list:
    """Every tensor of the runner's state that the update changes in place:
    the parameters, Adam's moments and the value normaliser's statistics."""
    st = runner.state
    return (tree_leaves(st.actor_params) + tree_leaves(st.critic_params)
            + st.actor_opt.mu + st.actor_opt.nu + st.critic_opt.mu + st.critic_opt.nu
            + [st.vnorm.mean, st.vnorm.mean_sq, st.vnorm.debias])


class UpdateGraph(GraphedBody):
    """One runner's graph of its sequential fused update (see the module
    doc); `update_graph(runner, data, share)` stands for
    `runner._sequential`."""
    EAGER = "eager_updates"
    SPAN = "update.graph"

    def _drop(self):
        super()._drop()
        self.inputs = self.share = self.scalars = None
        self.steps = None    # [optimizer][agent]: the steps one replay takes
        self.calls = None    # per KERNELS entry: the calls one replay makes
        self.base = None     # while capturing, [optimizer][agent]: the counts before

    @staticmethod
    def refusal(runner, perm=None) -> str | None:
        """Why the runner's update runs eagerly, or None where the graph
        takes it."""
        if runner.device.type != "cuda":
            return "not a CUDA device"
        if not (runner.sequential and runner.use_fused):
            return "not the sequential schedule on the fused path"
        if runner.is_happo:
            return "HAPPO or HATRPO"
        if runner.mesh is not LOCAL:
            return "a mesh"
        if runner.cfg.num_mini_batch > 1:
            return "more than one minibatch an epoch"
        if perm is not None:
            return "an agent order given"
        return None

    @staticmethod
    def _eager(runner, data, share):
        return runner._sequential(data, share, None)

    @staticmethod
    def _key(runner, data, share) -> tuple:
        """What a replay relies on: the addresses of the state it updates in
        place, the inputs' shapes and the tower switch."""
        return (tuple(t.data_ptr() for t in state_tensors(runner)),
                tuple((k, tuple(v.shape)) for k, v in data.items()), tuple(share.shape),
                os.environ.get("FUSED_TOWER", "0") == "1")

    def step_scalars(self, which: int, agent: int, count: int):
        """While capturing: the buffer's (bc1, bc2, lr) of the actor's
        (which 0) or the critic's (1) optimizer step of `agent` after
        `count` steps."""
        return tuple(self.scalars[which, agent, count - self.base[which][agent]].unbind())

    def _capture(self, runner, data, share):
        st, N = runner.state, runner.N
        opts = (st.actor_opt, st.critic_opt)
        self.inputs = {k: v.clone() for k, v in data.items()}
        self.share = share.clone()
        self.scalars = torch.zeros((2, N, runner.cfg.ppo_epoch, 3), device=runner.device)
        self.base = [list(o.count) for o in opts]
        launches = [kernel.launches for kernel in KERNELS]
        try:
            self._record(lambda: runner._sequential(self.inputs, self.share, None))
            self.steps = [[c - b for c, b in zip(o.count, before)]
                          for o, before in zip(opts, self.base)]
            self.calls = [kernel.launches - n for kernel, n in zip(KERNELS, launches)]
        finally:
            # the capture took no step; the replay that follows takes them
            for o, before in zip(opts, self.base):
                o.count[:] = before
            self.base = None

    @staticmethod
    def schedule(runner, K: int) -> torch.Tensor:
        """The host's [2, N, K, 3] float32 table of ClipAdam.scalars(count +
        k, device) for the actor's and the critic's optimizer, each agent's
        count and k < K: what the buffer `scalars` holds for a replay."""
        st, dev = runner.state, runner.device
        return torch.tensor([[[tx.scalars(c + k, dev) for k in range(K)] for c in o.count]
                             for tx, o in ((runner.actor_tx, st.actor_opt),
                                           (runner.critic_tx, st.critic_opt))],
                            dtype=torch.float32)

    def _feed(self, runner, data, share):
        table = self.schedule(runner, self.scalars.shape[2])
        for name, v in data.items():
            self.inputs[name].copy_(v)
        self.share.copy_(share)
        self.scalars.copy_(table.pin_memory(), non_blocking=True)

    def _advance(self, runner):
        st = runner.state
        for o, steps in zip((st.actor_opt, st.critic_opt), self.steps):
            o.count[:] = [c + s for c, s in zip(o.count, steps)]
