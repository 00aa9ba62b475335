"""PPO's rollout as one CUDA graph (torch.cuda.graphs): the nsteps steps of
policy forward, noise draw, log-prob and clip, then the env's `step_batch`,
and the stacking of the trajectory, captured once and replayed once an
iteration, in place of the thousands of small launches that Python makes
for them one by one.  Kernels, operands, precisions and the order of
operations are the eager body's (`PPO._rollout`); only the launch path
changes.  The env's hand-written kernels (B1, the box kernel) are launched
from inside the graph as they are outside it: their launchers take the
current stream.

A rollout takes the graph only where the trainer can show that a replay
does what the eager body would (`refusal`), checked on every call: a CUDA
device; no mesh (a rank's draws are cut from every rank's, a `RowsGenerator`
draw); an env without domain randomization; `step_batch` not overridden on
the env instance (a wrapper may sync or read the device on the host, as the
benchmark's traced runs do); and an env that declares, by its
`device_only_step` attribute, that its step makes no read from the device
on the host (TenAnt and OneAnt on the fused substep path; the array engine
and MultiIngenuity do not).  Every other rollout runs the eager body.

  * The first rollout on a trainer runs eagerly, refused or not: the
    warm-up capture needs (kernel builds, constant tables, cuBLAS handles,
    the caching allocator).  Its results are the real rollout.  This
    lifecycle is algos/graphed.py's, shared with the update's graph.
  * The next one captures the body on a side stream into the graph's
    private memory pool; capture runs nothing, so the graph's first replay
    is that rollout.  Every later one replays.
  * Random streams: the env's generator (its resets) and the trainer's (the
    action noise) are registered with the graph, so each replay draws what
    the eager body would from the streams' current states and advances both
    as the eager body does.
  * The env state stays at fixed addresses (`static`): the body reads the
    EnvState tree from buffers laid out as the state it was captured from
    (each leaf's shape and strides) and copies its final state back into
    them inside the graph, so after a replay `state.env_state` is that tree.
    Where `state.env_state` is another tree (after `load`, a new
    `init_state`, an eager rollout, or a caller that stepped the env), its
    leaves are copied in before the replay.
  * Before each replay the addresses of the trainer's state
    (update_graph.state_tensors: the parameters the policy reads, and
    Adam's moments and the lr, which `load` and `init_state` rebind), the
    two generators and the env state's leaf layouts are compared with the
    capture's; any change drops the graph, and that rollout captures anew.
  * The graph owns the trajectory's buffers; a replay returns clones of
    them, so a returned trajectory outlives the next rollout.

Counters: `captures`, `replays` and `eager_rollouts` (a rollout is one of
the three; the rollout that captures is not counted as a replay).  A replay
runs in the span `rollout.graph`; the spans inside the body
(`trainer.policy`, `env.*`) fire only where it runs on the host: eagerly,
or while it is captured.  The kernel wrappers' `launches` count host calls
likewise: none in a replay.
"""
from __future__ import annotations

import dataclasses

import torch

from massive_marl_tpu_torch.algos.graphed import GraphedBody
from massive_marl_tpu_torch.algos.rl.update_graph import state_tensors
from massive_marl_tpu_torch.parallel.mesh import LOCAL


def state_leaves(tree) -> list:
    """The tensors of an EnvState tree (dataclasses and tuples), depth-first
    in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in state_leaves(getattr(tree, f.name))]
    if isinstance(tree, tuple):
        return [x for v in tree for x in state_leaves(v)]
    raise TypeError(f"an env state leaf of type {type(tree).__name__}")


def static_copy(tree):
    """A copy of an EnvState tree whose every leaf is a buffer of its own
    with the leaf's shape, strides and dtype (a view's layout kept, so the
    body's kernels read what the eager step would)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                                   device=tree.device).copy_(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: static_copy(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return type(tree)(static_copy(v) for v in tree)
    raise TypeError(f"an env state leaf of type {type(tree).__name__}")


class PPORolloutGraph(GraphedBody):
    """One trainer's graph of its rollout (see the module doc);
    `rollout_graph(trainer)` stands for `trainer._rollout` on its env
    state."""
    EAGER = "eager_rollouts"
    SPAN = "rollout.graph"

    def _drop(self):
        super()._drop()
        self.static = None

    @staticmethod
    def refusal(trainer) -> str | None:
        """Why the trainer's rollout runs eagerly, or None where the graph
        takes it."""
        env = trainer.env
        if trainer.device.type != "cuda":
            return "not a CUDA device"
        if trainer.mesh is not LOCAL:
            return "a mesh"
        if getattr(env, "randomize", False):
            return "domain randomization"
        if "step_batch" in vars(env):
            return "step_batch overridden on the env"
        if not getattr(env, "device_only_step", False):
            return "the env's step may read the device on the host"
        return None

    @staticmethod
    def _eager(trainer) -> dict:
        st = trainer.state
        traj, st.env_state = trainer._rollout(st.env_state)
        return traj

    @staticmethod
    def _key(trainer) -> tuple:
        """What a replay relies on: the addresses of the trainer's state,
        the generators (compared by identity) and the env state's leaf
        layouts."""
        return (tuple(t.data_ptr() for t in state_tensors(trainer)),
                trainer.env.generator, trainer.generator,
                tuple((tuple(x.shape), x.stride(), x.dtype)
                      for x in state_leaves(trainer.state.env_state)))

    def _body(self, trainer) -> dict:
        """What the graph holds: the rollout from the static env state, whose
        buffers then take the final state."""
        traj, final = trainer._rollout(self.static)
        for buf, x in zip(state_leaves(self.static), state_leaves(final)):
            buf.copy_(x)
        return traj

    def _capture(self, trainer):
        self.static = static_copy(trainer.state.env_state)
        trainer.state.env_state = self.static
        self._record(lambda: self._body(trainer), (trainer.env.generator, trainer.generator))

    def _feed(self, trainer):
        st = trainer.state
        if st.env_state is not self.static:
            for buf, x in zip(state_leaves(self.static), state_leaves(st.env_state)):
                buf.copy_(x)
            st.env_state = self.static
