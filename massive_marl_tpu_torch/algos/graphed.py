"""The lifecycle the port's CUDA graphs share (rl/update_graph.py,
rl/rollout_graph.py, marl/update_graph.py): one holder's graph of one body,
run eagerly until the holder has run the body eagerly once, refused or not
(the warm-up capture needs: kernel builds, cuBLAS handles, autograd, the
caching allocator), captured on the next call and replayed on every later
one.

A subclass supplies the body's parts:
  * `_eager(owner, *args)`: the body run eagerly, on the warm-up call;
  * `_key(owner, *args)`: what a replay relies on (addresses, shapes),
    compared before every replay; a change drops the graph, and that call
    captures anew;
  * `_capture(owner, *args)`: makes the buffers the graph reads and records
    the body with `_record`, which keeps its outputs in `outputs`;
  * `_feed(owner, *args)`, `_advance(owner)`: what the host does before and
    after a replay (copy inputs in, fill scalar tables, advance counts);
    nothing by default.
A call returns the body's outputs: eagerly as the body gives them, after a
replay as clones of the graph's buffers (a dict or a tuple), so they
outlive the next replay.

Counters: `captures`, `replays` and the subclass's counter of eager calls,
named by `EAGER` (a call is one of the three; the call that captures is not
counted as a replay).  The holder's owner counts its refused calls in the
same counter.  A replay runs in the span `SPAN`; the spans inside the body
fire only where it runs on the host: eagerly, or while it is captured.
"""
from __future__ import annotations

import torch

from massive_marl_tpu_torch.utils.profiling import span


class GraphedBody:
    """One holder's graph of one body (see the module doc)."""
    EAGER = "eager_calls"    # the name of the counter of eager calls
    SPAN = "graph"           # the span a replay runs in

    def __init__(self):
        self.captures = self.replays = 0
        setattr(self, self.EAGER, 0)
        self._drop()

    def _drop(self):
        self.graph = self.key = self.outputs = None

    def __call__(self, owner, *args):
        if not getattr(self, self.EAGER):
            setattr(self, self.EAGER, 1)
            return self._eager(owner, *args)
        key = self._key(owner, *args)
        if self.graph is not None and key != self.key:
            self._drop()
        if self.graph is None:
            self._capture(owner, *args)
            self.key = key
            self.captures += 1
        else:
            self.replays += 1
        self._feed(owner, *args)
        with span(self.SPAN):
            self.graph.replay()
        self._advance(owner)
        if isinstance(self.outputs, dict):
            return {k: v.clone() for k, v in self.outputs.items()}
        return tuple(t.clone() for t in self.outputs)

    def _record(self, body, generators=()):
        """Captures body() on a side stream into the graph's private memory
        pool (capture runs nothing); `generators` are registered with the
        graph, so each replay draws from their current states and advances
        them as the eager body does."""
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph):
            self.outputs = body()
        self.graph = graph

    def _feed(self, owner, *args):
        pass

    def _advance(self, owner):
        pass
