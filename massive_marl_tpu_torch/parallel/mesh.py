"""The mesh and data parallelism over ranks (twin of
massive_marl_tpu/parallel/mesh.py).

The JAX package runs one program over a ('data', 'model') mesh of devices:
the env batch shards over 'data', parameters and optimizer state
replicate, and XLA inserts the collectives.  Here a job is one process per
card (a rank), and each rank holds its own rows of the data axis:
  * every rank builds the same parameters and optimizer state from the
    seed and keeps them equal: what it adds to them (gradients, value-norm
    statistics, Fisher products, line-search values) is all-reduced first,
    in one flat f32 buffer per call (`Mesh.sum`, `Mesh.mean`), so every
    rank applies the same bits;
  * every rank steps only its own E / R envs, and a replay ring keeps its
    own E / R env columns (axis 1 of [R, E, ...]);
  * a draw the JAX package makes over the global env axis (resets, action
    noise, domain-randomization samples) is made on every rank over the
    global shape from the one seeded generator, and each rank keeps its
    rows (`RowsGenerator`, `draw`), so an R-rank run sees the numbers of the
    1-rank run.  A draw over any other shape (a permutation, ring slots) is
    made alike on every rank.

JAX function -> here:
  init_distributed            -> init_distributed (a torch.distributed group)
  make_mesh                   -> make_mesh: a Mesh (axis names, shape, data
                                 rank, the process group of the data axis)
  replicated, replicate_tree  -> nothing to place: ranks build equal replicas,
                                 Mesh.sum / Mesh.mean keep them equal
  data_sharded, shard_leading_axis, train_state_shardings, apply_sharding
                              -> Mesh.rows(n): the rank's rows of an env axis
  shard_axis_tree(axis=1)     -> Mesh.rows on a ring's env axis
  host_to_global, global_state_shardings, place_global, shard_env_step
                              -> Mesh.shard_env: the env builds and steps only
                                 the rank's envs, drawing over the global env
                                 axis, so its state is the rank's rows of the
                                 one-process state; a trainer's ring holds
                                 Mesh.local(E) env columns

`LOCAL` is the mesh of a process alone: its collectives are the identity
and its statistics those of the single-process trainers, bit for bit.  A
mesh of one rank that has a process group (an NCCL group of world size 1)
runs every collective.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None) -> bool:
    """Join a job of several processes (a no-op returning False for fewer
    than 2).  The arguments fall back to MMT_COORDINATOR (host:port),
    MMT_NUM_PROCESSES and MMT_PROCESS_ID, as in the JAX package, and the
    backend to MMT_BACKEND, else NCCL on CUDA and gloo on the CPU.  On CUDA
    the rank's card is cuda:<process_id % device_count>."""
    from massive_marl_tpu_torch import resolve_device
    coordinator = coordinator or os.environ.get("MMT_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("MMT_NUM_PROCESSES", 0)) or None
    if process_id is None and os.environ.get("MMT_PROCESS_ID") is not None:
        process_id = int(os.environ["MMT_PROCESS_ID"])
    if not num_processes or num_processes < 2:
        return False
    if coordinator is None or process_id is None:
        raise ValueError("a job of several processes needs MMT_COORDINATOR (host:port) "
                         "and MMT_PROCESS_ID")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    backend = backend or os.environ.get("MMT_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


class RowsGenerator(torch.Generator):
    """A torch.Generator that knows a rank's rows of the env axis, `rows` =
    (start, stop, global count): `draw` makes a draw over the global shape
    and keeps the rows."""
    rows = None


def draw(fn, shape, generator: torch.Generator, axis: int = 0, **kw) -> torch.Tensor:
    """fn(shape, generator=generator, **kw) (torch.rand, torch.randn), where
    `axis` of `shape` is the env axis: from a RowsGenerator the draw is made
    over the global count on that axis and cut to the rank's rows, which
    are then the numbers a single process draws for those envs."""
    shape = tuple(shape)
    rows = getattr(generator, "rows", None)
    if rows is None:
        return fn(shape, generator=generator, **kw)
    start, stop, total = rows
    if shape[axis] != stop - start:
        raise ValueError(f"a draw of shape {shape} on a rank holding {stop - start} of "
                         f"{total} envs on axis {axis}")
    full = shape[:axis] + (total,) + shape[axis + 1:]
    out = fn(full, generator=generator, **kw).narrow(axis, start, stop - start)
    return out if axis == 0 else out.contiguous()


def draw_rows(fn, shape, generator: torch.Generator, per_row: bool = False,
              **kw) -> torch.Tensor:
    """`draw` for a leading axis of k blocks of the rank's rows, block-major
    (one env step's rows, or the k time slots of a ring batch), or with
    `per_row` k consecutive entries per row (a repeat_interleave of the
    rows): from a RowsGenerator, the rank's part of the draw over every
    rank's rows."""
    rows = getattr(generator, "rows", None)
    if rows is None:
        return fn(tuple(shape), generator=generator, **kw)
    n = rows[1] - rows[0]
    k = shape[0] // n
    block = ((n, k) if per_row else (k, n)) + tuple(shape[1:])
    return draw(fn, block, generator, axis=0 if per_row else 1, **kw).reshape(tuple(shape))


class Mesh:
    """A ('data', 'model') mesh of ranks.  `shape` maps the axis names to
    their sizes, `ranks` is the [data, model] array of global ranks (JAX's
    Mesh.devices), `data_rank` this rank's index on the data axis; ranks
    with the same data index hold the same rows (replication over
    'model').  `collectives` and `bytes_reduced` count the all-reduces this
    mesh issued and the bytes they carried."""
    axis_names = AXES

    def __init__(self, data: int, model: int = 1, rank: int = 0, group=None,
                 backend: str | None = None):
        self.shape = {"data": data, "model": model}
        self.ranks = np.arange(data * model).reshape(data, model)
        self.rank = rank
        self.data_rank = rank // model
        self.group = group
        self.backend = backend
        self.collectives = 0
        self.bytes_reduced = 0

    @property
    def size(self) -> int:
        """The number of data ranks."""
        return self.shape["data"]

    # ------------------------------------------------------------ placement
    def rows(self, n: int) -> slice:
        """The rank's rows of an axis of n global rows (E / R of them)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} data ranks")
        k = n // self.size
        return slice(self.data_rank * k, (self.data_rank + 1) * k)

    def local(self, n: int) -> int:
        """The rank's count of n global rows."""
        sl = self.rows(n)
        return sl.stop - sl.start

    def span(self, a: int, b: int, n: int) -> tuple:
        """The rank's part [lo, hi) of the rows [a, b) of a T-major flat
        [T * n] batch (n envs per step), as indices into its own T-major
        [T * n / R] rows: a contiguous range, since both orders are
        step-major."""
        sl, k = self.rows(n), self.local(n)

        def local(g):
            t, e = divmod(g, n)
            return t * k + min(max(e - sl.start, 0), k)
        return local(a), local(b)

    def local_index(self, idx: torch.Tensor, n: int) -> torch.Tensor:
        """Of the global indices `idx` into a T-major flat [T * n] batch,
        the ones on this rank, in their order, as indices into its own
        T-major [T * n / R] rows."""
        sl, k = self.rows(n), self.local(n)
        t, e = idx // n, idx % n
        mine = (e >= sl.start) & (e < sl.stop)
        return (t * k + e - sl.start)[mine]

    def shard_generator(self, generator: torch.Generator, n: int) -> torch.Generator:
        """`generator` (at its current state) as a RowsGenerator holding the
        rank's rows of n envs; `generator` itself on a mesh of one data
        rank."""
        if self.size == 1:
            return generator
        sl = self.rows(n)
        g = RowsGenerator(device=generator.device)
        g.set_state(generator.get_state())
        g.rows = (sl.start, sl.stop, n)
        return g

    def shard_env(self, env, n: int) -> int:
        """Give `env` the rank's rows of n envs: its generator becomes the
        RowsGenerator of those rows, so its resets and noise draw over the
        global env axis.  Returns the rank's env count; leaves env as it is
        on a mesh of one data rank."""
        if self.size > 1:
            env.generator = self.shard_generator(env.generator, n)
        return self.local(n)

    # ---------------------------------------------------------- collectives
    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum `flat` over the data axis, in place.  gloo reduces a CUDA
        tensor through an explicit copy to the host."""
        if self.group is None:
            raise RuntimeError(f"a mesh of {self.size} data ranks needs torch.distributed: "
                               "call init_distributed before make_mesh")
        self.collectives += 1
        self.bytes_reduced += flat.numel() * flat.element_size()
        if self.backend == "gloo" and flat.is_cuda:
            host = flat.cpu()
            dist.all_reduce(host, group=self.group)
            flat.copy_(host)
        else:
            dist.all_reduce(flat, group=self.group)
        return flat

    def _reduce(self, x, mean: bool):
        single = isinstance(x, torch.Tensor)
        ts = [x] if single else list(x)
        if self.group is None and self.size == 1:
            return x
        dtype = torch.float32
        for t in ts:
            dtype = torch.promote_types(dtype, t.dtype)
        flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in ts])
        self._all_reduce(flat)
        if mean:
            flat = flat / self.size
        out = [c.view(t.shape).to(t.dtype)
               for c, t in zip(torch.split(flat, [t.numel() for t in ts]), ts)]
        return out[0] if single else out

    def sum(self, x):
        """The sum over the data axis of a tensor or a list of tensors (one
        collective over one flat buffer of at least f32)."""
        return self._reduce(x, mean=False)

    def mean(self, x):
        """The mean over the data axis (JAX's pmean): the sum divided by
        the number of data ranks."""
        return self._reduce(x, mean=True)

    def mean_diff(self, ts: list) -> list:
        """Mesh.mean of a list of tensors that autograd differentiates
        through: the backward averages the cotangents over the ranks (MAML's
        inner gradient, whose meta-gradient needs every rank's Hessian)."""
        if self.group is None and self.size == 1:
            return list(ts)
        flat = _AllReduceSum.apply(self, torch.cat([t.reshape(-1) for t in ts])) / self.size
        return [c.view(t.shape) for c, t in zip(torch.split(flat, [t.numel() for t in ts]), ts)]

    def mean_std(self, x: torch.Tensor, dim: int | None = None):
        """The global mean and population std of x over `dim` (None: every
        element), whatever the ranks' local counts: the sums and counts in
        one collective, then the squared deviations from the global mean
        in another (float64 accumulation).  LOCAL gives x.mean and
        x.std(correction=0) themselves."""
        dims = tuple(range(x.dim())) if dim is None else (dim,)
        if self.group is None and self.size == 1:
            return x.mean(dims), x.std(dims, correction=0)
        n = x.numel() if dim is None else x.shape[dim]
        xd = x.double()
        s = xd.sum(dims)
        tot, cnt = self.sum([s, torch.tensor(float(n), dtype=torch.float64, device=x.device)])
        mean = tot / cnt
        m = mean if dim is None else mean.unsqueeze(dim)
        ss = self.sum(((xd - m) ** 2).sum(dims))
        return mean.to(x.dtype), torch.sqrt(ss / cnt).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a mesh's data ranks; its backward is the same sum."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh._all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._all_reduce(g.detach().clone())


LOCAL = Mesh(1, 1)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The ('data', 'model') mesh of the job's ranks: shape (world //
    model_parallel, model_parallel).  Without torch.distributed, a mesh of
    n_devices ranks is a layout only (its collectives raise unless it has
    one data rank); with it, n_devices must be the world size."""
    up = _up()
    world = dist.get_world_size() if up else 1
    n = world if n_devices is None else int(n_devices)
    if up and n != world:
        raise ValueError(f"make_mesh({n_devices}) in a job of {world} ranks")
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel={model_parallel}")
    data = n // model_parallel
    if not up:
        return Mesh(data, model_parallel)
    rank = dist.get_rank()
    group = dist.group.WORLD
    if model_parallel > 1:
        for m in range(model_parallel):   # every rank creates every group
            g = dist.new_group([d * model_parallel + m for d in range(data)])
            if rank % model_parallel == m:
                group = g
    return Mesh(data, model_parallel, rank, group, dist.get_backend())


def broadcast_int(value: int) -> int:
    """`value` of rank 0 on every rank (the JAX CLI's --seed -1 broadcast);
    `value` itself without torch.distributed."""
    if not _up():
        return int(value)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())
