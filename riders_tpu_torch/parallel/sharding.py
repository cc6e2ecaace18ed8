"""The (data, points) mesh of ranks and the sharded-step machinery.

One process (rank) per device, joined by `torch.distributed`: NCCL on
the card, gloo on the CPU.  The mesh views the ranks as an
(n_data, n_points) grid, row-major as the JAX package's device mesh:

* ``data``   - the frame batch axis: training batches and fused-inference
               frames split over it;
* ``points`` - the per-frame radar-point patch axis: RC-Net's per-point
               work (RoI pool, point MLP, attention, decoder) splits the
               K points of each frame over it, while the encoder runs on
               the rank's frames.

Parameters and optimizer state are replicated.  A step wrapped by
`with_data_sharding` computes what the unsharded step computes: inside
it every BatchNorm's statistics, the loss normalisers and the batch-wide
median span the global batch through differentiable collectives
(`Axis`), each rank's loss is its 1 / n share of the global loss over
the n ranks of the mesh, and the gradients are summed over the mesh
before the optimizer's update (the encoder is replicated over `points`,
so each points rank holds one copy's share of its gradient).

`make_mesh`, and so `mesh_from_config`, is collective: every rank of
the job calls it, in the same order.
"""

from __future__ import annotations

import contextvars
import dataclasses
import datetime
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from riders_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
POINTS_AXIS = "points"
MESH_AXIS = "mesh"          # every rank of the mesh
# the keys of the RC-Net training batch indexed (B, K, ...) by frame and
# radar point
POINT_KEYS = ("points", "point_mask", "boxes", "gt_crops")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         timeout_s: Optional[float] = None) -> torch.device:
    """Join a job of `num_processes` processes as rank `process_id`, one
    rank per device, and return this rank's device.

    NCCL on the card (the default device); gloo only when `device` names
    the CPU.  The coordinator is 'host:port' (TCP) or a URL
    ('tcp://...', 'file://...'); without an address and a process count
    the job is read from torchrun's environment (env://).  Raises when
    the joined world's size is not `num_processes`."""
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None and num_processes is None:
        init_method, world, rank = "env://", -1, -1
    else:
        if coordinator_address is None or num_processes is None:
            raise ValueError("a coordinator address and the number of "
                             "processes go together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
        if rank is None or not 0 <= rank < world:
            raise ValueError(f"process id {rank} not in [0, {world})")
    if device.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", (rank if rank >= 0 else int(os.environ.get(
                "RANK", 0))) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    if num_processes is not None and dist.get_world_size() != num_processes:
        joined = dist.get_world_size()
        dist.destroy_process_group()
        raise RuntimeError(f"init_process_group joined {joined} "
                           f"process(es), expected {num_processes}")
    return device


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The job's number of ranks (1 without a process group)."""
    return dist.get_world_size() if _joined() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _joined() else 0


class Axis:
    """One axis of a mesh as a process group: the ranks of the mesh that
    differ only in that coordinate (or, for MESH_AXIS, all of them).
    Without a process group (a world of one) every collective is the
    identity.  The collectives count themselves in the mesh's `calls`."""

    def __init__(self, name: str, ranks: Sequence[int], rank: int, group,
                 calls: Dict[str, int]):
        self.name = name
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank) if rank in self.ranks else None
        self.group = group
        self._calls = calls

    def _count(self, kind: str) -> None:
        key = f"{kind}:{self.name}"
        self._calls[key] = self._calls.get(key, 0) + 1

    def reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the axis (no gradient)."""
        if self.group is not None:
            self._count("all_reduce")
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The axis's tensors concatenated along `dim` (no gradient)."""
        if self.group is None:
            return t
        self._count("all_gather")
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """In place, the axis's first rank's value."""
        if self.group is not None:
            self._count("broadcast")
            dist.broadcast(t, self.ranks[0], group=self.group)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis, differentiable: the gradient of each rank's
        copy of the sum flows back summed to every addend."""
        return t if self.group is None else _AllReduce.apply(t, self)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Concatenation over the axis along `dim`, differentiable: each
        rank's slice gets the sum of every rank's gradient of it."""
        return t if self.group is None else _AllGather.apply(t, self, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return axis.reduce_(t.detach().clone().contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_(g.clone().contiguous()), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, t.shape[dim]
        return axis.gather(t.detach(), dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.axis.reduce_(g.clone().contiguous())
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


class _CrossRankBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the batch every rank of `axis` holds a
    part of, in plain operations (the CPU's form).  Forward: each rank's
    (mean, n * biased variance, n) per channel, one gather, Chan's
    combination, then the normalisation with those statistics, centred
    first.  Backward, as torch's SyncBatchNorm: the per-channel sums of
    dy and dy * (x - mean) summed over the axis by one all-reduce for the
    input's gradient; the weight's and bias's gradients are this rank's
    own share (the step sums parameter gradients over the mesh)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, axis):
        C, dims = x.shape[1], (0, 2, 3)
        var_l, mean_l = torch.var_mean(x, dim=dims, correction=0)
        n_l = x.numel() // C
        stats = axis.gather(torch.cat([mean_l, var_l * n_l,
                                       mean_l.new_full((1,), n_l)])[None])
        n = stats[:, -1:]
        total = n.sum()
        mean = (stats[:, :C] * n).sum(0) / total
        var = (stats[:, C:2 * C]
               + n * (stats[:, :C] - mean) ** 2).sum(0) / total
        invstd = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        # centred first, as a train-mode BatchNorm: an eval-mode kernel
        # folds the mean into the shift, which cancels catastrophically
        # where a channel's variance is small against its mean
        y = torch.addcmul(bias.view(shape), x - mean.view(shape),
                          (invstd * weight).view(shape))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.axis, ctx.total = axis, total
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        C, dims, shape = x.shape[1], (0, 2, 3), (1, -1, 1, 1)
        xmu = x - mean.view(shape)
        sums = torch.cat([dy.sum(dims), (dy * xmu).sum(dims)])
        local = sums.clone()
        ctx.axis.reduce_(sums)
        mean_dy, mean_dy_xmu = sums[:C] / ctx.total, sums[C:] / ctx.total
        grad = (dy - mean_dy.view(shape)
                - xmu * (invstd * invstd * mean_dy_xmu).view(shape)) * \
            (invstd * weight).view(shape)
        return grad, local[C:] * invstd, local[:C], None, None


class _CrossRankBatchNormCUDA(torch.autograd.Function):
    """The same function on the card from ATen's fused batch-norm
    operations, as torch's SyncBatchNorm composes them (one gather of
    each rank's (mean, invstd, n), one all-reduce in the backward), in
    a handful of launches where the plain form takes ~40 a layer: the
    sharded step is host-bound on them.  The biased variance for the
    running statistics is recovered from the global invstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, axis):
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        C = x.shape[1]
        mean_l, invstd_l = torch.batch_norm_stats(x, eps)
        stats = axis.gather(torch.cat([mean_l, invstd_l, mean_l.new_full(
            (1,), x.numel() // C)])[None])
        counts = stats[:, -1]
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, stats[:, :C].contiguous(), stats[:, C:2 * C].contiguous(),
            None, None, 0.0, eps, counts)
        y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        ctx.axis = axis
        var = 1.0 / (invstd * invstd) - eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        if not dy.is_contiguous(memory_format=torch.channels_last):
            dy = dy.contiguous()
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, True, True, True)
        C = sum_dy.shape[0]
        sums = ctx.axis.reduce_(torch.cat([sum_dy, sum_dy_xmu]))
        grad = torch.batch_norm_backward_elemt(
            dy, x, mean, invstd, weight, sums[:C], sums[C:], counts)
        return grad, grad_w, grad_b, None, None


def cross_rank_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float, axis: Axis):
    """(y, mean, biased var) of a train-mode BatchNorm of NCHW `x` whose
    batch spans `axis`; mean and var carry no gradient.  On the card in
    ATen's fused batch-norm operations, elsewhere in plain ones."""
    fn = _CrossRankBatchNormCUDA if x.is_cuda else _CrossRankBatchNorm
    return fn.apply(x, weight, bias, eps, axis)


def mesh_shape(n_data: int, n_points: int, n_ranks: int) -> Tuple[int, int]:
    """The (n_data, n_points) grid for `n_ranks` ranks; n_data -1 takes
    every rank left.  Raises as the JAX package's `make_mesh` does."""
    if n_points < 1:
        raise ValueError(f"n_points must be >= 1, got {n_points}")
    if n_data == -1:
        n_data = n_ranks // n_points
    if n_data < 1:
        raise ValueError(f"mesh wants n_points={n_points} but only "
                         f"{n_ranks} rank(s) are available")
    if n_data * n_points > n_ranks:
        raise ValueError(f"mesh wants {n_data * n_points} ranks ({n_data} "
                         f"data x {n_points} points), have {n_ranks}")
    return n_data, n_points


class Mesh:
    """The first n_data * n_points ranks of the job as an
    (n_data, n_points) grid; rank r sits at (r // n_points, r % n_points).
    `calls` counts the collectives its axes launched, by kind and axis."""

    def __init__(self, n_data: int, n_points: int):
        joined = _joined()
        n_ranks = process_count()
        self.rank = process_index()
        self.shape = {DATA_AXIS: n_data, POINTS_AXIS: n_points}
        self.size = n_data * n_points
        self.calls: Dict[str, int] = {}
        mesh_shape(n_data, n_points, n_ranks)
        layouts = {
            DATA_AXIS: [[d * n_points + p for d in range(n_data)]
                        for p in range(n_points)],
            POINTS_AXIS: [[d * n_points + p for p in range(n_points)]
                          for d in range(n_data)],
            MESH_AXIS: [list(range(self.size))]}
        self._axes: Dict[str, Axis] = {}
        for name, groups in layouts.items():
            for ranks in groups:
                # new_group is collective over the world: every rank
                # creates every group, in the same order
                group = dist.new_group(ranks) if joined else None
                if self.rank in ranks:
                    self._axes[name] = Axis(name, ranks, self.rank, group,
                                            self.calls)

    @property
    def devices_shape(self) -> Tuple[int, int]:
        return self.shape[DATA_AXIS], self.shape[POINTS_AXIS]

    def axis(self, name: str) -> Axis:
        if self.rank >= self.size:
            raise ValueError(f"rank {self.rank} lies outside the "
                             f"{self.devices_shape} mesh")
        return self._axes[name]

    def index(self, name: str) -> int:
        """This rank's coordinate along `name`."""
        return self.axis(name).index


def make_mesh(n_data: int = -1, n_points: int = 1) -> Mesh:
    """A (data, points) mesh over the job's ranks (a world of one without
    a process group).  Collective: every rank calls it."""
    return Mesh(*mesh_shape(n_data, n_points, process_count()))


def mesh_from_config(mesh_cfg) -> Mesh:
    """The mesh of a `core.config.MeshConfig`."""
    return make_mesh(mesh_cfg.data_parallel, mesh_cfg.points_parallel)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which part of an array a rank holds: dimension i splits in equal
    blocks over mesh axis spec[i] (None: whole); dimensions past the
    spec are whole."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def local(self, x):
        """This rank's block of `x` (a tensor or numpy array, sliced
        without a copy).  Raises when a split dimension does not divide."""
        index = []
        for dim, name in enumerate(self.spec):
            if name is None:
                index.append(slice(None))
                continue
            n = self.mesh.shape[name]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of shape "
                                 f"{tuple(x.shape)} does not split over "
                                 f"the {n} ranks of mesh axis '{name}'")
            m = x.shape[dim] // n
            i = self.mesh.index(name)
            index.append(slice(i * m, (i + 1) * m))
        return x[tuple(index)]


def batch_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """The leading (batch) axis over `data`."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def frame_points_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """(B, K, ...) arrays over (data, points)."""
    return Sharding(mesh, (DATA_AXIS, POINTS_AXIS) + (None,) * (ndim - 2))


def shard_batch(mesh: Mesh, batch: Dict,
                point_keys: Sequence[str] = ("points", "point_mask",
                                             "boxes"),
                frames_local: bool = False) -> Dict:
    """This rank's part of a global batch: frame-indexed arrays over
    `data`, the (B, K, ...) arrays of `point_keys` over (data, points).
    With `frames_local` the batch already holds only this rank's frames
    and only the points are split."""
    out = {}
    for k, v in batch.items():
        sharding = (frame_points_sharding(mesh, v.ndim)
                    if k in point_keys and v.ndim >= 2
                    else batch_sharding(mesh, v.ndim))
        if frames_local:
            sharding = dataclasses.replace(
                sharding, spec=(None,) + sharding.spec[1:])
        out[k] = sharding.local(v)
    return out


# --- the global batch of a sharded step ----------------------------------
# What a step computes over its batch - the BatchNorm statistics, the
# loss reductions and the median, the backward and the gradient sum - is
# decided here and only here: the models, losses and steps call these
# functions, which are the single-process operations outside a sharded
# step.

@dataclasses.dataclass(frozen=True, eq=False)
class StepContext:
    """The active sharded step: its mesh, the axis over which the loss's
    batch is spread (`data` for per-frame losses, the whole mesh for
    per-point ones) and the axis each BatchNorm's batch spans."""

    mesh: Mesh
    loss_axis: Axis
    bn_axes: Dict[nn.Module, Axis]


_STEP: contextvars.ContextVar[Optional[StepContext]] = \
    contextvars.ContextVar("riders_sharded_step", default=None)


def _point_batch_modules() -> Tuple[type, ...]:
    """The modules whose batch is the frames' point patches (B * K), not
    the frames: RC-Net's decoder.  Their BatchNorms span the whole mesh,
    the others `data` (a frame counts once however many points ranks
    hold it)."""
    from riders_tpu_torch.models.rcnet import MultiScaleDecoder
    return (MultiScaleDecoder,)


def _batch_norm_axes(mesh: Mesh, model: nn.Module) -> Dict[nn.Module, Axis]:
    """The axis of every BatchNorm of `model`."""
    from riders_tpu_torch.models.layers import BatchNorm2d
    per_point = _point_batch_modules()
    axes: Dict[nn.Module, Axis] = {}

    def walk(module: nn.Module, axis: Axis) -> None:
        if isinstance(module, per_point):
            axis = mesh.axis(MESH_AXIS)
        if isinstance(module, BatchNorm2d):
            axes[module] = axis
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            raise TypeError(f"{type(module).__name__} has no cross-rank "
                            "statistics: use models.layers.BatchNorm2d")
        for child in module.children():
            walk(child, axis)

    walk(model, mesh.axis(DATA_AXIS))
    return axes


def batch_norm_axis(bn: nn.Module) -> Optional[Axis]:
    """The axis a train-mode BatchNorm's batch spans inside a sharded
    step (its statistics are then `cross_rank_batch_norm`'s), or None
    outside one."""
    ctx = _STEP.get()
    return None if ctx is None else ctx.bn_axes.get(bn)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the batch: over every rank's part inside a
    sharded step (differentiably), else torch.sum."""
    ctx = _STEP.get()
    s = torch.sum(x)
    return s if ctx is None else ctx.loss_axis.all_reduce(s)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the batch, as `batch_sum`."""
    ctx = _STEP.get()
    if ctx is None:
        return torch.mean(x)
    s = ctx.loss_axis.all_reduce(torch.stack(
        [torch.sum(x), x.new_full((), float(x.numel()))]))
    return s[0] / s[1]


def batch_gather(x: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, mask) of the whole batch: inside a sharded step every rank's
    part gathered in rank order, which is the batch's own order (x
    differentiably); else as given."""
    ctx = _STEP.get()
    if ctx is None:
        return x, mask
    return ctx.loss_axis.all_gather(x), ctx.loss_axis.gather(mask)


def all_reduce_gradients(params: Sequence[torch.Tensor], axis: Axis) -> None:
    """Sum the `.grad`s of `params` over `axis`, one flat buffer per
    dtype.  Every rank must hold gradients for the same parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = axis.reduce_(torch.cat([g.reshape(-1) for g in group]))
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def backward(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
    """The backward of a step's loss into the `.grad`s of `params`.
    Inside a sharded step `loss` is the global batch's: each rank takes
    the backward of its 1 / n share over the mesh's n ranks and the
    gradients are summed over the mesh, so that every rank holds the
    unsharded step's gradients."""
    ctx = _STEP.get()
    if ctx is None:
        loss.backward()
        return
    (loss / ctx.mesh.size).backward()
    all_reduce_gradients(params, ctx.mesh.axis(MESH_AXIS))


def with_data_sharding(mesh: Mesh, fn: Callable,
                       point_keys: Sequence[str] = POINT_KEYS,
                       frames_local: bool = False) -> Callable:
    """Wrap a step(state, batch) -> (state, aux) of `pipelines.*_training`
    to run data-parallel over `mesh`: each rank takes its frames over
    `data` and, for the (B, K, ...) keys of `point_keys`, its points over
    `points` (with `frames_local` the batch holds this rank's frames
    already), and the step runs with cross-rank BatchNorm statistics and
    loss reductions, each rank's loss its share of the global one, and
    the gradients summed over the mesh before the update (`backward`,
    which `sml_training.apply_update` calls).  The first call broadcasts the model's
    parameters and buffers from the mesh's first rank."""
    synced = []

    def sharded(state, batch):
        axis = mesh.axis(MESH_AXIS)
        if not synced:
            with torch.no_grad():
                for t in list(state.model.parameters()) + list(
                        state.model.buffers()):
                    axis.broadcast_(t.data)
            synced.append(True)
        local = shard_batch(mesh, batch, point_keys, frames_local)
        per_point = any(k in local and local[k].ndim >= 2
                        for k in point_keys)
        token = _STEP.set(StepContext(
            mesh, axis if per_point else mesh.axis(DATA_AXIS),
            _batch_norm_axes(mesh, state.model)))
        try:
            return fn(state, local)
        finally:
            _STEP.reset(token)

    return sharded
