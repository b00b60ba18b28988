"""The federated LM round: every client trains a copy of the global model,
compresses each leaf of its model difference onto the one-bit wire, and
the server makes the Eq.-13 estimate of every leaf.

Counterpart of ``repro/launch/fl_step.py``: the reference's client scan
is a Python loop over the cohort here, client after client, so one
client's local copy, gradients and wire temporaries are resident at a
time. A batch of ``(m_seq, n_pods, ...)`` clients runs scan step ``s`` and
pod ``p`` as the client at cohort position ``s * n_pods + p``: without a
mesh every pod runs here in turn, the reference's vmap over pods as a
loop; on a mesh with a ``"pod"`` dimension (:mod:`repro_torch.distributed`)
each rank trains its own pod's column of the same global batch, and after
the cohort the pods' wire rows are gathered over the pod group, the votes
summed and the losses gathered, so every rank makes the same estimate and
b. The loss metrics are the mean over pods at each scan step, then the
mean over the steps, in the reference's order.

Wire contract (per parameter leaf): client ``g`` compresses leaf ``l``
with the shared ``ClientCompressor`` keyed ``fold_in(fold_in(round_key,
l), g)`` (the :mod:`repro_torch.fl.pytree_wire` schedule), so the bits are
the reference's. At ``rand_bits=32`` the pipeline takes the kernel wire
(``use_kernels``; the engine resolves from the parameters' device): on the
card each (client, leaf) is one launch of the pack kernel (B1), into a
stored ``(M, padded_len(d_l)/8)`` row plane of the leaf, and after the
cohort one launch of the count kernel (B3) a leaf over all M rows makes
its estimate (on a pod mesh, on every rank, after the row gather). The
reference instead folds each client's rows into int32 counts as it goes
and sums the pods' counts; the counts are integers and B3 multiplies by
``f32(1/M)`` as XLA folds ``/M``, so the estimates are the same bits. Rows
cost ``M * d / 8`` bytes against the counts' ``4 * d``, and so do the
gathered rows against the counts' psum: less up to M = 32 clients; a
cohort whose rows alone (all pods' rows) exceed the card's free memory is
refused before the round starts. ``rand_bits=16`` draws 16-bit words
(:func:`~repro_torch.core.quantizer.threshold_u16`), which the reference
refuses on the kernel wire: it stays plain on every device.
``fedavg_fp32`` uploads the f32 model differences.

The local step is the reference's: ``w - lr * (g + lam * (w - w0))`` with
f32 inside, rounded to the parameters' dtype (bf16), no momentum; it is
plain torch here as it is plain JAX there (it is not the prox-SGD kernel
B4, which keeps f32 weights and momentum). The step and the model
difference follow what XLA makes of the reference's bf16 arithmetic on
the CPU (ROADMAP C, "bf16 differences that are widened at once").

The model axis: ``params`` may be DTensors (``models.init_params(...,
mesh=)``, FSDP over "data", tensor and expert parallelism over "model").
The forward and backward then run on the mesh; each gradient is laid out
as its parameter, and the local step, the model difference, the wire and
the estimate run on each rank's local shard, without a gather: B1 packs
the shard's coordinates with the uniforms that the unsharded leaf draws
at them (:func:`~repro_torch.core.quantizer.shard_uniforms`), so every
coordinate's bit is the unsharded wire's, and B3 makes the estimate of
the shard's coordinates from the shard's M rows. A replicated leaf is
compressed whole on every rank, with the same bits on each. The metrics'
wire bytes stay the per-client uplink of the whole leaves.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import distributed, prng
from ..core import build_pipeline
from ..core.aggregation import PackedWire, mean_rows, recip32
from ..core.bcontrol import BControlConfig, BState, update_b_from_vote
from ..fl.pytree_wire import leaf_key
from ..models import train_loss
from ..models.model import unit_remat
from ..models.config import ModelConfig
from ..tree import leaves, unflatten

__all__ = ["DistFLConfig", "bcontrol_config", "update_b_dist", "make_fl_train_step"]


@dataclasses.dataclass(frozen=True)
class DistFLConfig:
    clients_per_round: int = 16  # total across pods; must be divisible by n_pods
    local_steps: int = 1
    lr: float = 0.01
    lam: float = 0.2
    b_up: float = 1.01
    b_down: float = 0.98
    # aggregator: "probit_plus" (paper, 1-bit votes) or "fedavg_fp32"
    # (full-precision baseline, what the paper's 32x claim compares against)
    aggregator: str = "probit_plus"
    # quantizer randomness width: 32 (f32 uniforms, the kernel wire) or 16
    rand_bits: int = 32
    # checkpoint each pattern unit of the local step's model (the
    # reference's ``backbone`` default): a memory lever, which costs one
    # more forward a step; the dry run's steps take it, as the reference's
    # lower it
    remat: bool = False

    def __post_init__(self):
        if self.aggregator not in ("probit_plus", "fedavg_fp32"):
            raise ValueError(f"aggregator must be probit_plus or fedavg_fp32, got {self.aggregator!r}")
        if self.rand_bits not in (16, 32):
            raise ValueError(f"rand_bits must be 16 or 32, got {self.rand_bits}")


def bcontrol_config(fl: DistFLConfig) -> BControlConfig:
    """The b-controller config this step shares with ``fl/rounds.py``."""
    return BControlConfig(mode="dynamic", up=fl.b_up, down=fl.b_down)


def update_b_dist(b: torch.Tensor, vote: torch.Tensor, fl: DistFLConfig) -> torch.Tensor:
    """One controller step from the summed loss-bit vote, through the
    function the simulation rounds call (a tie contracts by ``down``)."""
    return update_b_from_vote(BState(b=b, prev_vote=torch.zeros_like(b)), vote, bcontrol_config(fl)).b


def _value_and_grad(params_leaves: list, like, batch: dict, cfg: ModelConfig, remat: bool = False):
    """``train_loss`` (with ``remat``) and its gradient with respect to
    every leaf (zeros for a leaf the loss does not read, as ``jax.grad``
    gives). On DTensor parameters each gradient comes laid out as its
    parameter and the loss as a plain tensor."""
    req = [w.detach().requires_grad_(True) for w in params_leaves]
    tree = unflatten(like, req)
    with distributed.mesh_context(tree), unit_remat(remat):
        loss = train_loss(tree, batch, cfg)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(req, grads)]
        if distributed.is_dtensor(loss):
            grads = [g.redistribute(w.device_mesh, w.placements) for w, g in zip(req, grads)]
            loss = loss.full_tensor()
    return loss.detach(), grads


def _local(x):
    return x.to_local() if distributed.is_dtensor(x) else x


def _like(x, like):
    """``x`` (a local shard) as a DTensor laid out as ``like``, or ``x``
    when ``like`` is a plain tensor."""
    if not distributed.is_dtensor(like):
        return x
    return distributed.from_shard(x, like.device_mesh, like.placements, like.shape)


def _sharded(w) -> bool:
    """Is ``w`` a DTensor that some rank holds only part of?"""
    from torch.distributed.tensor import Shard

    return distributed.is_dtensor(w) and any(isinstance(p, Shard) and w.device_mesh.size(i) > 1
                                             for i, p in enumerate(w.placements))


def _compress_shard(pipeline, engine, key, delta: torch.Tensor, w, b, g: int) -> torch.Tensor:
    """Client ``g``'s packed row of this rank's shard of leaf ``w``: its
    local coordinates, each with the uniform of the unsharded leaf's draw
    at that coordinate (one launch of B1 through ``quant_pack_u``)."""
    from ..core.quantizer import binarize_prob, pack_bits, shard_uniforms, threshold_u16
    from ..kernels import ops as kops

    comp = pipeline.compressor
    local, off = distributed.shard_bounds(tuple(w.shape), w.device_mesh, w.placements)
    n = delta.numel()
    b_vec = comp.b_vector(n, b)
    if comp.rand_bits == 16:
        w16 = shard_uniforms(prng.fold_in(key, g), tuple(w.shape), local, off, comp.chunk, bits16=True)
        bits = w16 < threshold_u16(binarize_prob(delta.reshape(n), b_vec))
        return kops.realign_wire(pack_bits(bits.to(torch.int8) * 2 - 1), comp.wire_bytes(n))
    u = shard_uniforms(prng.fold_in(key, g), tuple(w.shape), local, off, comp.chunk)
    return kops.quant_pack_u(delta.reshape(n), b_vec, u, engine=engine if comp.use_kernels else "ref")


# Flat elements of a leaf the local step updates at a time (its fused
# multiply-adds run in f64: 128 MiB a temporary).
UPDATE_BLOCK = 1 << 24


def _local_step(local: list, grads: list, w0: list, fl: DistFLConfig) -> list:
    """``(w - lr * (g + lam * (w - w0))).astype(w.dtype)`` as XLA compiles
    the reference's step on the CPU: ``w - w0`` in f32 (XLA drops the bf16
    rounding of a difference that is widened at once), both multiply-adds
    fused (``fma(-lr, fma(lam, w - w0, g), w)``), rounded to the
    parameters' dtype once at the end. A leaf is updated
    :data:`UPDATE_BLOCK` elements at a time."""
    lam, neg_lr = prng._r32(fl.lam), -prng._r32(fl.lr)
    out = []
    with torch.no_grad():
        for i, (w, w_0) in enumerate(zip(local, w0)):
            g, grads[i] = grads[i].reshape(-1), None  # free each gradient once used
            new = torch.empty_like(w)
            wf, w0f, nf = w.reshape(-1), w_0.reshape(-1), new.view(-1)
            for i0 in range(0, wf.numel(), UPDATE_BLOCK):
                sl = slice(i0, i0 + UPDATE_BLOCK)
                wb = wf[sl].float()
                step = prng._fma(lam, wb - w0f[sl].float(), g[sl].float())
                nf[sl] = prng._fma(neg_lr, step, wb).to(w.dtype)
            out.append(new)
    return out


def _pod_group(n_pods: int):
    """The process group of the current mesh's "pod" dimension, whose ranks
    each train one pod's clients (None without such a mesh: every pod
    runs here)."""
    mesh = distributed.current_mesh()
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        return None
    size = distributed.mesh_sizes(mesh)["pod"]
    if size != n_pods:
        raise ValueError(f"the batch has {n_pods} pods; the mesh's pod axis has {size} ranks")
    return mesh.get_group("pod")


def make_fl_train_step(cfg: ModelConfig, fl: DistFLConfig, *, engine: str | None = None):
    """Returns ``train_step(params, b, batch, key) -> (params, b, metrics)``.

    ``params`` is the model's tree of tensors, ``b`` a 0-dim f32 tensor,
    ``key`` a ``(2,)`` Threefry key; batch leaves are ``(m_seq, n_pods,
    local_steps, per_batch, ...)``, the whole cohort's on every rank of a
    pod mesh, whose pod axis must have ``n_pods`` ranks (module
    docstring). ``engine`` is passed to the wire's kernels (None:
    resolve from the parameters' device; ``"ref"`` forces the plain
    versions). Metrics: ``loss_first``, ``loss_last``, ``b`` and the
    round's uplink ``wire_bytes`` (as shipped) beside
    ``wire_bytes_int8`` / ``wire_bytes_f32``. The step's pipeline is
    ``train_step.pipeline``.
    """
    probit = fl.aggregator == "probit_plus"
    pipeline = build_pipeline("probit_plus", rand_bits=fl.rand_bits, use_kernels=fl.rand_bits == 32, engine=engine)
    compressor = pipeline.compressor

    def train_step(params, b, batch, key):
        first = leaves(batch)[0]
        m_seq, n_pods = first.shape[0], first.shape[1]
        group = _pod_group(n_pods)
        pods = range(n_pods) if group is None else [distributed.group_rank(group)]
        m_total = m_seq * n_pods
        p_leaves = leaves(params)
        w_loc = [_local(w) for w in p_leaves]  # this rank's shards (the leaves themselves without a mesh)
        dims = [w.numel() for w in p_leaves]  # whole leaves: the wire's report
        loc_dims = [w.numel() for w in w_loc]
        sharded = [_sharded(w) for w in p_leaves]
        dev = w_loc[0].device
        row_bytes = [compressor.wire_bytes(d) for d in loc_dims]
        if probit and dev.type == "cuda" and m_total * sum(row_bytes) > torch.cuda.mem_get_info(dev)[0]:
            raise MemoryError(f"{m_total} clients' wire rows need {m_total * sum(row_bytes) / 1e9:.2f} GB, more "
                              f"than the card has free ({torch.cuda.mem_get_info(dev)[0] / 1e9:.2f} GB)")
        if probit:
            # this process's rows, row s * len(pods) + j for pod pods[j] at scan step s
            rows = [torch.empty((m_seq * len(pods), p), dtype=torch.uint8, device=dev) for p in row_bytes]
        else:
            acc = [[torch.zeros(w.shape, dtype=torch.float32, device=dev) for w in w_loc] for _ in pods]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        keys = [leaf_key(key, i) for i in range(len(p_leaves))]
        # the clients' one-bit loss votes, summed as a tensor (no host sync)
        votes, losses = torch.zeros((), dtype=torch.float32, device=dev), []
        for s in range(m_seq):
            for j, p in enumerate(pods):
                g = s * n_pods + p  # the client's cohort position keys its quantizer rows
                local, client_losses = w_loc, []
                for t in range(fl.local_steps):
                    sb = {k: v[s, p, t] for k, v in batch.items()}
                    loss, grads = _value_and_grad([_like(x, w) for x, w in zip(local, p_leaves)], params, sb, cfg,
                                                  fl.remat)
                    client_losses.append(loss)
                    local = _local_step(local, [_local(x) for x in grads], w_loc, fl)
                    del grads
                with torch.no_grad():
                    for i, (w_l, w, d) in enumerate(zip(local, w_loc, loc_dims)):
                        # the difference in f32, as XLA computes the widened bf16 one
                        delta = (w_l.float() - w.float()).reshape(1, d)
                        if probit and sharded[i]:
                            rows[i][s * len(pods) + j] = _compress_shard(pipeline, engine, keys[i], delta,
                                                                         p_leaves[i], b, g)
                        elif probit:
                            wire, _ = compressor.compress(keys[i], delta, b, zero, row_offset=g)
                            rows[i][s * len(pods) + j] = wire.packed[0]
                        else:
                            acc[j][i] += delta.view(w.shape)
                        del delta
                del local
                losses.append(torch.stack([client_losses[0], client_losses[-1]]))
                votes = votes + torch.where(client_losses[-1] < client_losses[0], 1.0, -1.0)
        losses = torch.stack(losses).view(m_seq, len(pods), 2)
        if group is not None:
            # the pods' votes, losses and rows (or sums) cross ranks
            votes = distributed.all_reduce_sum(votes, group)
            losses = distributed.all_gather_rows(losses[:, 0], group).transpose(0, 1)
        with torch.no_grad():
            if probit:
                new_leaves = []
                for i, (w, d) in enumerate(zip(w_loc, loc_dims)):
                    if group is not None:
                        rows[i] = distributed.all_gather_rows(rows[i], group).transpose(0, 1).reshape(m_total, -1)
                    wire = PackedWire(packed=rows[i], b=compressor.b_vector(d, b), d=d)
                    theta = pipeline.estimate(wire)
                    rows[i] = None
                    new_leaves.append((w.float() + theta.view(w.shape)).to(w.dtype))
                wire_row_bytes = sum(compressor.wire_bytes(d) for d in dims)
            else:
                new_leaves = []
                for i, w in enumerate(w_loc):
                    if group is None:
                        total = functools.reduce(torch.add, [a[i] for a in acc])  # the pods' sums, in order
                    else:
                        total = distributed.all_reduce_sum(acc[0][i], group)
                    new_leaves.append((w.float() + total * recip32(m_total)).to(w.dtype))
                wire_row_bytes = 4 * sum(dims)
        b_new = update_b_dist(b, votes, fl)
        # the mean over pods at each scan step, then over the steps
        step_means = losses.sum(1) * recip32(n_pods)
        metrics = {
            "loss_first": mean_rows(step_means[:, 0].contiguous()),
            "loss_last": mean_rows(step_means[:, 1].contiguous()),
            "b": b_new,
            "wire_bytes": m_total * wire_row_bytes,
            "wire_bytes_int8": m_total * sum(dims),
            "wire_bytes_f32": m_total * 4 * sum(dims),
        }
        return unflatten(params, [_like(x, w) for x, w in zip(new_leaves, p_leaves)]), b_new, metrics

    train_step.pipeline = pipeline
    return train_step
