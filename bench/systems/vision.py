"""The paper's federated vision round of ``repro_torch.fl`` as a cell.

The window drives ``FLSimulation.iter_rounds`` (``fl/runtime.py``), which
runs ``fl/rounds.py``'s synchronous round: every client's local training
through the prox-SGD kernel (B4), the one-bit compress (B1) and the count
estimate (B3). The initial model, the clients' images and labels come
from the seed; the simulation's own key schedule starts at ``seed``.
Stage spans are CUDA events around local training, the compress and the
estimate.

Twenty local steps of SGD at this learning rate amplify the last bit of
an f32 convolution into differences of the size of b, so no reference
that differs from the program in rounding order can follow a whole round.
The check follows the program step by step from the program's own state
instead (:func:`check`): during the set-up rounds the benchmark copies,
without changing anything, every client's weights after its first local
step, the weights and momentum entering every local step of a few clients
drawn from the seed, each client's first and last local loss, the trained
local models and the estimate.
"""

from __future__ import annotations

import contextlib
import statistics
import unittest.mock as mock

import torch

from .. import gen, work
from ..reference import threefry
from ..reference import vision as ref_vision
from .common import Record, finite, leaf_gaps, rel

CONV_SCALE = 0.1  # the paper model's convolution init
CONTROL = "tf32"  # the precision below the configuration's f32 with TF32 off
WATCHED_CLIENTS = 2  # clients whose every local step is followed (every client's first is)
NUMBERS = ("step_gap", "step_gap_max", "loss_gap", "b_gap", "theta_gap")


def initial_model(config: dict, seed: int, device) -> dict:
    """The nested dict of initial leaves: convolutions ``0.1 * normal``, the
    dense head ``normal * fan_in ** -0.5``, GroupNorm scales 1 and shifts
    0, the head's bias 0."""
    table = []
    for name, shape in ref_vision.flat_leaves(ref_vision.leaf_shapes(config)):
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("g1", "g2"):
            table.append((name, shape, "ones", 1.0, torch.float32))
        elif leaf in ("b1", "b2", "head_b"):
            table.append((name, shape, "zeros", 1.0, torch.float32))
        else:
            table.append((name, shape, "normal", shape[0] ** -0.5 if leaf == "head_w" else CONV_SCALE, torch.float32))
    flat = gen.normal_leaves(table, seed, device, "params")
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def initial_flat(config: dict, seed: int, device) -> torch.Tensor:
    p0 = initial_model(config, seed, device)
    return torch.cat([_get(p0, n).reshape(-1) for n, _ in ref_vision.flat_leaves(ref_vision.leaf_shapes(config))])


def client_data(config: dict, traffic: dict, seed: int, device):
    return gen.image_clients(seed, traffic, config["clients"], config["image_size"], config["in_channels"],
                             config["classes"], device)


def local_steps(traffic: dict) -> int:
    return max(traffic["local_epochs"] * traffic["per_client"] // traffic["batch_size"], 1)


def watched(config: dict, seed: int) -> tuple:
    """The clients, drawn from the seed, whose every local step the check
    follows."""
    g = torch.Generator().manual_seed(gen.sub_seed(seed, "watched"))
    return tuple(torch.randperm(config["clients"], generator=g)[:WATCHED_CLIENTS].sort().values.tolist())


def sim_config(config: dict, traffic: dict, seed: int):
    from repro_torch.fl import FLConfig

    return FLConfig(n_clients=config["clients"], rounds=1 << 30, local_epochs=traffic["local_epochs"],
                    batch_size=traffic["batch_size"], lr=traffic["lr"], momentum=traffic["momentum"],
                    lam=traffic["lam"], b_mode=traffic["b_mode"], b_init=traffic["b_init"],
                    aggregator=traffic["aggregator"], use_kernels=traffic["use_kernels"], seed=seed)


class Cell:
    """One vision cell: an FLSimulation on the seed's model and data."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import functools

        from repro_torch.core.aggregation import AggregatorPipeline
        from repro_torch.fl import FLSimulation, rounds
        from repro_torch.models import accuracy, resnet_logits, xent_loss

        if config["model"] != "resnet" or config["torch_dtype"] != "float32" or config["tf32"]:
            raise ValueError(f"{config['name']}: the reference models the f32 ResNet without TF32")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.model = ref_vision.ResNet(config)
        p0 = initial_model(config, seed, self.device)
        cx, cy = client_data(config, traffic, seed, self.device)
        logits = functools.partial(resnet_logits, blocks=tuple(config["blocks"]))
        test = {"x": cx[0, :1], "y": cy[0, :1]}
        self.sim = FLSimulation(sim_config(config, traffic, seed), p0, functools.partial(xent_loss, logits),
                                functools.partial(accuracy, logits), cx, cy, test, device=self.device)
        if self.sim.d != self.model.d:
            raise ValueError(f"the program's d = {self.sim.d}, the configuration's {self.model.d}")
        self.rounds = self.sim.iter_rounds()
        self._metrics = None
        self._seen: dict = {}
        self.span_targets = [(rounds, "local_prox_train", "local_train"),
                             (AggregatorPipeline, "compress_wire", "compress"),
                             (AggregatorPipeline, "estimate", "estimate")]

    def round(self) -> None:
        _, self._metrics = next(self.rounds)

    def losses(self) -> list:
        return [float(self._metrics["loss"])]

    @contextlib.contextmanager
    def watching(self):
        """Copy, without changing anything, what the check follows: every
        client's weights leaving its first local step, the watched clients'
        weights and momentum entering each local step, and every client's
        first and last local loss."""
        from repro_torch.fl import rounds
        from repro_torch.kernels import ops

        rows = torch.tensor(watched(self.config, self.seed), device=self.device)
        prox, train = ops.prox_sgd, rounds.local_prox_train
        calls = [0]

        def prox_sgd(w, w0, grad, momentum, coeffs, *, out=None, engine=None):
            step = calls[0]
            calls[0] += 1
            # copied before the call, which may write in place
            self._seen["chain_w"].append(w.index_select(0, rows).to("cpu"))
            self._seen["chain_m"].append(momentum.index_select(0, rows).to("cpu"))
            w_new, m_new = prox(w, w0, grad, momentum, coeffs, out=out, engine=engine)
            if step == 0:
                self._seen["first_step"] = w_new.to("cpu", copy=True)  # later steps write it in place
            return w_new, m_new

        def local_prox_train(*args, **kwargs):
            calls[0] = 0
            self._seen.update(chain_w=[], chain_m=[])
            w, loss_before, loss_after = train(*args, **kwargs)
            self._seen["before"], self._seen["after"] = loss_before.to("cpu"), loss_after.to("cpu")
            return w, loss_before, loss_after

        with mock.patch.object(ops, "prox_sgd", prox_sgd), \
                mock.patch.object(rounds, "local_prox_train", local_prox_train):
            yield

    def snapshot(self) -> dict:
        """The round's outputs for the check (on the host)."""
        seen, self._seen = self._seen, {}
        return {"loss": float(self._metrics["loss"]), "b": float(self._metrics["b"]),
                "theta": self._metrics["theta"].to("cpu"), "w_locals": self.sim.w_locals.to("cpu"),
                "w_global": self.sim.w_global.to("cpu"), **seen}

    def free(self) -> None:
        self.sim = self.rounds = self._metrics = None

    def work(self) -> dict:
        m, d = self.config["clients"], self.model.d
        t = self.traffic
        images = m * local_steps(t) * t["batch_size"]
        b_len = int(self.sim.state.b.b.numel())  # the dynamic b: one scalar
        return {"compress": [(m, d)], "b3": [(m, d, b_len)], "b4": [(m, d)] * local_steps(t),
                "model_flops": 3.0 * work.resnet_forward_flops(self.config) * images,
                "peak_flops": work.PEAK_FLOPS[self.config["torch_dtype"]]}

    @contextlib.contextmanager
    def stale_client(self):
        """B4 leaves the cohort's last row, weights and momentum, as it was
        at every local step (one client's update lost)."""
        from repro_torch.kernels import ops

        prox = ops.prox_sgd

        def stale(w, w0, grad, momentum, coeffs, *, out=None, engine=None):
            w_last, m_last = w[-1].clone(), momentum[-1].clone()
            w_new, m_new = prox(w, w0, grad, momentum, coeffs, out=out, engine=engine)
            w_new[-1], m_new[-1] = w_last, m_last
            return w_new, m_new

        with mock.patch.object(ops, "prox_sgd", stale):
            yield

    @contextlib.contextmanager
    def unchanged(self):
        """Each round returns the state it was given."""
        sim = self.sim
        round_fn = sim._round

        def frozen(ctx, params, key, state, batches):
            _, metrics = round_fn(ctx, params, key, state, batches)
            return state, metrics

        sim._round = frozen
        try:
            yield
        finally:
            sim._round = round_fn


def check(config: dict, traffic: dict, seed: int, device, record: Record) -> dict:
    """The reference follows the record step by step from its own state
    (round 1's first steps from the seed's model) and is held to it, each
    number the worst over the compared rounds:

    * ``step_gap`` and ``step_gap_max``: local steps recomputed from the
      record's weights and momentum entering them, each gradient on the
      reference's own batch: every client's first step (from the model it
      entered the round with and zero momentum) and every step of the
      watched clients. A reading is the gap of the weights leaving the step
      against the step's size, and of the momentum leaving it against the
      momentum's change, where the record holds it. ``step_gap`` is the
      median of the readings (a ReLU whose input lies within a rounding of
      zero moves one client's gradient by up to a percent in either
      precision: the median reads the steps that hit none), ``step_gap_max``
      the largest (one client's or one step's fault);
    * ``loss_gap``: every client's first local loss (at its model entering
      the round) and last (at its trained model), recomputed, and the
      round's mean last loss;
    * ``b_gap``: b after the vote of the record's own loss bits (the vote's
      arithmetic; the losses themselves are ``loss_gap``'s);
    * ``theta_gap``: the estimate from the record's model differences on
      the reference's own uniforms, by leaf (:func:`common.leaf_gaps`).
    """
    model = ref_vision.ResNet(config)
    names = [n for n, _ in model.leaves]

    def split(v: torch.Tensor) -> dict:
        return dict(zip(names, torch.split(v.reshape(-1), model.sizes)))

    def gap(out: torch.Tensor, ref: torch.Tensor, entering: torch.Tensor) -> float:
        return float((out.to(device) - ref).norm() / (ref - entering).norm().clamp(min=1e-30))

    cx, cy = client_data(config, traffic, seed, device)
    clients = watched(config, seed)
    n_clients, n_steps = config["clients"], local_steps(traffic)
    batch, per_client = traffic["batch_size"], traffic["per_client"]
    w_start = initial_flat(config, seed, device)
    key, b = threefry.key(seed, device), float(traffic["b_init"])
    w_global, w_locals = w_start, None
    out = dict.fromkeys(NUMBERS, 0.0)
    readings = []
    with torch.no_grad():
        for rec in record.rounds:
            if "first_step" not in rec or len(rec["chain_w"]) != n_steps:
                return {k: None for k in NUMBERS}
            key, kb, k_q = ref_vision.round_keys(key)
            idx = torch.stack([ref_vision.batch_indices(kb, m, n_steps, batch, per_client) for m in range(n_clients)])
            start = w_locals if w_locals is not None else w_start.expand(n_clients, -1)
            trained = rec["w_locals"].to(device)

            def step(c, s, w_in, m_in):
                with torch.enable_grad():
                    return ref_vision.prox_step(model, w_in, m_in, w_global, cx[c][idx[c, s]], cy[c][idx[c, s]],
                                                traffic)

            zero = torch.zeros_like(w_start)
            for c in range(n_clients):
                w_ref, _ = step(c, 0, start[c], zero)
                readings.append(gap(rec["first_step"][c], w_ref, start[c]))
            for k, c in enumerate(clients):
                for s in range(n_steps):
                    w_in, m_in = ((start[c], zero) if s == 0 else
                                  (rec["chain_w"][s][k].to(device), rec["chain_m"][s][k].to(device)))
                    w_ref, m_ref = step(c, s, w_in, m_in)
                    last = s == n_steps - 1
                    readings.append(gap(trained[c] if last else rec["chain_w"][s + 1][k], w_ref, w_in))
                    if not last:
                        readings.append(gap(rec["chain_m"][s + 1][k], m_ref, m_in))
            before = torch.stack([model.loss(start[m], cx[m][idx[m, 0]], cy[m][idx[m, 0]])
                                  for m in range(n_clients)])
            after = torch.stack([model.loss(trained[m], cx[m][idx[m, -1]], cy[m][idx[m, -1]])
                                 for m in range(n_clients)])
            gaps = [rel(float(p), float(q)) for p, q in zip(rec["before"], before.cpu())]
            gaps += [rel(float(p), float(q)) for p, q in zip(rec["after"], after.cpu())]
            out["loss_gap"] = max([out["loss_gap"], rel(rec["loss"], ref_vision.mean_loss(after))] + gaps)
            out["b_gap"] = max(out["b_gap"], rel(rec["b"], ref_vision.next_b(b, rec["before"], rec["after"])))
            theta = ref_vision.estimate(trained - w_global, b, k_q)
            _, diff = leaf_gaps(split(rec["theta"]), split(theta), split(torch.zeros_like(theta)), device)
            out["theta_gap"] = max(out["theta_gap"], diff)
            w_global, w_locals, b = rec["w_global"].to(device), trained, rec["b"]
    out["step_gap"], out["step_gap_max"] = statistics.median(readings), max(readings)
    return finite(out)


def control_record(config: dict, traffic: dict, seed: int, device, rounds: int) -> Record:
    """The reference computed in TF32 in the program's place: its own rounds
    from the seed, recorded as the program's are."""
    model = ref_vision.ResNet(config)
    w0 = initial_flat(config, seed, device)
    cx, cy = client_data(config, traffic, seed, device)
    state = {"w_global": w0, "w_locals": w0.unsqueeze(0).repeat(config["clients"], 1), "b": traffic["b_init"]}
    key, rec = threefry.key(seed, device), Record()
    with ref_vision.precision(CONTROL):
        for _ in range(rounds):
            state, key, out = ref_vision.vision_round(model, state, key, cx, cy, traffic, watched(config, seed))
            rec.rounds.append({"loss": out["loss"], "b": state["b"], "theta": out["theta"],
                               "w_locals": state["w_locals"].to("cpu"), "w_global": state["w_global"].to("cpu"),
                               **{k: out[k] for k in ("before", "after", "first_step", "chain_w", "chain_m")}})
    return rec


def _get(tree: dict, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree
