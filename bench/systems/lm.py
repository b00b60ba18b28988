"""The federated LM round of ``repro_torch.launch.fl_step`` as a cell.

The window drives the step that ``make_fl_train_step`` makes, as the
trainer (``repro_torch.launch.train``) calls it: one call a round on the
whole cohort's batch, with parameters, b and round keys that the
benchmark makes from the seed. Stage spans are CUDA events around the
calls into each layer (the model's forward and backward, the local
update, a client leaf's compression, a leaf's estimate).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .. import gen, work
from ..reference import lm as ref_lm
from ..reference import threefry
from .common import Record

CONTROL = "fp8"  # the precision below the configuration's bf16

def leaf_table(cfg: dict) -> list:
    """``(name, shape, init, scale, dtype)`` of every parameter leaf in the
    wire's leaf order (the tree's keys sorted): every matrix and the
    embedding ``normal(0, initializer_range)``, the norms' scales 1, the
    attention's biases 0. A tied model has no head leaf: its logits take
    the embedding's transpose."""
    L, d, ff, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    shapes = [
        ("blocks/0/ffn/w1", (L, d, ff), "normal"), ("blocks/0/ffn/w2", (L, ff, d), "normal"),
        ("blocks/0/ffn/w3", (L, d, ff), "normal"),
        ("blocks/0/mixer/bk", (L, kv, hd), "zeros"), ("blocks/0/mixer/bq", (L, h, hd), "zeros"),
        ("blocks/0/mixer/bv", (L, kv, hd), "zeros"),
        ("blocks/0/mixer/wk", (L, d, kv, hd), "normal"), ("blocks/0/mixer/wo", (L, h, hd, d), "normal"),
        ("blocks/0/mixer/wq", (L, d, h, hd), "normal"), ("blocks/0/mixer/wv", (L, d, kv, hd), "normal"),
        ("blocks/0/norm1/w", (L, d), "ones"), ("blocks/0/norm2/w", (L, d), "ones"),
        ("embed/embed", (v, d), "normal"), ("embed/head", (d, v), "normal"), ("final_norm/w", (d,), "ones"),
    ]
    if cfg["tie_word_embeddings"]:
        shapes = [s for s in shapes if s[0] != "embed/head"]
    return [(n, s, init, cfg["initializer_range"], torch.bfloat16) for n, s, init in shapes]


def program_config(cfg: dict):
    """The program's ModelConfig of the configuration file, refused when
    the architecture is not the dense GQA decoder the reference models."""
    from repro_torch import configs

    base = configs.get_config(cfg["arch"])
    out = dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=float(cfg["rms_norm_eps"]), qkv_bias=cfg["qkv_bias"],
        tie_embeddings=cfg["tie_word_embeddings"])
    plain = (out.family == "dense" and out.pattern == ("attn",) and out.ffn_act == "swiglu" and out.norm == "rmsnorm"
             and out.rope and out.causal and not out.sliding_window and out.frontend == "none" and not out.d_head
             and out.dtype == cfg["torch_dtype"])
    if not plain:
        raise ValueError(f"{cfg['name']}: the reference models a dense GQA decoder, not {out}")
    return out


def round_key(seed: int, r: int, device) -> torch.Tensor:
    return threefry.fold_in(threefry.key(seed, device), r)


class Cell:
    """One LM cell: the program's step, its state and the seed's inputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.core.aggregation import AggregatorPipeline, ClientCompressor
        from repro_torch.launch import fl_step
        from repro_torch.models import build_specs
        from repro_torch.models.spec import is_spec
        from repro_torch.tree import leaves_with_path, unflatten

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.table = leaf_table(config)
        self.names = [n for n, *_ in self.table]
        specs = build_specs(program_config(config))
        got = [("/".join(map(str, p)), tuple(s.shape)) for p, s in leaves_with_path(specs, is_leaf=is_spec)]
        if got != [(n, tuple(s)) for n, s, *_ in self.table]:
            raise ValueError(f"the program's parameter leaves {got} are not the configuration's")
        values = gen.normal_leaves(self.table, seed, self.device, "params")
        self.params = unflatten(specs, [values[n] for n in self.names], is_leaf=is_spec)
        del values
        fl = fl_step.DistFLConfig(clients_per_round=config["clients"], local_steps=traffic["local_steps"],
                                  lr=traffic["lr"], lam=traffic["lam"], aggregator=traffic["aggregator"],
                                  rand_bits=traffic["rand_bits"])
        self.step = fl_step.make_fl_train_step(program_config(config), fl)
        self.b = torch.tensor(traffic["b_init"], dtype=torch.float32, device=self.device)
        self.r = 0
        self.span_targets = [(fl_step, "_value_and_grad", "forward_backward"), (fl_step, "_local_step", "local_update"),
                             (ClientCompressor, "compress", "compress"), (AggregatorPipeline, "estimate", "estimate")]
        self._metrics = None
        self._losses = []

    # -- the window's call --------------------------------------------------
    def round(self) -> None:
        toks = _round_tokens(self.config, self.traffic, self.seed, self.r, self.device)[:, None]  # one pod
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        self.params, self.b, self._metrics = self.step(self.params, self.b, batch, round_key(self.seed, self.r,
                                                                                              self.device))
        self.r += 1

    @contextlib.contextmanager
    def watching(self):
        """Copy, without changing anything, each client's local loss at
        every step (the loss of each forward and backward, in call order:
        client after client, step after step)."""
        import unittest.mock as mock

        from repro_torch.launch import fl_step

        value_and_grad = fl_step._value_and_grad

        def seen(*args, **kwargs):
            loss, grads = value_and_grad(*args, **kwargs)
            self._losses.append(float(loss))
            return loss, grads

        self._losses = []
        with mock.patch.object(fl_step, "_value_and_grad", seen):
            yield

    def losses(self) -> list:
        return [float(self._metrics["loss_first"]), float(self._metrics["loss_last"])]

    def snapshot(self) -> dict:
        """The round's outputs for the check: losses, b and every leaf on the
        host."""
        from repro_torch.tree import leaves

        steps = self.traffic["local_steps"]
        client_losses = [self._losses[i:i + steps] for i in range(0, len(self._losses), steps)]
        self._losses = []
        return {"loss": self.losses(), "b": float(self.b), "client_losses": client_losses,
                "params": {n: w.detach().to("cpu") for n, w in zip(self.names, leaves(self.params))}}

    def free(self) -> None:
        self.params = self.step = self._metrics = None

    # -- the work of a round -------------------------------------------------
    def leaf_sizes(self) -> list:
        return [int(torch.Size(s).numel()) for _, s, *_ in self.table]

    def work(self) -> dict:
        m = self.config["clients"]
        t = self.traffic
        sequences = m * t["local_steps"] * t["per_batch"]
        b_len = int(self.b.numel())  # the trainer's b: one scalar for every leaf
        return {"compress": [(m, d) for d in self.leaf_sizes()], "b3": [(m, d, b_len) for d in self.leaf_sizes()],
                "b4": [], "model_flops": work.decoder_train_flops(self.config, sequences, t["seq"]),
                "peak_flops": work.PEAK_FLOPS[self.config["torch_dtype"]]}

    # -- faults planted under the window's call ------------------------------
    @contextlib.contextmanager
    def unchanged(self):
        """The step returns the parameters and b it was given."""
        step = self.step

        def frozen(params, b, batch, key):
            _, _, metrics = step(params, b, batch, key)
            return params, b, metrics

        self.step = frozen
        try:
            yield
        finally:
            self.step = step


NUMBERS = ("loss_gap", "b_gap", "change_norm_gap", "param_gap")


def _seed_state(config: dict, traffic: dict, seed: int, device):
    return gen.normal_leaves(leaf_table(config), seed, device, "params"), float(traffic["b_init"])


def _round_tokens(config: dict, traffic: dict, seed: int, r: int, device) -> torch.Tensor:
    shape = (config["clients"], traffic["local_steps"], traffic["per_batch"], traffic["seq"] + 1)
    return gen.lm_tokens(seed, r, shape, config["vocab_size"], device)


def check(config: dict, traffic: dict, seed: int, device, record: Record) -> dict:
    """The reference follows the record round by round (round 1 from the
    seed's parameters and b, each later round from the parameters and b the
    record reached) and is held to it, each number the worst over the
    rounds: ``loss_gap`` (every client's local loss at every step, and the
    reported cohort means), ``b_gap`` (b after the vote of the record's own
    client losses: the vote's arithmetic), ``change_norm_gap`` and
    ``param_gap`` (:func:`common.leaf_gaps` of the round's own change)."""
    from .common import finite, leaf_gaps, rel

    names = [n for n, *_ in leaf_table(config)]
    model = ref_lm.Decoder(config)
    params, b = _seed_state(config, traffic, seed, device)
    out = dict.fromkeys(NUMBERS, 0.0)
    for r, rec in enumerate(record.rounds):
        if r:
            prev = record.rounds[r - 1]
            params = {n: prev["params"][n].to(device) for n in names}
            b = prev["b"]
        new, losses = ref_lm.lm_round(model, params, names, b, _round_tokens(config, traffic, seed, r, device),
                                      round_key(seed, r, device), traffic["lr"], traffic["lam"])
        change, diff = leaf_gaps(rec["params"], new, params, device)
        got = rec["client_losses"]
        gaps = [rel(p, q) for row_p, row_q in zip(got, losses) for p, q in zip(row_p, row_q)]
        gaps += [rel(rec["loss"][0], ref_lm.mean32([c[0] for c in losses])),
                 rel(rec["loss"][1], ref_lm.mean32([c[-1] for c in losses]))]
        out["loss_gap"] = max([out["loss_gap"]] + gaps)
        b_vote = ref_lm.next_b(b, [c[0] for c in got], [c[-1] for c in got])
        out["b_gap"] = max(out["b_gap"], rel(rec["b"], b_vote))
        out["change_norm_gap"] = max(out["change_norm_gap"], change)
        out["param_gap"] = max(out["param_gap"], diff)
        del new, params
    return finite(out)


def control_record(config: dict, traffic: dict, seed: int, device, rounds: int) -> Record:
    """The reference computed in the precision below the configuration's,
    in the program's place: its own rounds from the seed, recorded as the
    program's are."""
    names = [n for n, *_ in leaf_table(config)]
    model = ref_lm.Decoder(config, CONTROL)
    params, b = _seed_state(config, traffic, seed, device)
    rec = Record()
    for r in range(rounds):
        params, losses = ref_lm.lm_round(model, params, names, b, _round_tokens(config, traffic, seed, r, device),
                                         round_key(seed, r, device), traffic["lr"], traffic["lam"])
        b = ref_lm.next_b(b, [c[0] for c in losses], [c[-1] for c in losses])
        rec.rounds.append({"loss": [ref_lm.mean32([c[0] for c in losses]), ref_lm.mean32([c[-1] for c in losses])],
                           "b": b, "client_losses": losses, "params": {n: params[n].to("cpu") for n in names}})
    return rec
