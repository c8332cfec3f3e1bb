"""FedRF-TCA training protocol (paper Algorithm 5) on the card.

Port of ``repro.federated.protocol``: K source clients + 1 target client,
per-round client sampling S_t, the message-drop settings of Table III,
T_C-interval classifier aggregation, communication accounting and the
one-shot hard-voting variant of Appendix D.

Two data planes run the round body:

- ``engine="serial"``: per-client local steps from a Python loop.  With
  ``transport="wire"`` every message is really serialized by ``comm.wire``
  (numpy, host side) and the decoded arrays flow back into training.
- ``engine="batched"`` (default): ``federated.engine.BatchedRoundEngine``,
  all clients stacked on a leading K axis.  With a lossy codec over
  ``transport="wire"`` the codecs' round trips run on the stacked payloads;
  the quantizing codecs launch the K10 kernel.

Identical math when every client participates; under random drops the two
planes consume client batch streams at different offsets.  The protocol
itself (plans, accounting) stays host-side Python in both planes.

Randomness: the shared initial parameters, the channel's stochastic-rounding
uniforms and the seed-replay W_RF come from ``torch.Generator``s seeded from
``proto.seed`` (not the reference's ``jax.random`` streams);
``convert.load_reference_params`` starts a trainer from the reference's
parameters.  Plans, batches and the serial wire's rounding draws are numpy
streams and equal the reference's.

Fleet scale (``fleet``): ``topology`` routes every merge of the batched
engine through the two-tier edge -> server split (clients uplink to their
edge at the tier-1 codecs, each active edge ships one merged uplink per kind
at the tier-2 ``edge_codec``), and ``ingress_bytes`` tracks the server-ingress
leg that collapses from K to E messages; ``client_chunk`` bounds the
per-client working set.  Robustness (``robust``): ``rule`` owns every
weighted merge of the batched engine; ``faults`` corrupts the stacked uplinks
(batched) or the serialized frames (serial, ``transport="wire"``).

The asynchronous runtime (``repro_torch.fedsim.AsyncScheduler``) drives the
batched engine's ``flush`` through three hooks that draw from the same
streams as a round, in the same order: :meth:`FedRFTCATrainer.
draw_client_dispatch`, :meth:`~FedRFTCATrainer.draw_target_steps` and
:meth:`~FedRFTCATrainer.target_message`.

Observability (``obs``): with ``probe=True`` the batched engine returns its
health probes beside each round or flush, and the trainer emits them one
step late (:meth:`FedRFTCATrainer.stash_probes`): a round's probes are
copied to the host after the next round has been enqueued, so the copy does
not sit between two rounds.  The serial plane's steps are wrapped in the
sentinels ``serial.src_step_mmd``, ``serial.src_step_plain``,
``serial.tgt_step`` and ``serial.msg_of``; they count one signature per
client batch width, so they inform and are never gated.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import ckpt
from repro_torch.comm import autocodec, netsim, wire
from repro_torch.comm import transport as comm_transport
from repro_torch.data.domains import Domain, batches
from repro_torch.device import resolve_device
from repro_torch.federated import aggregation, network
from repro_torch.federated.engine import BatchedRoundEngine, local_step
from repro_torch.federated.model import (
    ClientConfig,
    accuracy,
    client_message,
    init_params,
    logits_of,
    make_omega,
    source_loss,
    target_loss,
    w_rf_key,
)
from repro_torch.obs import sentinel
from repro_torch.optim import adam
from repro_torch.robust import ByteFaultInjector, build_fault_plan, get_rule
from repro_torch.utils.tree import stack_trees, tree_map, tree_mean, unstack_tree


@dataclass
class ProtocolConfig:
    n_rounds: int = 200
    t_c: int = 50  # classifier aggregation interval T_C
    local_steps: int = 1
    # a scalar, or one size per source client; each capped at the client's n_k
    batch_size: int | tuple[int, ...] = 64
    message_batch_size: int | tuple[int, ...] = 256
    lr: float = 1e-2
    drop_setting: str = "I"  # Table III: "I" | "II" | "III"
    aggregate_w_rf: bool = True
    aggregate_classifier: bool = True  # False => one-shot hard voting at eval
    exchange_messages: bool = True  # False => ablation "without Sigma ell" (Fig. 5)
    warmup_rounds: int = 100  # FedAvg warm-up, CE only (emulated pretraining)
    engine: str = "batched"  # "batched" | "serial"
    # -- communication --------------------------------------------------------
    transport: str = "identity"  # "identity" | "wire"
    codec: str = "float32"  # default payload codec; "seed_replay" = O(1) W_RF
    codec_moments: str | None = None
    codec_w_rf: str | None = None
    codec_classifier: str | None = None
    scenario: Any = None  # comm.netsim.Scenario; None -> TableIII(drop_setting)
    # -- fleet scale (fleet): a fleet.Topology turns on the two-tier merges
    # (batched engine only), at the tier-2 ``edge_codec`` (default ``codec``);
    # ``client_chunk`` runs the per-client vmap chunk rows at a time
    topology: Any = None
    edge_codec: str | None = None
    client_chunk: int | None = None
    # -- robustness (robust): "mean" | "finite_mean" | "norm_clip[:c]" |
    # "trimmed_mean[:b]" | "geomedian[:iters]" or an AggregationRule (robust
    # rules need the batched engine); ``faults`` a robust.FaultConfig
    rule: Any = "mean"
    faults: Any = None
    # the batched engine's health probes (``trainer.last_probes``), emitted
    # into the active metrics registry one round late
    probe: bool = False
    seed: int = 0


def _per_client_sizes(value, k: int, caps: list[int], what: str) -> list[int]:
    """A scalar-or-per-client batch size -> K sizes, each capped at n_k."""
    if isinstance(value, int):
        sizes = [value] * k
    else:
        sizes = [int(s) for s in value]
        if len(sizes) != k:
            raise ValueError(f"{what} has {len(sizes)} entries for {k} clients")
    if any(s <= 0 for s in sizes):
        raise ValueError(f"{what} entries must be positive, got {sizes}")
    return [min(s, c) for s, c in zip(sizes, caps)]


def _cycle_pad(x: np.ndarray, y: np.ndarray | None, width: int):
    """Pad a (p, b_k) batch to ``width`` columns by cycling its own samples
    (zero columns would give the unit-norm layer a NaN gradient; the padding
    is masked out of every loss and moment)."""
    idx = np.arange(width) % x.shape[1]
    return x[:, idx], (None if y is None else y[idx])


def _ragged_mask(sizes: list[int], width: int) -> np.ndarray | None:
    """(K, width) 0/1 validity mask, or None when every client is full-width."""
    if not sizes or all(s == width for s in sizes):
        return None
    m = np.zeros((len(sizes), width), np.float32)
    for i, s in enumerate(sizes):
        m[i, :s] = 1.0
    return m


def _clone(tree):
    return tree_map(torch.clone, tree)


class FedRFTCATrainer:
    def __init__(self, sources: list[Domain], target: Domain, cfg: ClientConfig,
                 proto: ProtocolConfig, *, device=None):
        if proto.engine not in ("serial", "batched"):
            raise ValueError(f"unknown engine {proto.engine!r}")
        self.device = resolve_device(device)
        engine = proto.engine if sources else "serial"
        self.sources, self.target = sources, target
        self.cfg, self.proto = cfg, proto
        self.k = len(sources)
        self.rule = get_rule(proto.rule)
        self._chan_seed = proto.seed ^ 0x5EED
        self._fault_plan = build_fault_plan(proto.faults, self.k, seed=self._chan_seed)
        if engine != "batched":
            if not self.rule.is_mean:
                raise ValueError(f"rule={self.rule.name!r} runs on the stacked uplinks and "
                                 "needs the batched engine")
            if self._fault_plan is not None and proto.transport != "wire":
                raise ValueError("serial fault injection corrupts real frames and needs "
                                 "transport='wire'; value-level faults need the batched engine")
        self.topology = proto.topology
        if self.topology is not None:
            if engine != "batched":
                raise ValueError("fleet topology needs the batched engine")
            if self.topology.n_clients != self.k:
                raise ValueError(f"topology covers {self.topology.n_clients} clients, "
                                 f"trainer has {self.k}")
        self.omega = make_omega(cfg, device=self.device)
        codec = proto.codec
        if isinstance(codec, str) and codec.startswith("auto:"):
            codec = autocodec.resolve(codec)
        self.resolved_codec = codec
        self.transport = comm_transport.build_transport(
            proto.transport, codec, seed=proto.seed, codec_moments=proto.codec_moments,
            codec_w_rf=proto.codec_w_rf, codec_classifier=proto.codec_classifier,
        )
        if self._fault_plan is not None and engine != "batched":
            # serial wire plane: faults are byte corruption of real frames,
            # which the CRC32 check turns into reject, retransmit or drop
            self.transport.fault_injector = ByteFaultInjector.from_config(proto.faults)
        self.scenario = proto.scenario or netsim.TableIIIScenario(proto.drop_setting)
        self._frozen_w = self.transport.frozen_w
        f32 = np.dtype(np.float32)
        self._specs = {
            "moments": {"msg": ((2 * cfg.n_rff,), f32)},
            "w_rf": {"w_rf": ((2 * cfg.n_rff, cfg.m), f32)},
            "classifier": {"w": ((cfg.m, cfg.n_classes), f32), "b": ((cfg.n_classes,), f32)},
        }
        # the tier-2 (edge -> server) transport: one merged uplink per active
        # edge and kind, the partial merge plus the mass it reports
        if self.topology is not None:
            edge_codec = proto.edge_codec or codec
            if edge_codec == "seed_replay" and codec != "seed_replay":
                raise ValueError("edge_codec='seed_replay' requires the frozen-W protocol "
                                 "(codec='seed_replay')")
            self.edge_transport = comm_transport.build_transport(
                proto.transport, edge_codec, seed=proto.seed ^ 0x0ED6E)
            self._edge_specs = {kind: {**spec, "mass": ((1,), f32)}
                                for kind, spec in self._specs.items()}
        else:
            self.edge_transport, self._edge_specs = None, None
        self.ingress_bytes = {"moments": 0, "w_rf": 0, "classifier": 0}
        # every client fine-tunes the SAME initial model (paper Fig. 1)
        shared = init_params(cfg, proto.seed, device=self.device)
        self._w_key_data = w_rf_key(proto.seed)  # the seed-replay W_RF payload
        self._w_init = shared["w_rf"]
        src_params = [_clone(shared) for _ in range(self.k)]
        self.tgt_params = _clone(shared)
        self.opt = adam(proto.lr)
        self.tgt_opt = self.opt.init(self.tgt_params)
        self.rng = np.random.default_rng(proto.seed)
        self.model_version = 0
        self.client_versions = np.zeros(self.k, dtype=np.int64)
        # the probes' one-step pipeline: the last emitted (host numpy) and the
        # queued (plane, device tensors) of the latest round or flush
        self._last_probes: dict | None = None
        self._pending_probes: tuple[str, dict] | None = None
        self._build_serial_planes()
        client_ns = [d.x.shape[1] for d in sources]
        self._batch_sizes = _per_client_sizes(proto.batch_size, self.k, client_ns, "batch_size")
        self._msg_sizes = _per_client_sizes(proto.message_batch_size, self.k, client_ns,
                                            "message_batch_size")
        tgt_b = proto.batch_size if isinstance(proto.batch_size, int) else max(proto.batch_size)
        tgt_mb = (proto.message_batch_size if isinstance(proto.message_batch_size, int)
                  else max(proto.message_batch_size))
        self.src_iters = [batches(d.x, d.y, self._batch_sizes[i], seed=proto.seed + i)
                          for i, d in enumerate(sources)]
        self.tgt_iter = batches(target.x, target.y, min(tgt_b, target.x.shape[1]),
                                seed=proto.seed + 777)
        self.comm = self.transport.log
        self._msg_iters = [batches(d.x, d.y, self._msg_sizes[i], seed=proto.seed + 500 + i)
                           for i, d in enumerate(sources)]
        self._tgt_msg_iter = batches(target.x, target.y, min(tgt_mb, target.x.shape[1]),
                                     seed=proto.seed + 999)
        self._b_max = max(self._batch_sizes, default=0)
        self._mb_max = max(self._msg_sizes, default=0)
        self._bmask = self._dev(_ragged_mask(self._batch_sizes, self._b_max))
        self._msg_mask = self._dev(_ragged_mask(self._msg_sizes, self._mb_max))
        if engine == "batched":
            self._engine = BatchedRoundEngine(
                cfg, self.opt, self.omega, exchange_messages=proto.exchange_messages,
                aggregate_w_rf=proto.aggregate_w_rf,
                aggregate_classifier=proto.aggregate_classifier, freeze_w_rf=self._frozen_w,
                channel=self.transport.channel_fns(), channel_seed=self._chan_seed,
                topology=self.topology,
                edge_channel=self.edge_transport.channel_fns() if self.edge_transport else None,
                client_chunk=proto.client_chunk, rule=self.rule, faults=self._fault_plan,
                probe=proto.probe,
            )
            self._src_stack = stack_trees(src_params)
            self._src_opt_stack = stack_trees([self.opt.init(p) for p in src_params])
            self.src_params, self.src_opt = None, None
        else:
            self._engine = None
            self.src_params = src_params
            self.src_opt = [self.opt.init(p) for p in src_params]
        if proto.warmup_rounds:
            self._warmup(proto.warmup_rounds)
        if self._frozen_w:
            self._pin_w_rf()

    def _dev(self, a):
        return None if a is None else torch.as_tensor(a, device=self.device)

    def _pin_w_rf(self) -> None:
        """Frozen-W invariant: every W_RF is bit for bit the shared init
        (a warm-up FedAvg of K identical matrices can drift by one ULP)."""
        if self._engine is not None:
            self._src_stack["w_rf"] = self._w_init.expand(self._src_stack["w_rf"].shape).clone()
        else:
            for p in self.src_params:
                p["w_rf"] = self._w_init
        self.tgt_params["w_rf"] = self._w_init

    def _src_param(self, i: int):
        if self._engine is not None:
            return unstack_tree(self._src_stack, i)
        return self.src_params[i]

    # ---- serial-plane local steps -------------------------------------------
    def _build_serial_planes(self) -> None:
        """The serial plane's four steps as functions of their arguments, each
        wrapped in its sentinel (``serial.*``, informative: ragged clients
        step at their own batch widths)."""
        cfg, omega, opt, frozen = self.cfg, self.omega, self.opt, self._frozen_w

        def src_step_mmd(params, opt_state, x, y, tgt_msg):
            return local_step(opt, lambda p: source_loss(p, omega, x, y, tgt_msg, cfg),
                              params, opt_state, freeze_w_rf=frozen)

        def src_step_plain(params, opt_state, x, y):
            zeros = torch.zeros((2 * cfg.n_rff,), device=self.device)
            return local_step(opt, lambda p: source_loss(p, omega, x, y, zeros, cfg,
                                                         with_mmd=False),
                              params, opt_state, freeze_w_rf=frozen)

        def tgt_step(params, opt_state, x, src_msgs):
            return local_step(opt, lambda p: target_loss(p, omega, x, src_msgs, cfg),
                              params, opt_state, freeze_w_rf=frozen)

        @torch.no_grad()
        def msg_of(params, x, sign: float) -> torch.Tensor:
            return client_message(params, omega, self._dev(x), sign)

        self._src_step_mmd = sentinel.wrap("serial.src_step_mmd", src_step_mmd)
        self._src_step_plain = sentinel.wrap("serial.src_step_plain", src_step_plain)
        self._tgt_step_plane = sentinel.wrap("serial.tgt_step", tgt_step)
        self._msg_of = sentinel.wrap("serial.msg_of", msg_of)

    def _src_step(self, i: int, x, y, tgt_msg=None) -> None:
        """One step of source i: CE + lambda MMD against ``tgt_msg``, or CE
        alone when ``tgt_msg`` is None (Alg. 2)."""
        x, y = self._dev(x), self._dev(y).long()
        p, o = self.src_params[i], self.src_opt[i]
        if tgt_msg is None:
            self.src_params[i], self.src_opt[i] = self._src_step_plain(p, o, x, y)
        else:
            self.src_params[i], self.src_opt[i] = self._src_step_mmd(p, o, x, y, tgt_msg)

    def _tgt_step(self, x, src_msgs) -> None:
        self.tgt_params, self.tgt_opt = self._tgt_step_plane(self.tgt_params, self.tgt_opt,
                                                             self._dev(x), src_msgs)

    # ---- warm-up (emulated pretraining: FedAvg, CE only, whole model) --------
    def _warmup(self, rounds: int) -> None:
        if rounds <= 0 or self.k == 0:
            return
        if self._engine is not None:
            xs, ys = self._draw_source_batches(rounds)
            self._src_stack, self._src_opt_stack = self._engine.warmup(
                self._src_stack, self._src_opt_stack, xs, ys, self._bmask)
            self.tgt_params = _clone(unstack_tree(self._src_stack, 0))
            return
        avg = None
        for _ in range(rounds):
            for i in range(self.k):
                for _ in range(self.proto.local_steps):
                    self._src_step(i, *next(self.src_iters[i]))
            avg = aggregation.fedavg_models(self.src_params)
            self.src_params = [_clone(avg) for _ in range(self.k)]
        self.tgt_params = _clone(avg)

    # ---- host-side batch plumbing --------------------------------------------
    def _draw_source_batches(self, rounds: int):
        """(R, L, K, p, b_max) x / (R, L, K, b_max) y in the serial plane's
        consumption order (each client's stream yields R*L batches)."""
        L = self.proto.local_steps
        xs = np.zeros((rounds, L, self.k, self.sources[0].x.shape[0], self._b_max), np.float32)
        ys = np.zeros((rounds, L, self.k, self._b_max), np.int64)
        for r in range(rounds):
            for i in range(self.k):
                for s in range(L):
                    x, y = next(self.src_iters[i])
                    xs[r, s, i], ys[r, s, i] = _cycle_pad(x, y, self._b_max)
        return self._dev(xs), self._dev(ys)

    def _round_batch(self) -> dict:
        """One round's batches for the batched engine: every client's
        dispatch draws, stacked on the K axis."""
        draws = [self.draw_client_dispatch(i) for i in range(self.k)]
        xs, ys = (np.stack([d[j] for d in draws], axis=1) for j in (0, 1))
        x_msg = np.stack([d[2] for d in draws])
        xt_steps = self.draw_target_steps()
        xt_msg = next(self._tgt_msg_iter)[0]
        return {"xs": self._dev(xs), "ys": self._dev(ys), "x_msg": self._dev(x_msg),
                "xt_steps": self._dev(xt_steps), "xt_msg": self._dev(xt_msg),
                "bmask": self._bmask, "msg_mask": self._msg_mask}

    # ---- the draws of a round and of the async runtime -----------------------
    # The async runtime (repro_torch.fedsim.AsyncScheduler) draws each client's
    # batches at its dispatch and the target's at each flush; a round draws
    # them all at once through the same two functions.  Each client's stream
    # is its own iterator, so a no-churn, uniform-latency async run consumes
    # the same batches as the rounds.

    def draw_client_dispatch(self, i: int):
        """Client i's dispatch draws, host numpy: (L, p, b_max) / (L, b_max)
        training batches and the (p, mb_max) message batch, cycle-padded like
        :meth:`_round_batch`."""
        L, p = self.proto.local_steps, self.sources[0].x.shape[0]
        xs = np.zeros((L, p, self._b_max), np.float32)
        ys = np.zeros((L, self._b_max), np.int64)
        for s in range(L):
            x, y = next(self.src_iters[i])
            xs[s], ys[s] = _cycle_pad(x, y, self._b_max)
        x_msg, _ = _cycle_pad(next(self._msg_iters[i])[0], None, self._mb_max)
        return xs, ys, x_msg

    def draw_target_steps(self) -> np.ndarray:
        """(L, p, b) target training batches for one flush (host numpy)."""
        return np.stack([next(self.tgt_iter)[0] for _ in range(self.proto.local_steps)])

    @torch.no_grad()
    def target_message(self, chan_key=None) -> torch.Tensor:
        """The target's Sigma-ell broadcast at the current parameters, what
        the server hands a client at dispatch, through the moments codec of
        the batched engine's channel when one is set (K10 under the qint
        codecs).  ``chan_key`` keys its uniforms (the scheduler passes
        ``(0x00A5, d)`` for its d-th dispatch; ``channel_uniforms``)."""
        msg = self._msg_of(self.tgt_params, next(self._tgt_msg_iter)[0], -1.0)
        if self._engine is None or self._engine.channel.get("moments") is None:
            return msg
        if chan_key is None:
            raise ValueError("channel distortion is set: pass a chan_key")
        return self._engine._channel("moments", msg[None], chan_key, (), single=True)[0]

    def _mask_of(self, ids: list[int]) -> torch.Tensor:
        m = np.zeros((self.k,), np.float32)
        m[list(ids)] = 1.0
        return self._dev(m)

    # ---- communication accounting (analytic; exact by wire.serialized_size) --
    def account_ingress(self, kind: str, members) -> None:
        """Server-ingress leg of one round's ``kind`` uplinks.  Flat plane:
        every participating client's message at the tier-1 codec.  Two-tier:
        one merged uplink (partial merge plus mass) per active edge at the
        tier-2 ``edge_codec``, recorded in the edge transport's log."""
        members = list(members)
        if not members:
            return
        if self.topology is None:
            nbytes = wire.serialized_size(kind, self._specs[kind], self.transport.codecs[kind])
            total, tier = len(members) * nbytes, "flat"
        else:
            edges = self.topology.edges_of(members)
            self.edge_transport.account_spec(kind, self._edge_specs[kind], count=len(edges))
            nbytes = wire.serialized_size(kind, self._edge_specs[kind],
                                          self.edge_transport.codecs[kind])
            total, tier = len(edges) * nbytes, "edge"
        self.ingress_bytes[kind] += total
        obs.metrics().counter("fleet.ingress_bytes").inc(total, kind=kind, tier=tier)

    def _account_comm(self, plan: network.RoundPlan, t: int) -> None:
        """Bytes and floats of the planes whose exchange is in-graph (identity
        transport, batched engine); the serial wire plane accounts in
        ``Transport.transfer`` with the same counts and sizes."""
        proto, tr = self.proto, self.transport
        if proto.exchange_messages and plan.msg_clients:
            tr.account_spec("moments", self._specs["moments"], count=1 + len(plan.msg_clients))
            self.account_ingress("moments", plan.msg_clients)
        if proto.aggregate_w_rf and plan.w_clients:
            tr.account_spec("w_rf", self._specs["w_rf"], count=len(plan.w_clients) + 1)
            self.account_ingress("w_rf", plan.w_clients)
        if proto.aggregate_classifier and t % proto.t_c == 0 and plan.c_clients:
            tr.account_spec("classifier", self._specs["classifier"], count=len(plan.c_clients))
            self.account_ingress("classifier", plan.c_clients)

    # ---- one communication round (Alg. 5 body) -------------------------------
    def round(self, t: int) -> dict[str, Any]:
        return self.run_round(t, self.scenario.plan(self.rng, self.k, t))

    def run_round(self, t: int, plan: network.RoundPlan) -> dict[str, Any]:
        """One round under an externally supplied plan."""
        if self._engine is not None:
            self._round_batched(t, plan)
            self._account_comm(plan, t)
        else:
            self._round_serial(t, plan)
            if not self.transport.applies_values:
                self._account_comm(plan, t)
        obs.metrics().counter("fed.rounds").inc(engine=self.proto.engine)
        self.comm.rounds += 1
        self.model_version += 1
        obs.metrics().gauge("fed.model_version").set(self.model_version)
        if plan.w_clients:
            self.client_versions[list(plan.w_clients)] = self.model_version
        return {"plan": plan}

    # ---- health probes: emitted one step late -------------------------------
    def stash_probes(self, plane: str, probes: dict) -> None:
        """Queue a round's or flush's probes (device tensors) for emission,
        first emitting whatever was queued before: by the time the next round
        is enqueued the previous one's probes are ready, so their copy to the
        host does not hold the card between two rounds."""
        self.flush_probes()
        self._pending_probes = (plane, probes)

    def flush_probes(self) -> dict | None:
        """Drain the pipeline: copy and emit any queued probes."""
        if self._pending_probes is not None:
            plane, dev = self._pending_probes
            self._pending_probes = None
            self._last_probes = obs.emit_probes(dev, plane=plane)
        return self._last_probes

    @property
    def last_probes(self) -> dict | None:
        """The latest round's or flush's probes as host numpy (drains the queue)."""
        return self.flush_probes()

    def _round_batched(self, t: int, plan: network.RoundPlan) -> None:
        masks = {
            "mmd": self._mask_of(plan.msg_clients if self.proto.exchange_messages else []),
            "w": self._mask_of(plan.w_clients),
            "c": self._mask_of(plan.c_clients),
            "do_clf": t % self.proto.t_c == 0,
        }
        out = self._engine.round(
            self._src_stack, self._src_opt_stack, self.tgt_params, self.tgt_opt,
            self._round_batch(), masks, chan_key=t)
        self._src_stack, self._src_opt_stack, self.tgt_params, self.tgt_opt = out[:4]
        if self._engine.probe:
            self.stash_probes("round", out[4])

    def _round_serial(self, t: int, plan: network.RoundPlan) -> None:
        proto = self.proto
        # wiretx: every message is serialized and parsed; the decoded (possibly
        # codec-distorted) arrays flow back into training
        wiretx = self.transport if self.transport.applies_values else None
        xt, _ = next(self._tgt_msg_iter)
        tgt_msg = self._msg_of(self.tgt_params, xt, -1.0)
        downlink_ok = True
        if wiretx and proto.exchange_messages and plan.msg_clients:
            arrs = wiretx.transfer(wire.moments_message(tgt_msg, sender=-1, round=t,
                                                        downlink=True))
            if arrs is None:
                downlink_ok = False
            else:
                tgt_msg = self._dev(arrs["msg"])

        # local source training (Alg. 2)
        src_msgs = {}
        for i in range(self.k):
            mmd = proto.exchange_messages and i in plan.msg_clients and downlink_ok
            for _ in range(proto.local_steps):
                x, y = next(self.src_iters[i])
                self._src_step(i, x, y, tgt_msg if mmd else None)
            if proto.exchange_messages and i in plan.msg_clients:
                xm, _ = next(self._msg_iters[i])
                msg = self._msg_of(self.src_params[i], xm, +1.0)
                if wiretx:
                    arrs = wiretx.transfer(wire.moments_message(msg, sender=i, round=t))
                    if arrs is None:
                        continue  # retry budget exhausted: an undelivered uplink
                    msg = self._dev(arrs["msg"])
                src_msgs[i] = msg

        # local target training (Alg. 3)
        if proto.exchange_messages and src_msgs:
            msgs = torch.stack(list(src_msgs.values()))
            for _ in range(proto.local_steps):
                xt, _ = next(self.tgt_iter)
                self._tgt_step(xt, msgs)

        # global aggregation (Alg. 4)
        if proto.aggregate_w_rf and plan.w_clients:
            if self._frozen_w:
                # seed-replay sync: the "upload" is the O(1) key; one real
                # transfer proves the decode, the rest are accounted
                if wiretx:
                    decoded = wiretx.transfer(wire.w_rf_message(
                        self._w_init, sender=plan.w_clients[0], round=t,
                        replay=("w_rf_init", self._w_key_data)))
                    wiretx.account_spec("w_rf", self._specs["w_rf"], count=len(plan.w_clients))
                    if decoded is not None:
                        self.tgt_params["w_rf"] = self._dev(np.array(decoded["w_rf"]))
            elif wiretx:
                ws = []
                for i in plan.w_clients:
                    arrs = wiretx.transfer(wire.w_rf_message(self.src_params[i]["w_rf"],
                                                             sender=i, round=t))
                    if arrs is not None:
                        ws.append(self._dev(arrs["w_rf"]))
                arrs = wiretx.transfer(wire.w_rf_message(self.tgt_params["w_rf"], sender=-1,
                                                         round=t))
                if arrs is not None:
                    ws.append(self._dev(arrs["w_rf"]))
                if ws:
                    w_rf = tree_mean(ws)
                    for i in plan.w_clients:
                        self.src_params[i]["w_rf"] = w_rf
                    self.tgt_params["w_rf"] = w_rf
            else:
                w_rf = aggregation.fedavg_w_rf(self.src_params, self.tgt_params, plan.w_clients)
                for i in plan.w_clients:
                    self.src_params[i]["w_rf"] = w_rf
                self.tgt_params["w_rf"] = w_rf

        if proto.aggregate_classifier and t % proto.t_c == 0 and plan.c_clients:
            if wiretx:
                clfs = [
                    wiretx.transfer_delta(
                        wire.classifier_message(self.src_params[i]["classifier"], sender=i,
                                                round=t),
                        link=f"clf-up-{i}")
                    for i in plan.c_clients
                ]
                clfs = [tree_map(self._dev, c) for c in clfs if c is not None]
                clf = tree_mean(clfs) if clfs else None
            else:
                clf = aggregation.fedavg_classifier(self.src_params, plan.c_clients)
            if clf is not None:
                for i in plan.c_clients:
                    self.src_params[i]["classifier"] = clf
                self.tgt_params["classifier"] = clf

    def train(self, eval_every: int = 0) -> list[float]:
        accs = []
        for t in range(1, self.proto.n_rounds + 1):
            self.round(t)
            if eval_every and t % eval_every == 0:
                accs.append(self.evaluate())
        self.flush_probes()
        return accs

    # ---- checkpoint / restore --------------------------------------------------
    def _array_state(self):
        tree = {"tgt_params": self.tgt_params, "tgt_opt": self.tgt_opt,
                "client_versions": self.client_versions}
        if self._engine is not None:
            tree["src"] = {"params": self._src_stack, "opt": self._src_opt_stack}
        else:
            tree["src"] = {"params": self.src_params, "opt": self.src_opt}
        return tree

    def _iterators(self):
        return [*self.src_iters, self.tgt_iter, *self._msg_iters, self._tgt_msg_iter]

    def save_state(self, path: str, *, step: int | None = None, keep: int = 3) -> str:
        """Checkpoint the trainer: arrays into the npz (the reference's
        layout), the host-side randomness (scenario rng, batch iterators) into
        a ``<ckpt>.host.json`` sidecar.  Returns the npz path."""
        target = ckpt.save(path, self._array_state(), step=step, keep=keep)
        host = {"rng": self.rng.bit_generator.state,
                "iters": [it.state() for it in self._iterators()],
                "model_version": int(self.model_version)}
        with open(target + ".host.json", "w") as f:
            json.dump(host, f)
        return target

    def restore_state(self, path: str) -> None:
        """Inverse of :meth:`save_state` (an npz path or a checkpoint
        directory).  Comm accounting is not rolled back."""
        if os.path.isdir(path):
            found = ckpt.latest(path)
            if found is None:
                raise FileNotFoundError(f"no checkpoints in {path}")
            path = found
        tree = ckpt.restore(path, self._array_state())
        self.tgt_params, self.tgt_opt = tree["tgt_params"], tree["tgt_opt"]
        self.client_versions = np.asarray(tree["client_versions"])
        if self._engine is not None:
            self._src_stack, self._src_opt_stack = tree["src"]["params"], tree["src"]["opt"]
        else:
            self.src_params, self.src_opt = tree["src"]["params"], tree["src"]["opt"]
        with open(path + ".host.json") as f:
            host = json.load(f)
        self.rng.bit_generator.state = host["rng"]
        for it, st in zip(self._iterators(), host["iters"], strict=True):
            it.set_state(st)
        self.model_version = int(host["model_version"])

    # ---- evaluation -------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, x=None, y=None) -> float:
        """Aggregated-classifier accuracy on target data (the UFDA objective)."""
        x = self._dev(self.target.x if x is None else x)
        y = self._dev(self.target.y if y is None else y)
        if self.proto.aggregate_classifier:
            return float(accuracy(self.tgt_params, self.omega, x, y))
        # one-shot hard voting (App. D): each source classifier votes
        per_src = []
        for i in range(self.k):
            p = {"extractor": self.tgt_params["extractor"], "w_rf": self.tgt_params["w_rf"],
                 "classifier": self._src_param(i)["classifier"]}
            per_src.append(logits_of(p, self.omega, x).cpu().numpy())
        preds = aggregation.hard_vote(np.stack(per_src))
        return float(np.mean(preds == y.cpu().numpy()))
