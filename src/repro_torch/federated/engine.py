"""Batched federated round engine: every client of a round in one stacked pass.

Port of ``repro.federated.engine``.  The serial plane (``protocol.py``)
steps each client from a Python loop; this engine runs the same round body
(Alg. 5) on parameters stacked along a leading K axis:

- per-client parameters and Adam states are trees of (K, ...) tensors;
- source local steps run under ``torch.func.vmap`` over
  ``torch.func.grad_and_value`` of the loss, and a Python loop takes the
  place of the reference's ``lax.scan`` over local steps and rounds;
- the round's drop plan (Table III) enters as 0/1 mask tensors: the MMD
  term is gated per client, dropped messages carry zero weight in the target
  loss, and every assign-back is a ``torch.where``, so parameters AND Adam
  states of clients outside a merge stay as they were;
- ragged clients are padded to the widest batch and masked (``bmask``,
  ``msg_mask``), so every mean and moment runs over true samples only.

The wire enters as the lossy codecs of ``comm`` (``channel``): each codec's
``roundtrip`` distorts a whole stack of payloads at once.  For the
quantizing codecs that is ONE launch of the K10 kernel per payload kind
(the K source moments; the K + 1 W_RF uplinks; each classifier leaf on
T_C rounds), with one absmax scale per row, where the reference vmaps its
per-tensor round trip over the client axis.  Every uniform of the channel is drawn by
:meth:`BatchedRoundEngine.channel_uniforms`, one function, so a test can put
the reference's own ``jax.random`` uniforms in its place.

Fleet scale (``fleet``): with a ``topology`` every merge routes through the
two-tier edge -> server split of ``fleet.hierarchy`` (grouped partial sums
and masses, one K9 launch per merge on the card; the tier-2 ``edge_channel``
codecs on the edge uplinks, their uniforms under paths (4,), (5,) and
(6, i)), and ``client_chunk`` runs the per-client ``vmap`` ``chunk`` rows at
a time (``fleet.sharding.chunked_vmap``).  Robustness (``robust``): the
``rule`` owns every weighted merge, and a ``faults`` plan corrupts the
stacked uplinks after the channel (its draws under paths (7,), (8,), (9,)).

Besides the round, the engine runs the asynchronous runtime's data plane
(:meth:`BatchedRoundEngine.flush`, driven by ``fedsim.AsyncScheduler``): a
FedBuff-style buffered aggregation in which only the buffered clients keep
their local steps, each against the target broadcast of its own dispatch,
and every merge is weighted by ``buf * weights`` (staleness).  It goes
through the same merge methods as the round, so the two-tier plane (K9),
the robust rule and the fault plan apply to it unchanged.

Observability: with ``probe=True`` the round and the flush also return a
dict of health probes computed beside the merges (``moment_mass``,
``attribution_moments``, ``attribution_w_rf``, per-client ``update_norm``,
``tgt_update_norm``; ``obs.probes`` brings them to the host).  They never
feed back into the parameters, so a probed run is bit for bit an unprobed
one.  ``round``, ``flush`` and ``warmup`` are wrapped in the sentinels
``engine.round``, ``engine.flush`` and ``engine.warmup`` (``obs.sentinel``:
one argument signature each in a stable run).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.federated.model import ClientConfig, client_message, source_loss, target_loss
from repro_torch.fleet import hierarchy
from repro_torch.fleet.sharding import chunked_vmap
from repro_torch.kernels.segment_reduce import membership_plan
from repro_torch.obs import sentinel
from repro_torch.optim import apply_updates
from repro_torch.robust.rules import MeanRule
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like, tree_where


_MASS_EPS = 1e-12


def client_delta_norms(new, old) -> torch.Tensor:
    """Per-client L2 norm of a stacked parameter tree's delta: (K,)."""
    sq = sum(torch.sum((a - b) ** 2, dim=tuple(range(1, a.ndim)))
             for a, b in zip(tree_leaves(new), tree_leaves(old)))
    return torch.sqrt(sq)


def tree_delta_norm(new, old) -> torch.Tensor:
    """Whole-tree L2 norm of a parameter delta: () scalar."""
    return torch.sqrt(sum(torch.sum((a - b) ** 2)
                          for a, b in zip(tree_leaves(new), tree_leaves(old))))


def local_step(opt, loss_fn, p, o, *, freeze_w_rf: bool = False):
    """One optimizer step of ``loss_fn(params) -> (loss, aux)`` on one
    client's parameters ``p`` and state ``o``.  A frozen W_RF gets a zero
    gradient: the reference's ``stop_gradient`` on a leaf, so its Adam
    update is exactly 0."""
    grads, _ = grad_and_value(loss_fn, has_aux=True)(p)
    if freeze_w_rf:
        grads = {**grads, "w_rf": torch.zeros_like(grads["w_rf"])}
    upd, o = opt.update(grads, o, p)
    return apply_updates(p, upd), o


class BatchedRoundEngine:
    """The stacked data plane of ``FedRFTCATrainer``."""

    def __init__(
        self,
        cfg: ClientConfig,
        opt,
        omega: torch.Tensor,
        *,
        exchange_messages: bool = True,
        aggregate_w_rf: bool = True,
        aggregate_classifier: bool = True,
        freeze_w_rf: bool = False,
        channel: dict | None = None,
        channel_seed: int = 0,
        topology=None,
        edge_channel: dict | None = None,
        client_chunk: int | None = None,
        rule=None,
        faults=None,
        probe: bool = False,
    ):
        """``freeze_w_rf`` pins W_RF at its shared init (its gradient is
        zeroed and W-aggregation skipped), the invariant behind the
        seed-replay codec.  ``channel`` maps payload kinds to lossy codecs
        (``comm.Transport.channel_fns``); ``channel_seed`` keys the default
        uniforms of :meth:`channel_uniforms`.  ``topology`` (a
        ``fleet.Topology``) switches every merge to the two-tier split, with
        ``edge_channel`` the tier-2 codecs; ``client_chunk`` bounds the
        per-client ``vmap``; ``rule`` (default ``MeanRule``) owns every
        weighted merge; ``faults`` (a ``robust.FaultPlan`` or None) corrupts
        the stacked uplinks after the channel; ``probe`` makes the round and
        the flush return a fifth output, the probes dict."""
        self.cfg, self.opt, self.omega = cfg, opt, omega
        self.device = omega.device
        self.rule = rule if rule is not None else MeanRule()
        self.exchange_messages = exchange_messages
        self.aggregate_w_rf = aggregate_w_rf
        self.aggregate_classifier = aggregate_classifier
        self.freeze_w_rf = freeze_w_rf
        self.channel = channel or {}
        self.channel_seed = channel_seed
        self.topology = topology
        self.edge_channel = edge_channel or {}
        self.client_chunk = client_chunk
        self.faults = faults
        self.probe = probe
        if topology is not None:
            # the segment ids with K9's membership plan, built on the host
            # once for the engine's life
            self._plan = membership_plan(topology.segment_ids, topology.n_edges, self.device)
            self._n_edges = topology.n_edges
        else:
            self._plan, self._n_edges = None, 0
        self.round = sentinel.wrap("engine.round", self.round)
        self.flush = sentinel.wrap("engine.flush", self.flush)
        self.warmup = sentinel.wrap("engine.warmup", self.warmup)

    # -- building blocks ----------------------------------------------------

    def _step(self, loss_fn, p, o):
        return local_step(self.opt, loss_fn, p, o, freeze_w_rf=self.freeze_w_rf)

    def _src_local_steps(self, src_p, src_o, xs, ys, mmd_mask, tgt_msg, bmask=None):
        """Local steps of every client: xs (L, K, p, b), ys (L, K, b),
        mmd_mask (K,) 0/1, ``bmask`` (K, b) 0/1 or None.  ``tgt_msg`` is one
        (2N,) broadcast (the round) or a (K, 2N) stack, row k the broadcast
        client k was handed at its dispatch (the flush)."""
        cfg, omega = self.cfg, self.omega

        def one_client(p, o, x, y, gate, sm, tm):
            return self._step(
                lambda pp: source_loss(pp, omega, x, y, tm, cfg, mmd_gate=gate,
                                       sample_mask=sm), p, o)

        mapped = chunked_vmap(one_client, (0, 0, 0, 0, 0, 0 if bmask is not None else None,
                                           0 if tgt_msg.ndim == 2 else None),
                              chunk=self.client_chunk)
        for x, y in zip(xs, ys):
            src_p, src_o = mapped(src_p, src_o, x, y, mmd_mask, bmask, tgt_msg)
        return src_p, src_o

    def channel_uniforms(self, chan_key: int | tuple[int, ...], path: tuple[int, ...],
                         n_rows: int | None, shape: tuple[int, ...]) -> torch.Tensor:
        """The uniforms in [0, 1) of one channel draw: (n_rows, *shape), or
        ``shape`` for a single payload (``n_rows=None``).

        ``chan_key`` is the round index t (a flush's index f; the reference's
        ``fold_in(chan_base, t)``) or a key of two levels, (0x00A5, d) for
        the async runtime's d-th dispatch downlink (``fold_in(fold_in(
        chan_base, 0x00A5), d)``, drawn with ``path=()``).  ``path`` names the
        draw as the reference's key chain does from there: (0,) the target
        downlink, (1,) the K moment uplinks, (2,) the K + 1 W_RF uplinks (the
        target's last), (3, i) classifier leaf i (JAX leaf order: ``b``, then
        ``w``); the tier-2 edge uplinks: (4,) moments, (5,) W_RF, (6, i)
        classifier leaf i.
        The port draws each from a ``torch.Generator`` seeded from
        (channel_seed, chan_key, path), so a round's draws do not depend on
        what ran before it.  A two-level key seeds a ``SeedSequence`` spawn
        (``spawn_key=(2,)``): its words are padded and extended past any
        round key's, so no round draws what a dispatch draws."""
        key = tuple(chan_key) if isinstance(chan_key, tuple) else (chan_key,)
        words = [self.channel_seed & 0xFFFFFFFF, *(int(k) & 0xFFFFFFFF for k in key), *path]
        spawn = () if len(key) == 1 else (len(key),)
        seq = np.random.SeedSequence(words, spawn_key=spawn)
        seed = int(seq.generate_state(1, np.uint64)[0]) >> 1
        gen = torch.Generator(device=self.device).manual_seed(seed)
        full = tuple(shape) if n_rows is None else (n_rows, *shape)
        return torch.rand(full, generator=gen, device=self.device)

    def _channel(self, kind: str, x_rows: torch.Tensor, chan_key, path, *, single=False,
                 tier2=False):
        """The ``kind`` codec's round trip of a stack of payloads x (R, ...),
        on the tier-2 (edge -> server) codecs when ``tier2``."""
        codec = (self.edge_channel if tier2 else self.channel).get(kind)
        if codec is None:
            return x_rows
        u = None
        if codec.stochastic:
            shape = tuple(x_rows.shape[1:])
            u = (self.channel_uniforms(chan_key, path, None, shape)[None] if single
                 else self.channel_uniforms(chan_key, path, x_rows.shape[0], shape))
        return codec.roundtrip(x_rows, u)

    def _edge_fn(self, kind: str, chan_key, path):
        """The tier-2 round trip of an (E, ...) stack of edge uplinks, or None."""
        if self.edge_channel.get(kind) is None:
            return None
        return lambda rows: self._channel(kind, rows, chan_key, path, tier2=True)

    def _fault(self, kind: str, rows: torch.Tensor, chan_key, path):
        return rows if self.faults is None else self.faults.apply(kind, rows, chan_key, path)

    # -- merges ---------------------------------------------------------------
    #
    # ``sel`` is the 0/1 participation mask that gates the assign-backs and
    # the "did anything arrive" checks, ``wsel`` the merge weights.  With no
    # topology these are the flat K-client merges; with one, every merge goes
    # through the two-tier split of ``fleet.hierarchy``.

    def _uplinked_msgs(self, src_p, x_msg, msg_mask, chan_key):
        """(K, 2N) source Sigma-ell uplinks after the tier-1 channel and the
        faults; ``client_chunk``-bounded like the local steps."""
        omega = self.omega
        msgs = chunked_vmap(lambda p, x, mk: client_message(p, omega, x, +1.0, mask=mk),
                            (0, 0, 0 if msg_mask is not None else None),
                            chunk=self.client_chunk)(src_p, x_msg, msg_mask)
        msgs = self._channel("moments", msgs, chan_key, (1,))
        return self._fault("moments", msgs, chan_key, (7,))

    def _merge_msgs(self, msgs, weights, chan_key, probes=None):
        """What the target trains on: the rule's moment merge of the K client
        messages (flat), or of the E per-edge pooled moments and their masses
        (two-tier).  ``probes`` (a dict or None) takes the delivered moment
        mass and the rule's per-row (client, or edge) attribution."""
        if self._plan is not None:
            msgs, weights = hierarchy.edge_moment_merge(
                msgs, weights, self._plan, self._n_edges,
                self._edge_fn("moments", chan_key, (4,)))
        if probes is not None:
            probes["moment_mass"] = torch.sum(weights)
            probes["attribution_moments"] = self.rule.attribution(msgs, weights)
        return self.rule.merge_moments(msgs, weights)

    def _server_merge(self, sums, masses):
        """Tier-2 combine of per-edge (weighted sum, mass) partials: pure
        reassociation for the mean rule; other rules re-merge the edge partial
        means as E rows (a poisoned edge is one outlier)."""
        if self.rule.is_mean:
            return hierarchy.server_combine(sums, masses)
        shaped = masses.reshape((-1,) + (1,) * (sums.ndim - 1))
        return self.rule.weighted_sum(sums / torch.clamp_min(shaped, _MASS_EPS), masses)

    def _merged_sum(self, kind, values, wsel, chan_key, path, probes=None):
        """(sum, mass) of a (K, ...) payload stack: the rule's contraction
        (flat) or the edge partials and the server merge (two-tier).
        ``probes`` takes the rule's attribution of the rows it merged (the
        uplinks, or the edge partial means) as ``attribution_<kind>``."""
        if self._plan is None:
            if probes is not None:
                probes[f"attribution_{kind}"] = self.rule.attribution(values, wsel)
            return self.rule.weighted_sum(values, wsel)
        sums, masses = hierarchy.edge_param_merge(values, wsel, self._plan, self._n_edges,
                                                  self._edge_fn(kind, chan_key, path))
        if probes is not None:
            shaped = masses.reshape((-1,) + (1,) * (sums.ndim - 1))
            probes[f"attribution_{kind}"] = self.rule.attribution(
                sums / torch.clamp_min(shaped, _MASS_EPS), masses)
        return self._server_merge(sums, masses)

    def _target_steps(self, tgt_p, tgt_o, xt_steps, msgs, weights, any_gate):
        """Alg. 3 local target steps on the merged source moments; params AND
        Adam state stay as they were when nothing arrived."""
        cfg, omega = self.cfg, self.omega
        new_p, new_o = tgt_p, tgt_o
        for x in xt_steps:
            new_p, new_o = self._step(
                lambda pp: target_loss(pp, omega, x, msgs, cfg, weights=weights), new_p, new_o)
        return tree_where(any_gate, new_p, tgt_p), tree_where(any_gate, new_o, tgt_o)

    def _merge_w_rf(self, src_p, tgt_p, sel, wsel, chan_key, probes=None):
        """Weighted W_RF merge over the participants and the target (Alg. 4)."""
        k_clients = sel.shape[0]
        have_w = torch.sum(sel) > 0
        ups = torch.cat([src_p["w_rf"], tgt_p["w_rf"][None]])
        ups = self._channel("w_rf", ups, chan_key, (2,))
        w_up, w_tgt_up = self._fault("w_rf", ups[:k_clients], chan_key, (8,)), ups[k_clients]
        w_sum, mass = self._merged_sum("w_rf", w_up, wsel, chan_key, (5,), probes)
        w_avg = (w_sum + w_tgt_up) / (mass + 1.0)
        src_p = {**src_p, "w_rf": torch.where((sel > 0)[:, None, None] & have_w, w_avg[None],
                                              src_p["w_rf"])}
        tgt_p = {**tgt_p, "w_rf": torch.where(have_w, w_avg, tgt_p["w_rf"])}
        return src_p, tgt_p

    def _merge_classifier(self, src_p, tgt_p, sel, wsel, do_clf, chan_key, floor):
        """Weighted classifier merge on T_C rounds (Alg. 4).  ``do_clf`` is a
        host bool: on other rounds nothing is sent, so nothing goes through
        the channel (the reference computes and discards it under ``jit``)."""
        if not do_clf:
            return src_p, tgt_p
        have_c = torch.sum(sel) > 0
        clf_up = src_p["classifier"]
        if self.channel.get("classifier") is not None:
            leaves = [self._channel("classifier", leaf, chan_key, (3, i))
                      for i, leaf in enumerate(tree_leaves(clf_up))]
            clf_up = tree_unflatten_like(clf_up, leaves)
        # one fault draw per merge: the same clients corrupt in every leaf
        clf_up = tree_map(lambda leaf: self._fault("classifier", leaf, chan_key, (9,)), clf_up)
        merged = []
        for i, leaf in enumerate(tree_leaves(clf_up)):
            s, m = self._merged_sum("classifier", leaf, wsel, chan_key, (6, i))
            merged.append(s / torch.clamp_min(m, floor))
        c_avg = tree_unflatten_like(clf_up, merged)
        assign = (sel > 0) & have_c
        src_p = {**src_p, "classifier": tree_map(
            lambda avg, old: torch.where(assign.reshape((-1,) + (1,) * (old.ndim - 1)),
                                         avg[None], old),
            c_avg, src_p["classifier"])}
        tgt_p = {**tgt_p, "classifier": tree_where(have_c, c_avg, tgt_p["classifier"])}
        return src_p, tgt_p

    # -- round body (Alg. 5) --------------------------------------------------

    def round(self, src_p, src_o, tgt_p, tgt_o, batch, masks, chan_key=None):
        """One communication round.  ``batch``: ``xs`` (L, K, p, b), ``ys``
        (L, K, b), ``x_msg`` (K, p, mb), ``xt_steps`` (L, p, b), ``xt_msg``
        (p, mb), optional ``bmask`` (K, b) and ``msg_mask`` (K, mb).
        ``masks``: ``mmd``, ``w``, ``c`` (K,) 0/1 and ``do_clf`` (bool:
        t % T_C == 0 this round).
        ``chan_key`` (the round index) keys the channel's uniforms.  With
        ``probe`` the probes dict comes back as a fifth output."""
        if chan_key is None:
            if self.channel:
                # a fixed default would replay the same channel noise every round
                raise ValueError("channel distortion is set: pass a per-round chan_key")
            chan_key = 0
        probes = {} if self.probe else None
        src_p0, tgt_p0 = src_p, tgt_p
        omega = self.omega
        mmd_mask, w_mask, c_mask = masks["mmd"], masks["w"], masks["c"]
        bmask, msg_mask = batch.get("bmask"), batch.get("msg_mask")

        # the target's broadcast to the sources in S_t (the one downlink)
        tgt_msg = client_message(tgt_p, omega, batch["xt_msg"], -1.0)
        tgt_msg = self._channel("moments", tgt_msg[None], chan_key, (0,), single=True)[0]

        # local source training (Alg. 2), MMD gated by S_t membership
        gates = mmd_mask if self.exchange_messages else torch.zeros_like(mmd_mask)
        src_p, src_o = self._src_local_steps(src_p, src_o, batch["xs"], batch["ys"], gates,
                                             tgt_msg, bmask)

        # local target training (Alg. 3) on the messages that arrived
        if self.exchange_messages:
            msgs = self._uplinked_msgs(src_p, batch["x_msg"], msg_mask, chan_key)
            merged, tgt_w = self._merge_msgs(msgs, mmd_mask, chan_key, probes)
            tgt_p, tgt_o = self._target_steps(tgt_p, tgt_o, batch["xt_steps"], merged, tgt_w,
                                              torch.sum(mmd_mask) > 0)

        # global aggregation (Alg. 4); frozen W (seed replay) skips it
        if self.aggregate_w_rf and not self.freeze_w_rf:
            src_p, tgt_p = self._merge_w_rf(src_p, tgt_p, w_mask, w_mask, chan_key, probes)
        if self.aggregate_classifier:
            src_p, tgt_p = self._merge_classifier(src_p, tgt_p, c_mask, c_mask, masks["do_clf"],
                                                  chan_key, 1.0)
        return self._out(src_p, src_o, tgt_p, tgt_o, probes, src_p0, tgt_p0)

    @staticmethod
    def _out(src_p, src_o, tgt_p, tgt_o, probes, src_p0, tgt_p0):
        """The round's or flush's outputs, with the probes dict when probing."""
        if probes is None:
            return src_p, src_o, tgt_p, tgt_o
        probes["update_norm"] = client_delta_norms(src_p, src_p0)
        probes["tgt_update_norm"] = tree_delta_norm(tgt_p, tgt_p0)
        return src_p, src_o, tgt_p, tgt_o, probes

    # -- async buffered flush (fedsim.AsyncScheduler's data plane) ----------

    @staticmethod
    def _select_clients(mask, new, old):
        """Leafwise per-client where: row k of ``new`` iff mask[k] > 0."""
        return tree_map(lambda a, b: torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)) > 0,
                                                 a, b), new, old)

    def flush(self, src_p, src_o, tgt_p, tgt_o, batch, masks, chan_key=None):
        """One FedBuff-style buffered aggregation.  ``batch``: the
        dispatch-time draws ``xs`` (L, K, p, b), ``ys`` (L, K, b), ``x_msg``
        (K, p, mb) (rows outside the buffer are finite dummies), the
        flush-time ``xt_steps`` (L, p, b), ``tgt_msgs`` (K, 2N) (row k the
        broadcast client k received at its dispatch), optional ``bmask`` and
        ``msg_mask``.  ``masks``: ``buf`` (K,) 0/1 (the buffered clients),
        ``weights`` (K,) staleness weights, ``do_clf`` (bool: every T_C-th
        flush).  ``chan_key`` (the flush index) keys the channel's uniforms.

        Every client runs its local steps; only the buffered rows keep their
        parameters and Adam states.  Every merge (the moments into the target
        steps, W_RF, the classifier with a 1e-9 floor) is weighted by
        ``buf * weights``.  With a full buffer at staleness 0 every
        expression reduces to :meth:`round`'s: the sync/async degeneracy.
        With ``probe`` the probes dict comes back as a fifth output."""
        if chan_key is None:
            if self.channel:
                raise ValueError("channel distortion is set: pass a per-flush chan_key")
            chan_key = 0
        probes = {} if self.probe else None
        src_p0, tgt_p0 = src_p, tgt_p
        buf, do_clf = masks["buf"], masks["do_clf"]
        wsel = buf * masks["weights"]
        bmask, msg_mask = batch.get("bmask"), batch.get("msg_mask")

        # local source training at the dispatch inputs; keep the buffered rows
        gates = buf if self.exchange_messages else torch.zeros_like(buf)
        new_p, new_o = self._src_local_steps(src_p, src_o, batch["xs"], batch["ys"], gates,
                                             batch["tgt_msgs"], bmask)
        src_p = self._select_clients(buf, new_p, src_p)
        src_o = self._select_clients(buf, new_o, src_o)

        # the target trains on the buffered moments, staleness-weighted
        if self.exchange_messages:
            msgs = self._uplinked_msgs(src_p, batch["x_msg"], msg_mask, chan_key)
            merged, tgt_w = self._merge_msgs(msgs, wsel, chan_key, probes)
            tgt_p, tgt_o = self._target_steps(tgt_p, tgt_o, batch["xt_steps"], merged, tgt_w,
                                              torch.sum(buf) > 0)
        if self.aggregate_w_rf and not self.freeze_w_rf:
            src_p, tgt_p = self._merge_w_rf(src_p, tgt_p, buf, wsel, chan_key, probes)
        if self.aggregate_classifier:
            src_p, tgt_p = self._merge_classifier(src_p, tgt_p, buf, wsel, do_clf, chan_key,
                                                  1e-9)
        return self._out(src_p, src_o, tgt_p, tgt_o, probes, src_p0, tgt_p0)

    # -- warm-up (emulated pretraining, FedAvg over sources) -----------------

    def warmup(self, src_p, src_o, xs, ys, bmask=None):
        """R warm-up rounds: local CE steps, then whole-model FedAvg.
        xs (R, L, K, p, b), ys (R, L, K, b)."""
        k_clients = xs.shape[2]
        zeros_gate = torch.zeros((k_clients,), device=self.device)
        zeros_msg = torch.zeros((2 * self.cfg.n_rff,), device=self.device)
        for x_r, y_r in zip(xs, ys):
            src_p, src_o = self._src_local_steps(src_p, src_o, x_r, y_r, zeros_gate, zeros_msg,
                                                 bmask)
            src_p = tree_map(lambda t: torch.mean(t, dim=0, keepdim=True).expand(t.shape)
                             .contiguous(), src_p)
        return src_p, src_o
