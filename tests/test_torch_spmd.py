"""Port parity: the LM SPMD over a (data 2, model 2) mesh of four gloo ranks
against the reference's unsharded functions on the CPU (the dense and MoE
families; tests/torch_spmd_parity.py has the machinery).

Each rank holds its shards of the reference's placements (``LM.specs()``,
model axis 2: every head count, d_ff, the vocabulary, d and the experts
divide) and its half of the batch.  Held against the reference on the same
numpy weights and inputs:

- the loss and every gradient leaf (summed over the data axis, unsharded),
  at n_clients 2: dense (smollm-135m's reduced config), MoE with GQA
  (qwen3-moe), MoE with MLA and a shared expert (deepseek-v2-lite);
- prefill logits and every cache leaf, then one decode step;
- the same with ``seq_parallel`` and ``sharded_ce`` (the same numbers);
- ``moe_ep`` against the reference's ``moe_forward_ep`` in its LM (a
  ``shard_map`` over four forced devices), with ``seq_parallel`` too;
- capacity factor 0.5, where every layer drops pairs: the reference's
  global capacity and positions over the whole batch;
- a batch of one whose cache's sequence lies over the data axis (GQA and
  MLA decode);
- one ``build_train_step``: AdamW with clipping, every new parameter.

Tolerances, fp32: the loss 1e-5 x max(1, |loss|); every other leaf 1e-4 x
max(1, max|leaf|), the round engine's rule.  The gradient leaves add four
times what a 1e-7 relative nudge of the weights moves the port's own
unsharded gradient (tests/test_torch_train.py's rule: the two-layer
random-init stack amplifies fp32 rounding up to ~1e-3, in the unsharded
port as much as in the sharded one), and are also held to the port's
unsharded gradient within 1e-4.  The train step: tests/test_torch_train.py's
rule (each parameter 1e-4 x max(1, max|leaf|) plus 2 lr; the global norm
1e-3 of itself).
"""
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_parity as par  # noqa: E402

from repro_torch.models.moe import capacity  # noqa: E402

CASES = [
    par.case("dense", "smollm-135m", do=("loss", "decode", "decode1", "train")),
    par.case("dense_sp_ce", "smollm-135m", do=("loss",), seq_parallel=True, sharded_ce=True),
    par.case("moe", "qwen3-moe-235b-a22b"),
    par.case("moe_sp_ce", "qwen3-moe-235b-a22b", do=("loss",), seq_parallel=True,
             sharded_ce=True),
    par.case("moe_capacity", "qwen3-moe-235b-a22b", capacity_factor=0.5),
    par.case("moe_ep", "qwen3-moe-235b-a22b", do=("loss",), ep=True, moe_ep=True),
    par.case("mla", "deepseek-v2-lite-16b", do=("loss", "decode", "decode1")),
    par.case("mla_ep_sp_ce", "deepseek-v2-lite-16b", do=("loss",), ep=True, moe_ep=True,
             seq_parallel=True, sharded_ce=True),
]
BY_NAME = {c["name"]: c for c in CASES}

one_thread = pytest.fixture(autouse=True, scope="module")(par.one_thread)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return par.run(tmp_path_factory.mktemp("spmd"), CASES)


def _names(kind):
    return [c["name"] for c in CASES if kind in c["do"]]


@pytest.mark.parametrize("name", _names("loss"))
def test_loss_and_every_gradient_leaf(runs, name):
    ref, port = runs
    par.check(ref, port, f"{name}/loss")
    par.check(ref, port, f"{name}/m/")
    par.check_grads(ref, port, name)


@pytest.mark.parametrize("name", _names("decode"))
def test_prefill_cache_and_one_decode_step(runs, name):
    ref, port = runs
    par.check(ref, port, f"{name}/decode/")


@pytest.mark.parametrize("name", _names("decode1"))
def test_batch_one_decode_with_the_cache_sequence_over_data(runs, name):
    ref, port = runs
    par.check(ref, port, f"{name}/decode1/")


@pytest.mark.parametrize("name", _names("train"))
def test_train_step_adamw_with_clipping(runs, name):
    ref, port = runs
    par.check_train(ref, port, name)


def test_capacity_binds_in_the_capacity_case():
    """At capacity factor 0.5 the global capacity holds fewer slots than the
    batch routes pairs: every layer drops some."""
    cfg = par.config(BY_NAME["moe_capacity"])
    t = par.B * par.S
    assert capacity(cfg, t) * cfg.n_experts < t * cfg.top_k
