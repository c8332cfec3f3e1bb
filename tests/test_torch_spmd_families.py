"""Port parity: the LM SPMD over a (data 2, model 2) mesh of four gloo ranks
against the reference's unsharded functions on the CPU (the SSM, hybrid,
VLM and audio families; tests/torch_spmd_parity.py has the machinery and
the tolerances, tests/test_torch_spmd.py the dense and MoE families).

Each family's ``reduced()`` config (every placed dimension divisible by 2):
mamba2-2.7b (d_inner, heads and the conv's packed channels over the model
axis, the gated norm's sum of squares all-reduced), zamba2-7b (its SSM
blocks and the shared attention), llama-3.2-vision-90b (cross-attention
with its gates at 0.5 and seeded images) and musicgen-large (frame
embeddings in).  The loss and every gradient leaf at n_clients 2, prefill
logits and every cache leaf (the SSM state over its heads, the conv tail a
contiguous block of its channels a rank), one decode step; the same loss
with ``seq_parallel`` and ``sharded_ce``; the hybrid's batch-one decode with
its shared attention's cache sequence over the data axis.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_parity as par  # noqa: E402

CASES = [
    par.case("ssm", "mamba2-2.7b"),
    par.case("ssm_sp_ce", "mamba2-2.7b", do=("loss",), seq_parallel=True, sharded_ce=True),
    par.case("hybrid", "zamba2-7b", do=("loss", "decode", "decode1")),
    par.case("hybrid_sp_ce", "zamba2-7b", do=("loss",), seq_parallel=True, sharded_ce=True),
    par.case("vlm", "llama-3.2-vision-90b"),
    par.case("vlm_sp_ce", "llama-3.2-vision-90b", do=("loss",), seq_parallel=True,
             sharded_ce=True),
    par.case("audio", "musicgen-large"),
    par.case("audio_sp_ce", "musicgen-large", do=("loss",), seq_parallel=True, sharded_ce=True),
]

one_thread = pytest.fixture(autouse=True, scope="module")(par.one_thread)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return par.run(tmp_path_factory.mktemp("spmd_families"), CASES)


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
