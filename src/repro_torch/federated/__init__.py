"""FedRF-TCA (paper Alg. 5): client model, aggregation, network plans, the
batched round engine and the trainer.  Port of ``repro.federated``."""
from repro_torch.comm.transport import CommLog
from repro_torch.federated.aggregation import (
    fedavg_classifier,
    fedavg_models,
    fedavg_w_rf,
    hard_vote,
    staleness_weights,
)
from repro_torch.federated.engine import BatchedRoundEngine
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
from repro_torch.federated.network import LossyChannel, RoundPlan, plan_round, sample_participants
from repro_torch.federated.protocol import FedRFTCATrainer, ProtocolConfig
from repro_torch.utils.tree import stack_trees, unstack_tree

__all__ = [
    "BatchedRoundEngine", "ClientConfig", "CommLog", "FedRFTCATrainer", "LossyChannel",
    "ProtocolConfig", "RoundPlan", "accuracy", "client_message", "fedavg_classifier",
    "fedavg_models", "fedavg_w_rf", "hard_vote", "init_params", "logits_of", "make_omega",
    "plan_round", "sample_participants", "source_loss", "stack_trees", "staleness_weights",
    "target_loss", "unstack_tree", "w_rf_key",
]
