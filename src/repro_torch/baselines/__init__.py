"""Domain-adaptation baselines and downstream classifiers (``repro.baselines``)."""
from repro_torch.baselines.classifiers import fit_logreg, fit_mlp, knn_1, score
from repro_torch.baselines.da_methods import (
    coral_baseline,
    dann_mmd_baseline,
    fedavg_baseline,
    jda_baseline,
    rf_tca_baseline,
    source_only,
    tca_baseline,
)

__all__ = [
    "coral_baseline", "dann_mmd_baseline", "fedavg_baseline", "fit_logreg", "fit_mlp",
    "jda_baseline", "knn_1", "rf_tca_baseline", "score", "source_only", "tca_baseline",
]
