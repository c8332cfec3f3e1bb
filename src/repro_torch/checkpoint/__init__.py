"""Tree checkpoints in the reference's ``.npz`` layout (``checkpoint.ckpt``)."""
from repro_torch.checkpoint.ckpt import latest, latest_step, restore, save

__all__ = ["latest", "latest_step", "restore", "save"]
