"""What the drivers share: seeds, the cell's inputs, the sample of answers."""
from __future__ import annotations

import random

import numpy as np
import torch

from portbench.datagen import domain_pair, median_sigma

# the streams drawn from a run's seed
DATA, FITS, SAMPLE = 0, 1, 2


def substream(seed: int, stream: int) -> int:
    """A 63-bit seed derived from the run's seed (any whole number) and a stream."""
    state = np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inputs:
    """The domain pair and sigma of a configuration, made on ``device``."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        gen = torch.Generator(device=device).manual_seed(substream(seed, DATA))
        self.x_s, self.x_t = domain_pair(
            dim=cfg["dim"], n_source=cfg["n_source"], n_target=cfg["n_target"],
            n_classes=cfg["n_classes"], generator=gen, device=device, **cfg["domains"],
        )
        self.sigma = median_sigma(self.x_s, self.x_t, subsample=cfg["sigma_subsample"],
                                  generator=gen)


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            self.items.append(item)
            return
        j = int(self.rng.random() * (i + 1))
        if j < self.k:
            self.items[j] = item
