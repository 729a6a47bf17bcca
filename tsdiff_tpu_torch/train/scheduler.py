"""Host-side learning-rate controllers.

``plateau`` (ReduceLROnPlateau: mode min, relative threshold 1e-4, no
cooldown) is driven by the validation loss; ``expmin`` decays exponentially
to a floor and ``expmin_milestone`` reaches ``factor`` after ``milestone``
steps.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class PlateauScheduler:
    lr: float
    factor: float = 0.8
    patience: int = 10
    min_lr: float = 0.0
    threshold: float = 1e-4

    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)


@dataclasses.dataclass
class ExpMinScheduler:
    """lr_t = lr0 * gamma^t, floored at min_lr."""

    lr: float
    gamma: float
    min_lr: float
    step_count: int = 0
    base_lr: float | None = None

    def __post_init__(self):
        if self.base_lr is None:
            self.base_lr = self.lr

    def step(self, metric: float | None = None) -> float:
        self.step_count += 1
        self.lr = max(self.base_lr * self.gamma**self.step_count, self.min_lr)
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)


def get_scheduler(config, base_lr: float):
    t = config.type
    if t == "plateau":
        return PlateauScheduler(
            lr=base_lr, factor=config.factor, patience=config.patience, min_lr=config.min_lr
        )
    if t == "expmin":
        return ExpMinScheduler(lr=base_lr, gamma=config.factor, min_lr=config.min_lr)
    if t == "expmin_milestone":
        gamma = math.exp(math.log(config.factor) / config.milestone)
        return ExpMinScheduler(lr=base_lr, gamma=gamma, min_lr=config.min_lr)
    raise NotImplementedError(f"Scheduler not supported: {t}")
