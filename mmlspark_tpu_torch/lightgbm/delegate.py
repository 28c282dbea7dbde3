"""Training delegate — user hooks per batch/iteration.

An own copy of the JAX package's ``lightgbm/delegate.py``, verbatim.
``as_callback()`` plugs into ``train(callbacks=...)`` and
``train_streamed(callbacks=...)``, which call it once per iteration;
neither driver calls ``get_learning_rate`` (nor does the reference's).

Reference: ``LightGBMDelegate.scala`` — callbacks before/after training and
per iteration (used e.g. for dynamic learning-rate schedules).
"""
from __future__ import annotations

from typing import Dict, Optional


class LightGBMDelegate:
    """Subclass and pass via ``LightGBMClassifier.set('delegate', ...)`` or
    ``core.train(callbacks=[delegate.as_callback()])``."""

    def before_training_iteration(self, iteration: int) -> None:
        pass

    def after_training_iteration(self, iteration: int,
                                 eval_result: Optional[Dict] = None) -> None:
        pass

    def get_learning_rate(self, iteration: int, current_lr: float) -> float:
        """Return the LR for this iteration (dynamic schedules)."""
        return current_lr

    def as_callback(self):
        def cb(iteration, eval_result):
            self.after_training_iteration(iteration, eval_result)
        return cb
