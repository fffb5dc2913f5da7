"""Epoch-level LR schedulers, the counterpart of `ralf_tpu/train/schedulers.py`
(a copy: the port imports nothing of the JAX package).

MultiStepLR with fractional-or-absolute milestones (gamma 0.1),
ReduceLROnPlateau (factor 0.5, patience 2, threshold 1e-2), the DS-GAN
stair (which never fires, as in the reference) and Void.  All are
host-side state machines returning an LR *scale*; the trainer sets
base_lr * scale into the optimizer's groups each epoch
(`train.optim.set_learning_rate`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union


class VoidScheduler:
    requires_metric = False

    def __init__(self, epochs: int = 0, **_):
        pass

    def scale(self, epoch: int, metric: Optional[float] = None) -> float:
        return 1.0


class MultiStepLRScheduler:
    """Milestones as fractions of total epochs (floats) or absolute epochs
    (ints); LR multiplied by gamma at each passed milestone."""

    requires_metric = False

    def __init__(
        self,
        epochs: int,
        milestones: Sequence[Union[int, float]] = (0.7,),
        gamma: float = 0.1,
        **_,
    ):
        if len(milestones) and isinstance(milestones[0], float):
            assert all(0.0 <= m <= 1.0 for m in milestones)
            self.milestones = sorted(int(m * epochs) for m in milestones)
        else:
            self.milestones = sorted(int(m) for m in milestones)
        self.gamma = gamma

    def scale(self, epoch: int, metric: Optional[float] = None) -> float:
        passed = sum(1 for m in self.milestones if epoch >= m)
        return self.gamma**passed


class DSGANScheduler(MultiStepLRScheduler):
    """DS-GAN's LR schedule — which, in the reference, is a CONSTANT.

    The reference builds `milestones=torch.arange(0, epochs, interval)`
    (`train/schedulers/dsgan.py:20-24`) and hands the raw TENSOR to
    torch's MultiStepLR, whose epoch test is `last_epoch in
    Counter(milestones)`: tensor hashing is identity-based, so an int
    epoch never matches a tensor milestone and **no gamma is ever
    applied** — verified against torch in
    tests/test_optim_torch_parity.py::test_dsgan_stair_matches_torch.
    The published DS-GAN runs therefore trained at a flat base LR for all
    300 epochs, and that actual behavior is the default here.

    `intended_stair=True` gives the stair the code was presumably aiming
    for (gamma 0.8 every 50 generator / 25 discriminator epochs, with the
    milestone-0 quirk that torch would apply one gamma from epoch 1).
    """

    def __init__(self, epochs: int = 300, gamma: float = 0.8,
                 network: str = "generator", intended_stair: bool = False,
                 **_):
        interval = 50 if network == "generator" else 25
        milestones = (
            list(range(0, epochs, interval)) if intended_stair else []
        )
        super().__init__(epochs, milestones=milestones, gamma=gamma)


class ReduceLROnPlateauScheduler:
    """min-mode plateau detection on a validation metric."""

    requires_metric = True

    def __init__(
        self,
        epochs: int = 0,
        factor: float = 0.5,
        patience: int = 2,
        threshold: float = 1e-2,
        **_,
    ):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self._best = float("inf")
        self._bad_epochs = 0
        self._scale = 1.0

    def scale(self, epoch: int, metric: Optional[float] = None) -> float:
        if metric is None:
            return self._scale
        # torch semantics (rel threshold, mode=min)
        if metric < self._best * (1 - self.threshold):
            self._best = metric
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self._scale *= self.factor
                self._bad_epochs = 0
        return self._scale


SCHEDULERS = {
    "void": VoidScheduler,
    "multi_step_lr": MultiStepLRScheduler,
    "reduce_lr_on_plateau": ReduceLROnPlateauScheduler,
    "dsgan": DSGANScheduler,
}


def build_scheduler(name: str, epochs: int, **kwargs):
    return SCHEDULERS[name](epochs=epochs, **kwargs)
