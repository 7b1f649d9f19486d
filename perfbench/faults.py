"""Faults planted under the timed path, to show that ``correct`` catches
them: each takes what a driver built (a training state, or the upscaling
task) after the seeded weights are loaded."""

from __future__ import annotations


def unchanged_state(state) -> None:
    """A training step that returns its state unchanged: Adam's update is
    skipped."""
    state.optimizer.step = lambda *args, **kwargs: None


def half_batch(state) -> None:
    """Half of each scale's batch left out, the loss the mean over the
    rest."""
    task = state.task
    whole = type(task).train_loss

    def train_loss(batch):
        return whole(task, {s: (lr[:lr.shape[0] // 2], hr[:hr.shape[0] // 2])
                            for s, (lr, hr) in batch.items()})
    object.__setattr__(task, "train_loss", train_loss)


def altered_answer(task) -> None:
    """One value of every prediction altered by 1/255, one 8-bit level."""
    whole = type(task).predict

    def predict(lr, size, bsize=None):
        out = whole(task, lr, size, bsize).clone()
        out[0, size[0] // 2, size[1] // 2, 0] += 1.0 / 255
        return out
    object.__setattr__(task, "predict", predict)


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
UPSCALE = {"altered_answer": altered_answer}
