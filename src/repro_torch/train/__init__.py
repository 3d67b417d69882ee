"""The fault-tolerant training loop (port of ``repro.train``)."""

from repro_torch.train.loop import TrainLoop, TrainState, make_train_step

__all__ = ["TrainLoop", "TrainState", "make_train_step"]
