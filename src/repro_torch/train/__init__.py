"""The training engines: the synchronous step (``step.py``), the
buffered-async step (``async_sgd.py``), the memory-bounded streaming step
(``streaming.py``) and the deprecated ``Trainer`` shim (``trainer.py``)."""
from repro_torch.train.step import make_train_step  # noqa: F401
from repro_torch.train.streaming import (  # noqa: F401
    make_streaming_train_step, run_streaming_training,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
