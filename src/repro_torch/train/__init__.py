"""The training engines: the synchronous step (``step.py``), the
buffered-async step (``async_sgd.py``), the memory-bounded streaming step
(``streaming.py``) and the deprecated ``Trainer`` shim (``trainer.py``)."""
