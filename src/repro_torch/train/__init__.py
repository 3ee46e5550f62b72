"""Training substrate of the port: optimizers, data, checkpointing,
fault tolerance and the training loop.

Port of ``repro.train``.  Only ``optim`` is imported eagerly
(``models.lm`` depends on it); import ``repro_torch.train.data`` /
``.loop`` / ``.checkpoint`` / ``.fault`` directly.
"""
from . import optim  # noqa: F401
