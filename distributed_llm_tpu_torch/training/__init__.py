"""Training of the port on one device: the trainer, the synthetic data,
held-out evaluation and pretraining (``distributed_llm_tpu/training/``
without the pipeline trainer, which waits for the multi-GPU slice)."""

from .data import (batches, corpus_batches, pack_documents,  # noqa: F401
                   synthetic_text)
from .trainer import TrainConfig, Trainer, lm_loss  # noqa: F401
