"""Training of the port: the trainer (one device or a training group),
the pipeline trainer, the synthetic data, held-out evaluation and
pretraining (``distributed_llm_tpu/training/``)."""

from .data import (batches, corpus_batches, pack_documents,  # noqa: F401
                   synthetic_text)
from .pipeline_trainer import PipelineTrainer  # noqa: F401
from .trainer import TrainConfig, Trainer, lm_loss  # noqa: F401
