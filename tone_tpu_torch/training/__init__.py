"""Fine-tuning of the port: CTC loss, collator, the one-device trainer, WER."""

from tone_tpu_torch.training.collator import DataCollatorCTCWithPadding, tokenize_text
from tone_tpu_torch.training.ctc import ctc_loss
from tone_tpu_torch.training.train import Trainer, TrainerConfig, TrainState
from tone_tpu_torch.training.wer import normalize_text, word_error_rate

__all__ = [
    "DataCollatorCTCWithPadding",
    "Trainer",
    "TrainerConfig",
    "TrainState",
    "ctc_loss",
    "normalize_text",
    "tokenize_text",
    "word_error_rate",
]
