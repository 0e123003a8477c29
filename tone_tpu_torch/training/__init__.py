"""Training utilities of the port: so far only the word error rate (the
trainer, CTC loss and collator wait for ROADMAP A13)."""

from tone_tpu_torch.training.wer import normalize_text, word_error_rate

__all__ = ["normalize_text", "word_error_rate"]
