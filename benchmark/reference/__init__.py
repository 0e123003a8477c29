"""Plain references of what the benchmark's cells run: the model in float32
(``model``), its phrase splitting and greedy decoding (``decode``) and its
fine-tuning step (``train``).  They import nothing of the program."""
