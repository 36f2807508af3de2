"""Training and the serve steps: AdamW (``optimizer``), the train step
with microbatches and the int8 error-feedback transport and the encode,
prefill and decode steps (``step``), checkpoints on the LST store
(``checkpoints``) and the fault-tolerant ``Trainer`` (``runner``)."""
