"""Training: AdamW (``optimizer``), the train step with microbatches and
the int8 error-feedback transport (``step``), checkpoints on the LST store
(``checkpoints``) and the fault-tolerant ``Trainer`` (``runner``)."""
