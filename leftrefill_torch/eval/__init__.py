"""Evaluation metrics of the port (counterpart of ``leftrefill_tpu/eval``)."""
