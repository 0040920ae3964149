"""Which parameters train (counterpart of mmgl_tpu/peft)."""
