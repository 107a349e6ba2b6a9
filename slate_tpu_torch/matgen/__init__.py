"""matgen layer of slate_tpu_torch (the Philox generator so far)."""
