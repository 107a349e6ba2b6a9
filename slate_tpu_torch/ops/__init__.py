"""ops layer of slate_tpu_torch."""
