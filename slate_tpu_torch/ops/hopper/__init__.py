"""ops/hopper layer of slate_tpu_torch."""
