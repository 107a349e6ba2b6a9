"""parallel layer of slate_tpu_torch."""
