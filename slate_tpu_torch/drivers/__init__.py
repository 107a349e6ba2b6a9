"""drivers layer of slate_tpu_torch."""

from .eig import heev_staged  # noqa: F401 (re-exported)
