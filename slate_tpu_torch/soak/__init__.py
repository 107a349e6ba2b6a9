"""Trace-driven soak fabric on the card (the JAX package's ``soak``,
ROADMAP.md Queue 1 item 7c2a): record real workload shape, replay it
deterministically at scale with every serve plane armed at once, and
watch the whole system through one time-series lens.

The serve tier is traced, fair, certified, quarantine-capable and
race-checked, but each plane is judged by its own gate in isolation.
This package closes the loop (the tail-at-scale effect only
accumulates under sustained mixed load, Dean & Barroso):

* :mod:`slate_tpu_torch.soak.record` -- workload recorder: a delivery
  tap on a live :class:`~slate_tpu_torch.serve.service.SolverService`
  (or the span ring) becomes a durable, replayable JSONL load spec in
  the JAX package's format.  Operands are never persisted -- matrices
  regenerate deterministically from ``matgen`` philox seeds, and
  ``repeat_fp`` preserves same-A burst structure for the factor cache.
* :mod:`slate_tpu_torch.soak.replay` -- replay engine: drives a
  recorded or synthesized spec (bundled generators: multitenant burst,
  repeated-A stream, adversarial flood, deadline storm, traffic step)
  against a live service with open-loop pacing at ``speed`` x, seeded
  end to end.
* :mod:`slate_tpu_torch.soak.timeline` -- health timeline: samples
  ``health()`` + devmon gauges on a background cadence into
  ``{"type": "timeline"}`` JSONL rows.

``tools/soak_report.py`` joins the timeline with the metric families
into one judged verdict; ``python3 chip_smoke.py --soak`` runs the
drill on the card.

Zero overhead off, like every other plane: nothing here hooks the
serve tier until a recorder / sampler is explicitly armed, and the
delivery tap costs the hot path one truthiness check on an empty list.
"""

from . import record, replay, timeline  # noqa: F401

__all__ = ["record", "replay", "timeline"]
