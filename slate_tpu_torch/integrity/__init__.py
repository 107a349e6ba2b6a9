"""The serve tier's integrity plane (delivery certification); only the
policy resolver is ported (ROADMAP.md Queue 1 item 7)."""
