"""The step bisect (``step_bisect``): one training step run twice on the
card, every tensor it makes compared bit for bit. Nothing in the port
imports it; ``chip_smoke.py`` runs it."""
