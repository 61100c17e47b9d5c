"""Traffic: one generator a kind (``<kind>.py``) reading the mixes
(``<traffic>.json``), and the seeded frame generator."""
