"""Dataset formats, one module each, found by the ``format`` key of a
configuration: ``make(cfg, seed, device) -> Dataset``."""
