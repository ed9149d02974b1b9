"""Consumers, one module each, found by the ``consumer`` key of a
configuration. A consumer drives the
port's entry point for one epoch, keeps what the comparison needs, and
compares it with the reference once the window has closed."""
