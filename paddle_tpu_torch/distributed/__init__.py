"""Distributed pieces of the port; only the seeded fault injector
(``faultinject``) is ported so far."""
