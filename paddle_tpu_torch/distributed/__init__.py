"""Distributed pieces of the port: the seeded fault injector
(``faultinject``) and the health-probe interval knob (``rpc``); the
transports and collectives are not ported yet (ROADMAP Queue 1 item
5)."""
