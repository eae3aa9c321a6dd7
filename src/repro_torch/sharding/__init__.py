"""Sharding rules of the port (counterpart of `repro.sharding`): the MSC
mesh roles only; the LM specs are ROADMAP.md queue 1 item 9 (rest)."""
