"""Sharding rules of the port (counterpart of `repro.sharding`): the MSC
mesh roles and the LM parameter, batch and cache specs (`specs`), and the
sharded LM activations (`activation`)."""
