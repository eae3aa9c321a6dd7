"""Sharding rules of the port (counterpart of `repro.sharding`): the MSC
mesh roles and the LM parameter, batch and cache specs (`specs`), and the
sharded LM activations (`activation`).  The reference's `shardings_for`
(specs → `NamedSharding`s) has no counterpart: a rank holds its shards
and nothing names a placement."""
from .specs import (
    ShardingRules,
    DEFAULT_RULES,
    MSC_RULES,
    MSC_TABLE,
    msc_axes,
    spec_for_def,
    param_specs,
    batch_spec,
)
