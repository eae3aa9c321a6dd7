"""The granite-4.0-h-small cell cut to a size a CPU test can run: the
same mix and solver settings, a reduced hybrid (one period of 10 layers,
hidden 64, 4 q / 2 kv heads of 16, 4 SSM heads of 16 with state 16 and
chunk 8, 4 experts of width 32 with top 2 and a shared MLP of 64, vocab
256; the published multipliers), a batch of 4, prompts of 8…20 tokens
and a prefill in slices of at most 32 tokens (4, 2, 2 and 1 rows)."""
import dataclasses

from harness import cell as cells
from small_lm import TRAFFIC

NAME = "granite-4.0-h-small.offline"
SIZES = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=32, shared_intermediate_size=64,
             num_local_experts=4, num_experts_per_tok=2, vocab_size=256,
             mamba_n_heads=4, mamba_d_head=16, mamba_d_state=16,
             mamba_chunk_size=8, attention_multiplier=1 / 16)
PORT = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
            vocab_size=256, n_experts=4, n_shared_experts=2,
            experts_per_token=2, d_expert=32, ssm_heads=4, ssm_head_dim=16,
            ssm_state=16, ssm_chunk=8, attention_multiplier=1 / 16)


def small_config(conf: dict) -> dict:
    """`conf` at the reduced sizes, still dropless at top 2 and at the
    fault control's top 1 (capacity factor = experts / (top 2 − 1)), as
    the engine's sliced prefill requires."""
    out = dict(conf, **SIZES)
    out["port"] = dict(conf["port"], **PORT)
    out["solver"] = dict(conf["solver"], capacity_factor=4.0,
                         moe_group_size=64, prefill_tokens=32)
    return out


def small_hybrid(**solver):
    """The cell at the reduced sizes; `solver` overrides its settings."""
    c = cells.load(NAME)
    conf = small_config(c.config)
    conf["solver"].update(solver)
    return dataclasses.replace(c, config=conf,
                               traffic=dict(c.traffic, **TRAFFIC))
