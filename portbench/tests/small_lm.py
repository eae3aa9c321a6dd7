"""The LM cell cut to a size a CPU test can run: the same mix and solver
settings, a reduced granite-moe (2 layers, hidden 64, 4 q / 2 kv heads
of 16, 4 experts of width 32 with top 2, vocab 256; the published
multipliers), a batch of 4 and prompts of 8…20 tokens."""
import dataclasses

from harness import cell as cells

NAME = "granite-moe-1b-a400m.offline"
SIZES = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=32,
             num_local_experts=4, num_experts_per_tok=2, vocab_size=256)
PORT = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=32, vocab_size=256, n_experts=4, experts_per_token=2,
            d_expert=32)
TRAFFIC = dict(batch=4, prompt_lengths=[8, 12, 16, 20], new_tokens=6,
               max_len=26, judge_per_call=2)


def small_config(conf: dict) -> dict:
    """`conf` at the reduced sizes, still dropless (capacity factor =
    experts / experts per token)."""
    out = dict(conf, **SIZES)
    out["port"] = dict(conf["port"], **PORT)
    out["solver"] = dict(conf["solver"], capacity_factor=2.0)
    return out


def small_lm(**solver):
    """The LM cell at the reduced sizes; `solver` overrides its settings."""
    c = cells.load(NAME)
    conf = small_config(c.config)
    conf["solver"].update(solver)
    return dataclasses.replace(c, config=conf,
                               traffic=dict(c.traffic, **TRAFFIC))
